"""Mesh extraction and OBJ export — the port of
``dynslam_tpu/viz/meshing.py`` (the reference's ``ITMMeshingEngine`` and
``ITMMesh::WriteOBJ``, used by ``DynSlam::SaveStaticMap``, DynSlam.cpp:189,
and ``InstanceReconstructor::SaveObjectToMesh``, :736).

Marching tetrahedra over the allocated voxel blocks: each cube of eight
neighbouring voxel centres is split into six tetrahedra around its main
diagonal, and each block is stitched with one voxel layer from its +x,
+y and +z neighbours. The JAX package runs it in numpy on a host copy of
the whole pool; here the valid rows are selected on the map's device and
the whole extraction runs in torch there, with the same vertices and
triangles, in the same order:

- the SDF is unpacked by a true float32 division by ``SDF_SCALE`` (a
  tensor divisor: CUDA divides by a scalar as a multiplication by its
  reciprocal, which parts from numpy's quotient by an ulp);
- the neighbour lookup is a stable sort and ``searchsorted`` over packed
  int64 block coordinates in place of a dict;
- the vertex weld is ``np.unique(axis=0, return_index=True,
  return_inverse=True)``'s algorithm: a stable lexicographic sort, the
  first row of each run kept.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynslam_tpu_torch.device import constant
from dynslam_tpu_torch.ops import tsdf as tsdf_ops

#: 6 tetrahedra around the 0-7 main diagonal; cube corner bits (x, y, z)
_TETS = ((0, 1, 3, 7), (0, 1, 5, 7), (0, 4, 5, 7), (0, 4, 6, 7),
         (0, 2, 6, 7), (0, 2, 3, 7))
#: corner id -> (dx, dy, dz)
_CORNERS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))
#: neighbour offset, the 9^3 region it fills, the region of the
#: neighbour's 8^3 block it fills it from
_SPECS = (
    ((1, 0, 0), (slice(8, 9), slice(0, 8), slice(0, 8)),
     (slice(0, 1), slice(0, 8), slice(0, 8))),
    ((0, 1, 0), (slice(0, 8), slice(8, 9), slice(0, 8)),
     (slice(0, 8), slice(0, 1), slice(0, 8))),
    ((0, 0, 1), (slice(0, 8), slice(0, 8), slice(8, 9)),
     (slice(0, 8), slice(0, 8), slice(0, 1))),
    ((1, 1, 0), (slice(8, 9), slice(8, 9), slice(0, 8)),
     (slice(0, 1), slice(0, 1), slice(0, 8))),
    ((1, 0, 1), (slice(8, 9), slice(0, 8), slice(8, 9)),
     (slice(0, 1), slice(0, 8), slice(0, 1))),
    ((0, 1, 1), (slice(0, 8), slice(8, 9), slice(8, 9)),
     (slice(0, 8), slice(0, 1), slice(0, 1))),
    ((1, 1, 1), (slice(8, 9), slice(8, 9), slice(8, 9)),
     (slice(0, 1), slice(0, 1), slice(0, 1))),
)
#: meshed blocks have |coord| < 2**20 (the scratch row lies at 2**24), so
#: a coordinate plus this offset fits in 21 bits
_COORD_LIMIT = 1 << 20


def _keys(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) block coords in (-2**20, 2**20) -> (N,) int64 keys."""
    c = coords.to(torch.int64) + _COORD_LIMIT
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _stitch_neighbors(sdf: torch.Tensor, weight: torch.Tensor,
                      coords: torch.Tensor):
    """(B, 9, 9, 9) sdf and weight with one voxel layer from the +axis
    neighbours; voxels without a neighbour keep weight 0 (not meshed).
    Where two rows hold one block the later row is the neighbour, as the
    JAX package's dict keeps it."""
    B = coords.shape[0]
    dev = sdf.device
    sorted_keys, order = torch.sort(_keys(coords), stable=True)
    s9 = torch.ones(B, 9, 9, 9, dtype=torch.float32, device=dev)
    w9 = torch.zeros(B, 9, 9, 9, dtype=torch.float32, device=dev)
    s9[:, :8, :8, :8] = sdf
    w9[:, :8, :8, :8] = weight
    every = (slice(None),)
    for off, dst, src in _SPECS:
        nbc = coords + constant(off, coords.dtype, dev)
        inside = (nbc < _COORD_LIMIT).all(1)
        key = _keys(torch.where(inside[:, None], nbc, coords))
        pos = torch.searchsorted(sorted_keys, key, right=True) - 1
        pos_c = pos.clamp(min=0)
        has = (inside & (pos >= 0) & (sorted_keys[pos_c] == key))[
            :, None, None, None]
        nb = order[pos_c]
        s9[every + dst] = torch.where(has, sdf[nb][every + src],
                                      s9[every + dst])
        w9[every + dst] = torch.where(has, weight[nb][every + src],
                                      w9[every + dst])
    return s9, w9


def _interp(tv, tp, a: int, b: int) -> torch.Tensor:
    """The zero crossing on the tetrahedron edge a-b."""
    va, vb = tv[:, a], tv[:, b]
    pa, pb = tp[:, a], tp[:, b]
    diff = va - vb
    t = va / torch.where(diff.abs() < 1e-9, 1e-9, diff)
    t = torch.clamp(t, 0.0, 1.0)[:, None]
    return pa + t * (pb - pa)


def _weld(verts: torch.Tensor):
    """Vertices welded on a 1/16-voxel lattice: (first row of each key,
    row -> welded index), in ``np.unique(axis=0)``'s order (keys
    ascending lexicographically)."""
    keys = torch.round(verts * 16.0).to(torch.int64)
    n = keys.shape[0]
    order = torch.arange(n, device=keys.device)
    for col in (2, 1, 0):
        order = order[torch.sort(keys[order, col], stable=True).indices]
    sk = keys[order]
    first = torch.ones(n, dtype=torch.bool, device=keys.device)
    first[1:] = (sk[1:] != sk[:-1]).any(1)
    inv = torch.empty(n, dtype=torch.int64, device=keys.device)
    inv[order] = torch.cumsum(first.to(torch.int64), 0) - 1
    return order[first], inv


def _empty(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(0, 3, dtype=torch.float32, device=dev),
            torch.zeros(0, 3, dtype=torch.int32, device=dev))


def extract_mesh(state: tsdf_ops.TsdfState, voxel_size: float,
                 min_weight: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marching tetrahedra over the allocated blocks of ``state``, on its
    device. Returns (vertices (V, 3) float32 in metres, triangles (T, 3)
    int32)."""
    dev = state.device
    valid = state.valid & (state.block_coords.abs() < _COORD_LIMIT).all(1)
    rows = torch.nonzero(valid)[:, 0]
    if rows.numel() == 0:
        return _empty(dev)
    packed = state.tsdf_w[rows]
    coords = state.block_coords[rows].to(torch.int64)
    B = coords.shape[0]
    sdf = torch.div((packed >> 16).to(torch.float32),
                    constant((tsdf_ops.SDF_SCALE,), torch.float32, dev))
    weight = (packed & 0xFFFF).to(torch.float32) / tsdf_ops.WEIGHT_SCALE
    s9, w9 = _stitch_neighbors(sdf.view(B, 8, 8, 8),
                               weight.view(B, 8, 8, 8), coords)

    # the eight corners of each cube: (B, 8, 8, 8, 8 corners)
    cs = torch.stack([s9[:, x:x + 8, y:y + 8, z:z + 8]
                      for x, y, z in _CORNERS], -1)
    cw = torch.stack([w9[:, x:x + 8, y:y + 8, z:z + 8]
                      for x, y, z in _CORNERS], -1)
    # an exact-zero sample (the surface through a voxel centre) is inside
    cs = torch.where(cs == 0.0, -1e-6, cs)
    active = (cw > min_weight).all(-1) & (cs < 0).any(-1) & (cs > 0).any(-1)
    b_idx, xi, yi, zi = torch.nonzero(active, as_tuple=True)
    if b_idx.numel() == 0:
        return _empty(dev)
    vals = cs[b_idx, xi, yi, zi]  # (M, 8)
    base = (coords[b_idx].to(torch.float32) * 8.0
            + torch.stack([xi, yi, zi], -1).to(torch.float32) + 0.5)
    corner_pos = base[:, None, :] + constant(_CORNERS, torch.float32,
                                             dev)[None]  # (M, 8, 3)

    tris = []
    for tet in _TETS:
        idx = constant(tet, torch.int64, dev)
        tv, tp = vals[:, idx], corner_pos[:, idx]
        inside = tv < 0.0
        n_in = inside.sum(-1)
        sel = (n_in > 0) & (n_in < 4)
        tv, tp, inside, n_in = tv[sel], tp[sel], inside[sel], n_in[sel]
        # a stable permutation: the inside vertices first
        order = torch.argsort((~inside).to(torch.uint8), dim=1, stable=True)
        tv = torch.gather(tv, 1, order)
        tp = torch.gather(tp, 1, order[..., None].expand(-1, -1, 3))
        # one inside: edges 0-1, 0-2, 0-3
        m1 = n_in == 1
        tris.append(torch.stack([_interp(tv, tp, 0, 1)[m1],
                                 _interp(tv, tp, 0, 2)[m1],
                                 _interp(tv, tp, 0, 3)[m1]], 1))
        # three inside: edges 0-3, 2-3, 1-3
        m3 = n_in == 3
        tris.append(torch.stack([_interp(tv, tp, 0, 3)[m3],
                                 _interp(tv, tp, 2, 3)[m3],
                                 _interp(tv, tp, 1, 3)[m3]], 1))
        # two inside: the quad e02, e03, e13, e12 as two triangles
        m2 = n_in == 2
        e02, e03 = _interp(tv, tp, 0, 2)[m2], _interp(tv, tp, 0, 3)[m2]
        e13, e12 = _interp(tv, tp, 1, 3)[m2], _interp(tv, tp, 1, 2)[m2]
        tris.append(torch.stack([e02, e03, e13], 1))
        tris.append(torch.stack([e02, e13, e12], 1))
    verts = torch.cat(tris).reshape(-1, 3)  # voxel units
    if verts.shape[0] == 0:
        return _empty(dev)
    first, inv = _weld(verts)
    vertices = verts[first] * voxel_size
    triangles = inv.view(-1, 3).to(torch.int32)
    ok = (triangles[:, 0] != triangles[:, 1]) \
        & (triangles[:, 1] != triangles[:, 2]) \
        & (triangles[:, 0] != triangles[:, 2])
    return vertices, triangles[ok]


def write_obj(path: str, vertices, triangles) -> None:
    """A minimal OBJ (``ITMMesh::WriteOBJ``): vertices with 5 decimals,
    1-based faces. Tensors or arrays."""
    v = torch.as_tensor(vertices).cpu().numpy()
    t = torch.as_tensor(triangles).cpu().numpy()
    with open(path, "w") as f:
        f.write(f"# dynslam_tpu_torch mesh: {len(v)} verts, "
                f"{len(t)} tris\n")
        f.writelines(f"v {x:.5f} {y:.5f} {z:.5f}\n" for x, y, z in v.tolist())
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n"
                     for a, b, c in t.tolist())


def save_engine_mesh(engine, path: str, min_weight: float = 0.5) -> int:
    """Extract and write an engine's volume (anything with ``state`` and
    ``cfg``: ``MapEngine``, a pooled volume, a fused slot); returns the
    triangle count."""
    verts, tris = extract_mesh(engine.state, engine.cfg.voxel_size,
                               min_weight)
    write_obj(path, verts, tris)
    return int(tris.shape[0])
