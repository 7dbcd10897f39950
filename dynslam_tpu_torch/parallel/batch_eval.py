"""Batch evaluation of the SLAM mapping core over independent sequences:
the counterpart of ``dynslam_tpu/parallel/batch_eval.py``.

Each sequence runs its own map: allocate -> visible blocks -> fusion ->
the dense tracer's render (``ops/tsdf.py::raycast``, the JAX package's
render here) -> the depth-consistency metric, with the input depth
standing in for LIDAR. Where JAX ``vmap``s the one-sequence step, the S
maps here are the volume axis of one stacked pool: allocation,
visibility and the render run sequence by sequence on ``pool_slot``
views, and one ``integrate_many`` launch a frame fuses all S maps (the
dynamic step adds one over the S instance volumes). The tracer is looped
over the sequences (launch-bound: ~2k launches a render).

Frames are time-major: ``rgb`` (T, S, H, W, 3) uint8, ``depth`` (T, S, H,
W) f32, ``cam_to_world`` and ``world_to_cam`` (T, S, 4, 4), for the
dynamic step also ``obj_mask`` (T, S, H, W) bool. With a mesh,
``shard_frames`` gives each rank its sequences along "data" (ranks that
differ only along "model" repeat the same work, as JAX replicates it),
and the metrics are all-gathered, so every rank returns all of them:
(T, S, 2) = (mean |error|, hit fraction) and, dynamic, (T, S, 3) =
(unified error, dynamic-bucket error, composited coverage).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from dynslam_tpu_torch.device import constant
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.ops.integrate import integrate, integrate_many
from dynslam_tpu_torch.parallel.sharding import mesh_device


def stacked_states(cfg: tsdf.TsdfConfig, n_sequences: int,
                   device) -> tsdf.TsdfState:
    """``n_sequences`` fresh maps stacked on a leading axis."""
    return tsdf.create_pool(cfg, n_sequences, device)


def _intr(cfg: tsdf.TsdfConfig, device) -> torch.Tensor:
    return constant((cfg.fx, cfg.fy, cfg.cx, cfg.cy), torch.float32, device)


def _prepare(cfg, state, depth_m, cam_to_world, world_to_cam, frame_idx):
    """Allocate a view's blocks and list the visible ones (in place).
    Returns (grid, origin, slots, mask)."""
    origin = tsdf.compute_origin(cfg, cam_to_world)
    grid = tsdf.build_local_grid(cfg, state, origin)
    state, grid, _ = tsdf.allocate(cfg, state, grid, origin, depth_m,
                                   cam_to_world, frame_idx)
    slots, mask = tsdf.visible_blocks(cfg, state, grid, origin, world_to_cam)
    return grid, origin, slots, mask


def _render(cfg, state, grid, origin, cam_to_world):
    return tsdf.raycast(cfg, state, grid, origin, cam_to_world,
                        _intr(cfg, state.device))


def _mean_err(depth, depth_m, ok):
    err = torch.where(ok, (depth - depth_m).abs(), 0.0).sum()
    return err / torch.clamp(ok.sum(), min=1)


def _metrics(rc, depth_m):
    ok = rc.hit & (depth_m > 0)
    return torch.stack([_mean_err(rc.depth, depth_m, ok),
                        rc.hit.to(torch.float32).mean()])


def _split_views(rgb, depth_m, obj_mask):
    """The silhouette cut: (rgb_cut, depth_cut, depth_obj)."""
    depth_cut = torch.where(obj_mask, 0.0, depth_m)
    rgb_cut = torch.where(obj_mask[..., None], 0, rgb).to(torch.uint8)
    depth_obj = torch.where(obj_mask, depth_m, 0.0)
    return rgb_cut, depth_cut, depth_obj


def _dynamic_metrics(rc, irc, depth_m, obj_mask):
    """The composited (z-merged) render's metrics
    (CompositeInstanceDepthMaps semantics)."""
    comp = torch.where((irc.depth > 0) & ((rc.depth <= 0)
                                          | (irc.depth < rc.depth)),
                       irc.depth, rc.depth)
    ok = (comp > 0) & (depth_m > 0)
    return torch.stack([_mean_err(comp, depth_m, ok),
                        _mean_err(comp, depth_m, obj_mask & ok),
                        (comp > 0).to(torch.float32).mean()])


def _fusion_eval_step(cfg: tsdf.TsdfConfig, state: tsdf.TsdfState, rgb,
                      depth_m, cam_to_world, world_to_cam, frame_idx: int):
    """One mapping step and its depth-consistency metrics for ONE
    sequence (in place). Returns (state, (mean |error|, hit fraction))."""
    grid, origin, slots, mask = _prepare(cfg, state, depth_m, cam_to_world,
                                         world_to_cam, frame_idx)
    integrate(cfg, state, slots, mask, rgb, depth_m, world_to_cam, frame_idx)
    m = _metrics(_render(cfg, state, grid, origin, cam_to_world), depth_m)
    return state, (m[0], m[1])


def _dynamic_fusion_eval_step(cfg: tsdf.TsdfConfig, icfg: tsdf.TsdfConfig,
                              state: tsdf.TsdfState, inst: tsdf.TsdfState,
                              rgb, depth_m, obj_mask, cam_to_world,
                              world_to_cam, frame_idx: int):
    """One DYNAMIC mapping step for ONE sequence: the silhouette cut,
    static fusion of the cut view, fusion of the masked view into the
    sequence's instance volume (a static object: the camera's chain) and
    the composited render the metrics score. Returns ((state, inst),
    (unified error, dynamic-bucket error, coverage))."""
    rgb_cut, depth_cut, depth_obj = _split_views(rgb, depth_m, obj_mask)
    g, o, sl, mk = _prepare(cfg, state, depth_cut, cam_to_world,
                            world_to_cam, frame_idx)
    integrate(cfg, state, sl, mk, rgb_cut, depth_cut, world_to_cam,
              frame_idx)
    rc = _render(cfg, state, g, o, cam_to_world)
    ig, io, isl, imk = _prepare(icfg, inst, depth_obj, cam_to_world,
                                world_to_cam, frame_idx)
    integrate(icfg, inst, isl, imk, rgb, depth_obj, world_to_cam, frame_idx)
    irc = _render(icfg, inst, ig, io, cam_to_world)
    m = _dynamic_metrics(rc, irc, depth_m, obj_mask)
    return (state, inst), (m[0], m[1], m[2])


def _fuse_all(cfg, pool, views, rgb, depth, w2c, t):
    """Allocate and list each sequence's view, then fuse all of them in
    one ``integrate_many`` launch. Returns each view's (grid, origin)."""
    s_n = depth.shape[0]
    prep = [_prepare(cfg, tsdf.pool_slot(pool, s), depth[s], views[s],
                     w2c[s], t) for s in range(s_n)]
    intr = _intr(cfg, pool.device)[None].expand(s_n, 4)
    integrate_many(cfg, pool, list(range(s_n)),
                   torch.stack([p[2] for p in prep]),
                   torch.stack([p[3] for p in prep]), rgb, depth, w2c,
                   [t] * s_n, intr)
    return [(p[0], p[1]) for p in prep]


def _gather_sequences(mesh, metrics: torch.Tensor) -> torch.Tensor:
    """(T, S_local, k) metrics -> (T, S, k) on every rank."""
    if mesh is None or mesh.size(0) == 1:
        return metrics
    group = mesh.get_group("data")
    parts = [torch.empty_like(metrics) for _ in range(mesh.size(0))]
    dist.all_gather(parts, metrics.contiguous(), group=group)
    return torch.cat(parts, 1)


def make_batch_eval(cfg: tsdf.TsdfConfig, mesh=None):
    """``run(states, frames) -> (states, metrics (T, S, 2))`` over this
    rank's sequences: ``states`` from ``stacked_states`` (updated in
    place), ``frames`` from ``shard_frames`` (or all of them without a
    mesh)."""

    def run(states: tsdf.TsdfState, frames: Dict[str, torch.Tensor]):
        n_t, n_s = frames["depth"].shape[:2]
        out = torch.empty(n_t, n_s, 2, device=states.device)
        for t in range(n_t):
            c2w = frames["cam_to_world"][t]
            views = _fuse_all(cfg, states, c2w, frames["rgb"][t],
                              frames["depth"][t], frames["world_to_cam"][t],
                              t)
            for s, (grid, origin) in enumerate(views):
                rc = _render(cfg, tsdf.pool_slot(states, s), grid, origin,
                             c2w[s])
                out[t, s] = _metrics(rc, frames["depth"][t, s])
        return states, _gather_sequences(mesh, out)

    return run


def make_dynamic_batch_eval(cfg: tsdf.TsdfConfig, icfg: tsdf.TsdfConfig,
                            mesh=None):
    """``run((states, insts), frames) -> ((states, insts), metrics (T, S,
    3))``: the dynamic step over this rank's sequences, two
    ``integrate_many`` launches a frame (the cut views into the maps, the
    masked views into the instance volumes)."""

    def run(states, frames: Dict[str, torch.Tensor]):
        pool, insts = states
        n_t, n_s = frames["depth"].shape[:2]
        out = torch.empty(n_t, n_s, 3, device=pool.device)
        for t in range(n_t):
            c2w, w2c = frames["cam_to_world"][t], frames["world_to_cam"][t]
            depth, mask = frames["depth"][t], frames["obj_mask"][t]
            rgb_cut, depth_cut, depth_obj = _split_views(
                frames["rgb"][t], depth, mask)
            views = _fuse_all(cfg, pool, c2w, rgb_cut, depth_cut, w2c, t)
            iviews = _fuse_all(icfg, insts, c2w, frames["rgb"][t], depth_obj,
                               w2c, t)
            for s in range(n_s):
                rc = _render(cfg, tsdf.pool_slot(pool, s), *views[s], c2w[s])
                irc = _render(icfg, tsdf.pool_slot(insts, s), *iviews[s],
                              c2w[s])
                out[t, s] = _dynamic_metrics(rc, irc, depth[s], mask[s])
        return (pool, insts), _gather_sequences(mesh, out)

    return run


def shard_frames(mesh, frames: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's sequences (axis 1) of every frame stack along "data",
    on its device."""
    rank, size = mesh.get_local_rank("data"), mesh.size(0)
    dev = mesh_device(mesh)

    def part(x):
        if x.shape[1] % size:
            raise ValueError(f"shard_frames: {x.shape[1]} sequences do not "
                             f"split over {size} data ranks")
        n = x.shape[1] // size
        return x[:, rank * n:(rank + 1) * n].to(dev)

    return {k: part(v) for k, v in frames.items()}
