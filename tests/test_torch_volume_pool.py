"""The pooled object volumes of the port (CPU, plain versions of the
kernels) against the JAX package's ``InstanceVolumePool`` (its Pallas
raycast in interpret mode: ``jax_kernel_renders``): three volumes fused
from masked full-frame views over three frames in one flush a frame (one
K1 call over the volume axis on the card), with decay; the renders of
``raycast_many`` against the JAX package's and against serial renders;
reap and block counts; and each slot against a ``MapEngine`` fed the same
views."""

import dataclasses

import numpy as np
import pytest
import torch

from dynslam_tpu.config import (
    DynSlamConfig, InstanceMapParams, Intrinsics, VoxelDecayParams,
)
from dynslam_tpu.instances import volume_pool as jvp
from dynslam_tpu_torch.instances import volume_pool as tvp
from dynslam_tpu_torch.ops import integrate as K1
from dynslam_tpu_torch.pipeline import mapping as tm

from test_torch_eval import to_port
from test_torch_mapping import (
    assert_states, check_render, staged_views,
)
from torch_frontend_inputs import RENDER_CAND_K, jax_kernel_renders
from torch_threads import threads

torch_threads = threads(2)

W, H, N, S = 160, 120, 3, 3
INTR = Intrinsics(0.8 * W, 0.8 * W, W / 2.0, H / 2.0)
CFG = DynSlamConfig(
    frame_width=W, frame_height=H, intrinsics=INTR, right_intrinsics=INTR,
    max_depth_m=15.0,
    instance_map=InstanceMapParams(
        voxel_size_m=0.08, mu_m=0.3, blocks_per_object=2048,
        local_dims=(48, 24, 64), max_new_blocks_per_frame=1024,
        raycast_fine_steps=40, max_objects=4),
    decay=VoxelDecayParams(enabled=True, min_decay_age=1, max_decay_weight=1),
)


def object_views(frame):
    """Three 'objects' of a frame: its view masked to three column strips,
    each volume at its own pose (the camera's, shifted a little)."""
    rgb, mm, c2w = frame
    d = mm.astype(np.float32) / 1000.0
    out = []
    for s in range(S):
        m = np.zeros((H, W), bool)
        m[:, s * W // S:(s + 1) * W // S] = True
        w2c = np.linalg.inv(c2w).astype(np.float32)
        w2c[:3, 3] += np.float32(0.1 * s)
        out.append((np.where(m[..., None], rgb, 0).astype(np.uint8),
                    np.where(m, d, 0.0).astype(np.float32), w2c))
    return out


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        out = _run()
    assert fill and max(fill) < RENDER_CAND_K
    return out


def _run():
    import jax.numpy as jnp

    from dynslam_tpu.instances.reconstructor import InstanceReconstructor

    jcfg = InstanceReconstructor(CFG)._instance_cfg
    jp = jvp.InstanceVolumePool(jcfg, CFG.decay, capacity=4)
    jp._use_pallas_raycast = True
    tcfg = tm.instance_config_from(to_port(CFG))
    tp = tvp.InstanceVolumePool(tcfg, to_port(CFG.decay), 4, device="cpu")
    jh = [jp.acquire_volume() for _ in range(S)]
    th = [tp.acquire_volume() for _ in range(S)]
    assert [h.slot for h in jh] == [h.slot for h in th]
    frames = staged_views(CFG, N)
    calls = []
    fn = tvp.integrate_many

    def counting(cfg, pool, vols, *args):
        calls.append(list(vols))
        return fn(cfg, pool, vols, *args)

    tvp.integrate_many = counting
    try:
        for frame in frames:
            for views, handles in ((object_views(frame), jh),
                                   (object_views(frame), th)):
                for h, (rgb, d, w2c) in zip(handles, views):
                    if isinstance(h, tvp.PooledVolume):
                        rgb, d = torch.from_numpy(rgb), torch.from_numpy(d)
                    else:
                        rgb, d = jnp.asarray(rgb), jnp.asarray(d)
                    h.set_view_device(rgb, d)
                    h.set_pose(w2c)
                    h.integrate()
            jp.flush()
            tp.flush()
    finally:
        tvp.integrate_many = fn
    c2ws = [np.linalg.inv(v[2]) for v in object_views(frames[-1])]
    slots = [h.slot for h in jh]
    return dict(jp=jp, tp=tp, jh=jh, th=th, calls=calls, c2ws=c2ws,
                slots=slots, frames=frames,
                jr=jp.raycast_many(slots, c2ws),
                jused=[h.get_used_block_count() for h in jh], tcfg=tcfg)


def test_flush_states_match_jax(run):
    """One K1 call a frame over exactly the staged volumes; every slot's
    map as the JAX package's."""
    assert run["calls"] == [run["slots"]] * N
    jp, tp = run["jp"], run["tp"]
    assert list(tp.frame_idx) == list(jp.frame_idx)
    for s in run["slots"]:
        assert_states(jp._slice(s), tp.slot_state(s))
    assert [h.get_used_block_count() for h in run["th"]] == run["jused"]
    assert min(run["jused"]) > 50
    assert int(tp.states.decayed_blocks.sum()) > 0


def test_raycast_many(run):
    tp = run["tp"]
    tr = tp.raycast_many(run["slots"], run["c2ws"])
    for i, s in enumerate(run["slots"]):
        one = tp.raycast(s, run["c2ws"][i])
        for a, b in zip(tr, one):
            assert torch.equal(a[i], b)
        jr = type(run["jr"])(*(x[i] for x in run["jr"]))
        check_render(jr, type(tr)(*(x[i] for x in tr)), f"slot {s}",
                     min_hits=0.05)


def test_reap_and_release(run):
    tp, th = run["tp"], run["th"]
    assert th[0].reap(3.0) == run["jh"][0].reap(3.0) > 0
    th[1].reset()
    assert th[1].get_used_block_count() == 0 and tp.frame_idx[th[1].slot] == 0
    th[2].release()
    assert th[2].slot in tp._free


def test_slots_equal_map_engines():
    """Each slot of a flush over three volumes equals a ``MapEngine`` of
    the object configuration fed the same view at the same pose (decay off:
    the engine decays after its frame counter advances, the pool before)."""
    cfg = to_port(dataclasses.replace(
        CFG, decay=VoxelDecayParams(enabled=False)))
    icfg = tm.instance_config_from(cfg)
    pool = tvp.InstanceVolumePool(icfg, cfg.decay, 4, device="cpu")
    handles = [pool.acquire_volume() for _ in range(S)]
    engines = [tm.MapEngine(icfg, cfg.decay, device="cpu") for _ in range(S)]
    before = K1.integrate.launches
    for frame in staged_views(CFG, 2):
        for h, e, (rgb, d, w2c) in zip(handles, engines,
                                       object_views(frame)):
            rgb, d = torch.from_numpy(rgb), torch.from_numpy(d)
            h.set_view_device(rgb, d)
            h.set_pose(w2c)
            h.integrate()
            e.set_view_device(rgb, d)
            e.set_pose(w2c)
            e.integrate()
        pool.flush()
    assert K1.integrate.launches == before  # the plain version on the CPU
    for h, e in zip(handles, engines):
        st = pool.slot_state(h.slot)
        for k in ("valid", "block_coords", "alloc_frame", "last_seen"):
            assert torch.equal(getattr(st, k), getattr(e.state, k)), k
        assert (st.tsdf_w == e.state.tsdf_w).double().mean() >= 0.999
        assert h.get_used_block_count() == e.get_used_block_count() > 50
