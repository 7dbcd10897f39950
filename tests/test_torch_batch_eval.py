"""``parallel/batch_eval.py`` on 2 gloo ranks over 4 sequences (2 a rank,
so each ``integrate_many`` launch fuses 2 maps) at
``tests/test_batch_eval.py``'s configuration, against the port's
one-sequence steps and the JAX package's.

Tolerances: against the port's own one-sequence loop every map word and
every metric is equal bit for bit (the volume axis fuses each map as the
one-volume call does). Against JAX's ``_fusion_eval_step`` /
``_dynamic_fusion_eval_step`` loops the block layout is exact and the
packed words are held to ``assert_map_close`` (test_torch_fused.py); the
metrics (mean |error| in m, hit fraction, coverage) to 1e-5 absolute:
the dense tracers agree to an ulp (test_torch_dense_raycast.py), and the
sums over the frame reduce in another order.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as pw
from dynslam_tpu.ops import tsdf as jt
from dynslam_tpu.parallel import batch_eval as jbe
from dynslam_tpu_torch.ops import tsdf as tt
from dynslam_tpu_torch.parallel import batch_eval, launch
from test_torch_fused import assert_map_close
from torch_threads import threads

torch_threads = threads(1)

N_FRAMES, N_SEQ, WORLD = 2, 4, 2
METRIC_ATOL = 1e-5
MAP_KEYS = ("tsdf_w", "color", "valid", "block_coords")


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(pw.batch_eval_ranks, WORLD, "cpu", N_FRAMES, N_SEQ)


@pytest.fixture(scope="module")
def frames():
    return pw.eval_frames(N_FRAMES, N_SEQ)


def _seq_maps(ranks, key, s):
    """Sequence s's map from the rank that holds it."""
    per = N_SEQ // WORLD
    r = ranks[s // per]
    return {k: v[s - r["first"]] for k, v in r[key].items()}


def _np_state(state):
    return {k: np.asarray(getattr(state, k)) for k in MAP_KEYS}


def _port_loop(frames, s, dynamic: bool):
    """The port's one-sequence steps over sequence s (CPU)."""
    cfg, icfg = pw.tiny_cfg(), pw.tiny_instance_cfg()
    st, it = tt.create_state(cfg, "cpu"), tt.create_state(icfg, "cpu")
    out = []
    for t in range(N_FRAMES):
        args = [torch.from_numpy(frames[k][t, s]) for k in (
            "rgb", "depth", "obj_mask", "cam_to_world", "world_to_cam")]
        if dynamic:
            (st, it), m = batch_eval._dynamic_fusion_eval_step(
                cfg, icfg, st, it, *args, t)
        else:
            del args[2]
            st, m = batch_eval._fusion_eval_step(cfg, st, *args, t)
        out.append([float(x) for x in m])
    maps = {k: getattr(st, k).numpy() for k in MAP_KEYS}
    imaps = {k: getattr(it, k).numpy() for k in MAP_KEYS}
    return np.array(out), maps, imaps


@pytest.fixture(scope="module")
def jax_loops(frames):
    """JAX's one-sequence steps over every sequence (jitted once each)."""
    jcfg = dataclasses.replace(jt.TsdfConfig(), **dataclasses.asdict(
        pw.tiny_cfg()))
    jicfg = dataclasses.replace(jt.TsdfConfig(), **dataclasses.asdict(
        pw.tiny_instance_cfg()))
    step = jax.jit(partial(jbe._fusion_eval_step, jcfg))
    dstep = jax.jit(partial(jbe._dynamic_fusion_eval_step, jcfg, jicfg))
    out = []
    for s in range(N_SEQ):
        st, dst, it = (jt.create_state(jcfg), jt.create_state(jcfg),
                       jt.create_state(jicfg))
        m, dm = [], []
        for t in range(N_FRAMES):
            f = {k: jnp.asarray(v[t, s]) for k, v in frames.items()}
            st, (err, hit) = step(st, f["rgb"], f["depth"],
                                  f["cam_to_world"], f["world_to_cam"],
                                  jnp.int32(t))
            (dst, it), (e, de, cov) = dstep(
                dst, it, f["rgb"], f["depth"], f["obj_mask"],
                f["cam_to_world"], f["world_to_cam"], jnp.int32(t))
            m.append([float(err), float(hit)])
            dm.append([float(e), float(de), float(cov)])
        out.append(dict(metrics=np.array(m), dyn_metrics=np.array(dm),
                        static=_np_state(st), dynamic=_np_state(dst),
                        inst=_np_state(it)))
    return out


def test_metrics_gathered_on_every_rank(ranks):
    """(T, S, 2) and (T, S, 3) on both ranks, equal, finite; the JAX
    test's bounds on the last frame (hit fraction > 0.5, mean |error| <
    0.25 m, composited coverage > 0.5)."""
    for r in ranks:
        assert r["metrics"].shape == (N_FRAMES, N_SEQ, 2)
        assert r["dyn_metrics"].shape == (N_FRAMES, N_SEQ, 3)
        np.testing.assert_array_equal(r["metrics"], ranks[0]["metrics"])
        np.testing.assert_array_equal(r["dyn_metrics"],
                                      ranks[0]["dyn_metrics"])
    m, dm = ranks[0]["metrics"], ranks[0]["dyn_metrics"]
    assert np.isfinite(m).all() and np.isfinite(dm).all()
    assert (m[-1, :, 1] > 0.5).all() and (m[-1, :, 0] < 0.25).all()
    assert (dm[-1, :, 2] > 0.5).all()


def test_one_integrate_many_launch_per_frame(ranks):
    """The volume axis: one K1 call a frame over the rank's 2 maps, two
    in the dynamic step (the maps, then the instance volumes)."""
    per = N_SEQ // WORLD
    for r in ranks:
        assert r["static_calls"] == [per] * N_FRAMES
        assert r["dyn_calls"] == [per] * (2 * N_FRAMES)


@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static", "dynamic"])
@pytest.mark.parametrize("s", range(N_SEQ))
def test_equals_one_sequence_loop(ranks, frames, s, dynamic):
    """Each sequence's maps and metrics are the port's one-sequence steps'
    bit for bit."""
    metrics, maps, imaps = _port_loop(frames, s, dynamic)
    key = "dynamic" if dynamic else "static"
    got = _seq_maps(ranks, key, s)
    for k in MAP_KEYS:
        np.testing.assert_array_equal(got[k], maps[k], err_msg=k)
    if dynamic:
        got_i = _seq_maps(ranks, "inst", s)
        for k in MAP_KEYS:
            np.testing.assert_array_equal(got_i[k], imaps[k], err_msg=k)
    m = ranks[0]["dyn_metrics" if dynamic else "metrics"][:, s]
    np.testing.assert_array_equal(m, metrics.astype(np.float32))


@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static", "dynamic"])
def test_against_jax_steps(ranks, jax_loops, dynamic):
    key = "dynamic" if dynamic else "static"
    mkey = "dyn_metrics" if dynamic else "metrics"
    for s, ref in enumerate(jax_loops):
        for which in (key, "inst") if dynamic else (key,):
            got = _seq_maps(ranks, which, s)
            want = ref[which]
            np.testing.assert_array_equal(got["valid"], want["valid"])
            np.testing.assert_array_equal(got["block_coords"],
                                          want["block_coords"])
            used = np.nonzero(want["valid"])[0][:-1]
            assert used.size > (0 if which == "inst" else 10)
            assert_map_close(want["tsdf_w"][used], got["tsdf_w"][used])
        np.testing.assert_allclose(ranks[0][mkey][:, s], ref[mkey],
                                   atol=METRIC_ATOL)
