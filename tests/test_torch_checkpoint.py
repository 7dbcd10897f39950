"""Checkpoints of the port (``pipeline/checkpoint.py``): a split staged run
against the continuous one, by tests/test_checkpoint.py's criteria;
checkpoints the JAX package saved (staged, fused static, fused dynamic)
resuming in the port; and the port's staged checkpoint loading in the JAX
package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynslam_tpu.io.synthetic import write_kitti_sequence
from dynslam_tpu.pipeline import builder as jb
from dynslam_tpu.pipeline import checkpoint as jck
from dynslam_tpu.pipeline.fused import FusedPipeline as JaxFused
from dynslam_tpu.pipeline.fused_dynamic import FusedDynamicPipeline as JaxDyn
from dynslam_tpu.pipeline.mapping import engine_config_from as jax_ecf
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.pipeline import builder as tb
from dynslam_tpu_torch.pipeline import checkpoint as tck

from test_pipeline import small_config
from test_torch_eval import to_port
from test_torch_fused import CALIB, CFG as FUSED_CFG, _jax_sampler
from torch_frontend_inputs import (
    dynamic_slice_config, make_dynamic_frames, make_frames,
)
from torch_threads import threads

torch_threads = threads(2)

N = 5


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckseq"))
    write_kitti_sequence(root, num_frames=N, width=160, height=120)
    return root


def port_run(root, frames=None, resume=None):
    dyn, inp = tb.build_dynslam(root, to_port(small_config()),
                                with_instances=False, device="cpu")
    if resume is not None:
        inp.frame_idx = tck.load_checkpoint(resume, dyn)
    n = 0
    while (frames is None or n < frames) and dyn.process_frame(inp):
        n += 1
    return dyn


def test_split_run_matches_continuous(seq, tmp_path):
    cont = port_run(seq)
    ck = str(tmp_path / "ck.npz")
    tck.save_checkpoint(ck, port_run(seq, frames=2))
    split = port_run(seq, resume=ck)
    assert split.current_frame_no == cont.current_frame_no == N
    used_a = cont.static_scene.get_used_block_count()
    used_b = split.static_scene.get_used_block_count()
    assert abs(used_a - used_b) / used_a < 0.15
    assert len(split.pose_history) == len(cont.pose_history)
    np.testing.assert_allclose(split.pose_history[1], cont.pose_history[1],
                               atol=1e-6)


def test_jax_staged_checkpoint_resumes_in_port(seq, tmp_path):
    jd, ji = jb.build_dynslam(seq, small_config(), with_instances=False)
    for _ in range(2):
        jd.process_frame(ji)
    ck = str(tmp_path / "jax.npz")
    jck.save_checkpoint(ck, jd)
    td, ti = tb.build_dynslam(seq, to_port(small_config()),
                              with_instances=False, device="cpu")
    assert tck.load_checkpoint(ck, td) == 2
    st = td.static_scene.state
    for k in convert.STATE_KEYS:
        assert np.array_equal(np.asarray(getattr(jd.static_scene.state, k)),
                              getattr(st, k).numpy()), k
    assert np.array_equal(np.stack(td.pose_history),
                          np.stack(jd.pose_history))
    assert td.static_scene.frame_idx == jd.static_scene.frame_idx
    assert np.array_equal(td.static_scene.get_pose(), jd.pose_history[-1])
    ti.frame_idx = 2
    while td.process_frame(ti):
        pass
    cont = port_run(seq)
    assert td.current_frame_no == N
    assert abs(td.static_scene.get_used_block_count()
               - cont.static_scene.get_used_block_count()) \
        / cont.static_scene.get_used_block_count() < 0.15


def test_port_staged_checkpoint_loads_in_jax(seq, tmp_path):
    td = port_run(seq, frames=3)
    ck = str(tmp_path / "port.npz")
    tck.save_checkpoint(ck, td)
    jd, ji = jb.build_dynslam(seq, small_config(), with_instances=False)
    assert jck.load_checkpoint(ck, jd) == 3
    for k in convert.STATE_KEYS:
        assert np.array_equal(np.asarray(getattr(jd.static_scene.state, k)),
                              getattr(td.static_scene.state, k).numpy()), k
    assert jd.static_scene.frame_idx == td.static_scene.frame_idx
    ji.frame_idx = 3
    assert jd.process_frame(ji)  # the JAX pipeline runs on from it


def test_shape_mismatch_rejected(seq, tmp_path):
    ck = str(tmp_path / "c.npz")
    tck.save_checkpoint(ck, port_run(seq, frames=1))
    cfg = small_config()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, pool_capacity=8192))
    dyn, _ = tb.build_dynslam(seq, to_port(cfg), with_instances=False,
                              device="cpu")
    with pytest.raises(ValueError, match="pool shape"):
        tck.load_checkpoint(ck, dyn)


def test_jax_fused_checkpoint_resumes_in_port(tmp_path):
    """A static fused run saved by the JAX package after 2 frames resumes
    in the port: the carry equals JAX's leaf for leaf, and the next frame
    lands where the JAX pipeline's next frame lands."""
    frames = make_frames()[0]
    frames = frames + [frames[1]]
    jp = JaxFused(jax_ecf(FUSED_CFG), FUSED_CFG.stereo, FUSED_CFG.vo,
                  FUSED_CFG.decay, CALIB, use_pallas=False)
    for lg, rg in frames[:2]:
        jp.process_frame(lg, rg)
    ck = str(tmp_path / "fused.npz")
    jck.save_fused_checkpoint(ck, jp)
    leaves = jax.tree_util.tree_leaves(jp.carry)
    tp = tb.build_fused_static(to_port(FUSED_CFG), to_port(CALIB),
                               device="cpu")
    tp.sampler = _jax_sampler(jp.base_key)
    tck.load_fused_checkpoint(ck, tp)
    got = convert.fused_carry_to_numpy(tp.carry)
    assert len(leaves) == len(convert.FUSED_CARRY_KEYS)
    for k, leaf in zip(convert.FUSED_CARRY_KEYS, leaves):
        assert np.array_equal(got[k], np.asarray(leaf)), k
    assert tp._frames == jp._frames == 2
    jp.process_frame(*frames[2])
    tp.process_frame(*frames[2])
    assert np.abs(tp.get_pose() - np.asarray(jp.get_pose())).max() < 5e-3
    assert tp.get_used_block_count() == jp.get_used_block_count()
    # and the port's fused checkpoint round-trips in the JAX format
    ck2 = str(tmp_path / "port_fused.npz")
    tck.save_fused_checkpoint(ck2, tp)
    with np.load(ck2) as data:
        assert int(data["n_leaves"]) == len(convert.FUSED_CARRY_KEYS)


def test_jax_fused_dynamic_checkpoint_loads_in_port(tmp_path):
    """The dynamic carry's leaves (the object pool, the pending crops, the
    host-kept fusion clock and crop origins) by the JAX flattening order."""
    cfg = dynamic_slice_config()
    lg, rg, _, _ = make_dynamic_frames(cfg, n=1)[0]
    jp = JaxDyn(cfg, cfg.calibration, use_pallas=False)
    jp.carry = jp._fresh_carry(jnp.asarray(lg, jnp.float32),
                               jnp.asarray(rg, jnp.float32))
    ck = str(tmp_path / "dyn.npz")
    jck.save_fused_checkpoint(ck, jp)
    tp = tb.build_fused_dynamic(to_port(cfg), to_port(cfg.calibration),
                                device="cpu")
    tck.load_fused_checkpoint(ck, tp)
    got = convert.fused_dyn_carry_to_numpy(tp.carry)
    leaves = jax.tree_util.tree_leaves(jp.carry)
    assert len(leaves) == len(convert.FUSED_DYN_CARRY_KEYS)
    for k, leaf in zip(convert.FUSED_DYN_CARRY_KEYS, leaves):
        assert np.array_equal(got[k], np.asarray(leaf)), k
    assert isinstance(tp.carry.inst_fidx, np.ndarray)
