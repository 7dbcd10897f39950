"""The port's direct photometric alignment (``ops/direct_align.py``) and
its wiring into the staged ``InstanceReconstructor`` against the JAX
package's, on tests/test_direct_align.py's scene (128x96 renders related
by a known motion).

Tolerance: the refined transforms agree within 1e-4 per element (both
are float32 Gauss-Newton; measured <= 7.5e-7 at one level, 1.8e-7 at
two, 3.7e-8 at three), the RMS residuals within 1e-3 and the valid
shares exactly; ``log_se3`` within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynslam_tpu.ops import direct_align as jda
from dynslam_tpu.utils import se3 as jse3
from dynslam_tpu_torch.ops import direct_align as tda
from dynslam_tpu_torch.utils import se3 as tse3

from test_direct_align import INTR, _frames
from torch_threads import threads

torch_threads = threads(2)

MAX_T_GAP, MAX_RMS_GAP = 1e-4, 1e-3
XI_GT = np.array([0.0, 0.01, 0.0, 0.02, 0.0, -0.10])


@pytest.fixture(scope="module")
def frames():
    T_gt = np.asarray(jse3.exp_se3(jnp.asarray(XI_GT)))
    return T_gt, _frames(T_gt)


def _compare(rj, rt):
    assert np.abs(np.asarray(rj.T) - rt.T.numpy()).max() <= MAX_T_GAP
    assert abs(float(rj.residual_rms) - float(rt.residual_rms)) \
        <= MAX_RMS_GAP
    assert float(rj.valid_fraction) == float(rt.valid_fraction)


def test_log_se3_matches_jax():
    rng = np.random.default_rng(1)
    for xi in [np.zeros(6), *rng.normal(0, 0.3, (5, 6))]:
        T = np.asarray(jse3.exp_se3(jnp.asarray(xi, jnp.float32)))
        want = np.asarray(jse3.log_se3(jnp.asarray(T)))
        got = tse3.log_se3(torch.from_numpy(T)).numpy()
        assert np.abs(want - got).max() <= 1e-6, xi


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_refine_pose_matches_jax(frames, levels):
    T_gt, (ref_g, ref_d, tgt_g) = frames
    rj = jda.refine_pose(ref_g, ref_d, tgt_g, INTR.as_tuple(), levels=levels)
    rt = tda.refine_pose(ref_g, ref_d, tgt_g, INTR.as_tuple(), levels=levels,
                         device="cpu")
    _compare(rj, rt)
    assert np.linalg.norm(rt.T.numpy()[:3, 3] - T_gt[:3, 3]) < 0.03


def test_warm_start_matches_jax(frames):
    T_gt, (ref_g, ref_d, tgt_g) = frames
    T0 = T_gt.astype(np.float32).copy()
    T0[0, 3] += 0.05
    rj = jda.refine_pose(ref_g, ref_d, tgt_g, INTR.as_tuple(), T_init=T0)
    rt = tda.refine_pose(ref_g, ref_d, tgt_g, INTR.as_tuple(), T_init=T0,
                         device="cpu")
    _compare(rj, rt)
    assert np.abs(np.asarray(rj.xi) - rt.xi.numpy()).max() <= MAX_T_GAP


def test_direct_refine_motion_matches_jax():
    """tests/test_direct_align.py's wiring scene (a track of two
    full-frame instance views, the second's motion 5 cm off along x)
    through both reconstructors' ``_direct_refine_motion``."""
    from dynslam_tpu.config import Intrinsics, tiny_test_config
    from dynslam_tpu.instances.reconstructor import (
        InstanceReconstructor as JRec,
    )
    from dynslam_tpu.instances.track import Track as JTrack
    from dynslam_tpu.instances.track import TrackFrame as JFrame
    from dynslam_tpu_torch.instances.reconstructor import (
        InstanceReconstructor as TRec,
    )
    from dynslam_tpu_torch.instances.track import Track as TTrack
    from dynslam_tpu_torch.instances.track import TrackFrame as TFrame

    from test_torch_eval import to_port

    W, H = 128, 96
    cfg = tiny_test_config(W, H).replace(
        use_direct_refinement=True,
        intrinsics=Intrinsics(INTR.fx, INTR.fy, INTR.cx, INTR.cy))
    xi_gt = np.array([0.0, 0.005, 0.0, 0.01, 0.0, -0.08])
    T_gt = np.asarray(jse3.exp_se3(jnp.asarray(xi_gt)), np.float32)
    ref_g, ref_d, tgt_g = _frames(T_gt)

    def rgb(g):
        return np.repeat(g[..., None], 3, -1).astype(np.uint8)

    T0 = T_gt.copy()
    T0[0, 3] += 0.05
    out = []
    for Rec, Track, Frame, conf, to in (
            (JRec, JTrack, JFrame, cfg, np.asarray),
            (TRec, TTrack, TFrame, to_port(cfg), torch.from_numpy)):
        rec = Rec(conf) if Rec is JRec else Rec(conf, device="cpu")
        track = Track(0, conf.tracker)
        kw = dict(detection=None, masked_flow=np.zeros((0, 8), np.float32),
                  camera_pose=np.eye(4, dtype=np.float32),
                  instance_depth_m=to(ref_d.astype(np.float32)))
        track.add_frame(Frame(frame_idx=1, instance_rgb=to(rgb(ref_g)), **kw))
        track.add_frame(Frame(frame_idx=2, instance_rgb=to(rgb(tgt_g)),
                              relative_pose=T0.copy(), **kw))
        rec._direct_refine_motion(track, 1)
        assert rec.direct_refinements == 1
        out.append(track.frames[1])
    fj, ft = out
    assert np.abs(fj.relative_pose - ft.relative_pose).max() <= MAX_T_GAP
    assert np.abs(np.asarray(fj.relative_pose_tr, np.float32)
                  - ft.relative_pose_tr).max() <= MAX_T_GAP
    assert ft.relative_pose.dtype == np.float32
    err0 = np.linalg.norm(T0[:3, 3] - T_gt[:3, 3])
    assert np.linalg.norm(ft.relative_pose[:3, 3] - T_gt[:3, 3]) < err0


def test_refinement_needs_a_previous_view():
    """No previous instance view, or no motion estimate: nothing to refine
    and no count."""
    from dynslam_tpu_torch.config import tiny_test_config
    from dynslam_tpu_torch.instances.reconstructor import (
        InstanceReconstructor,
    )
    from dynslam_tpu_torch.instances.track import Track, TrackFrame

    cfg = tiny_test_config().replace(use_direct_refinement=True)
    rec = InstanceReconstructor(cfg, device="cpu")
    track = Track(0, cfg.tracker)
    view = torch.zeros(cfg.frame_height, cfg.frame_width, 3,
                       dtype=torch.uint8)
    kw = dict(detection=None, masked_flow=np.zeros((0, 8), np.float32),
              camera_pose=np.eye(4, dtype=np.float32))
    track.add_frame(TrackFrame(frame_idx=1, **kw))
    track.add_frame(TrackFrame(frame_idx=2, instance_rgb=view,
                               relative_pose=np.eye(4), **kw))
    rec._direct_refine_motion(track, 0)
    rec._direct_refine_motion(track, 1)
    assert rec.direct_refinements == 0
    assert np.array_equal(track.frames[1].relative_pose, np.eye(4))
