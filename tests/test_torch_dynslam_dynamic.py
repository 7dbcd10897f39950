"""The staged dynamic slice end to end: the port's ``DynSlam`` against the
JAX package's (as in ``test_torch_dynslam.py``) at
tests/test_dynamic_pipeline.py's configuration over 6 frames of the
``write_kitti_sequence(with_dynamic=True)`` folder (the moving car's MNC
dumps, detections of 8 px and up), evaluation on at delay 0. Frame by
frame: poses, track states (the car goes Dynamic and gets a pooled
volume), the static map; at the end the object volume, the CSVs
(dynamic bucket and tracker file included) and the composited preview."""

import dataclasses

import numpy as np

from dynslam_tpu.config import EvaluationParams

from test_dynamic_pipeline import dynamic_config
from test_torch_dynslam import check_run, run_both
from torch_threads import threads

torch_threads = threads(2)

N_FRAMES = 6
_base = dynamic_config()
#: max_depth 15 m keeps every render under 16.384 m (the JAX package's
#: packed lookup reads deeper renders back wrong); the object volumes' mu
#: is 0.3 m, not 1 m, as in tests/test_torch_eval_dynamic.py: at 1 m the
#: march's sphere steps cross the thin object or stop on it by the pose,
#: so the car's render moves far more than the packages' float-order pose
#: gaps
CFG = dataclasses.replace(
    _base, max_depth_m=15.0,
    instance_map=dataclasses.replace(_base.instance_map, mu_m=0.3),
    evaluation=EvaluationParams(enabled=True, semantic_evaluation=True))
#: object volumes' block counts agree to this share (the car's motion
#: estimates part by float order, which moves its volume's pose)
VOLUME_BLOCKS_RTOL = 0.05


def test_dynamic_slice_matches_jax(tmp_path_factory):
    res = run_both(tmp_path_factory, CFG, N_FRAMES, dynamic=True,
                   with_instances=True, min_detection_size_px=8)
    check_run(res, N_FRAMES)
    jd, td = res["dyn"]
    states = res["recs"][-1]["tracks"][1]
    assert any(s == "Dynamic" and rec for s, rec, _ in states.values()), \
        states
    jt = jd.instance_reconstructor.tracker.active_tracks
    tt = td.instance_reconstructor.tracker.active_tracks
    assert jt.keys() == tt.keys()
    for k in tt:
        if tt[k].has_reconstruction():
            a = jt[k].reconstruction.get_used_block_count()
            b = tt[k].reconstruction.get_used_block_count()
            assert b > 100 and abs(a - b) <= VOLUME_BLOCKS_RTOL * a, (a, b)
            assert tt[k].fused_frames == jt[k].fused_frames >= 3
    # the cut view has holes where the car was
    det = td.get_latest_seg_result().instance_detections[0]
    mask = det.delete_mask.to_full_frame(td.config.frame_height,
                                         td.config.frame_width)
    view = td.static_scene._view_depth_m.numpy()
    assert (view[mask] == 0).mean() > 0.95
    # the car's pixels are tinted into the composited preview
    a, b = res["previews"]
    static = td.static_scene.get_image()
    assert (b != static).any(-1).sum() >= 50
    assert np.array_equal(td.pose_history[0], np.eye(4))
