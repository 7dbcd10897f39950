"""The port's headless renderer (``viz/renderer.py``) against the JAX
package's: the camera poses exactly, and the orbit and chase-camera PNGs
of test_torch_mapping's engines (the same views fused at ground-truth
poses) under the settled render rule, the JAX engine's K2 its Pallas
raycast in interpret mode (``jax_kernel_renders``): the colour renders
equal on >= 98% of the pixels (test_torch_mapping's bound for a free-pose
preview; measured 0.9883 there)."""

import cv2
import numpy as np
import pytest

from dynslam_tpu.pipeline.mapping import PreviewType as JPreview
from dynslam_tpu.viz import renderer as jr
from dynslam_tpu_torch.io.images import read_png
from dynslam_tpu_torch.pipeline.mapping import PreviewType
from dynslam_tpu_torch.viz import renderer as tr

from test_torch_mapping import MIN_PREVIEW_EQUAL, _run
from torch_frontend_inputs import RENDER_CAND_K, jax_kernel_renders
from torch_threads import threads

torch_threads = threads(2)

N_ORBIT, CHASE_EVERY = 4, 2


def test_poses_exact():
    rng = np.random.default_rng(3)
    for _ in range(5):
        eye, target = rng.normal(0, 5, 3), rng.normal(0, 5, 3)
        assert np.array_equal(jr.look_at(eye, target), tr.look_at(eye, target))
        c = rng.normal(0, 3, 3)
        for a, b in zip(jr.orbit_poses(c, 8.0, 3.0, 12),
                        tr.orbit_poses(c, 8.0, 3.0, 12)):
            assert np.array_equal(a, b)
        pose = jr.look_at(eye, target)
        assert np.array_equal(jr.chase_cam_pose(pose), tr.chase_cam_pose(pose))


class _Chase:
    """What ``render_chase_sequence`` reads of a pipeline: the pose
    history and the static map's preview at a free pose."""

    def __init__(self, engine, poses_w2c):
        self.engine, self.pose_history = engine, poses_w2c

    def get_static_map_raycast_preview(self, cam_to_world=None,
                                       preview=None):
        return self.engine.get_image(preview, cam_to_world)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    out = tmp_path_factory.mktemp("renders")
    with pytest.MonkeyPatch.context() as mp:
        fill = jax_kernel_renders(mp)
        rec = _run()
        je, te = rec["engines"]
        history = [np.eye(4, dtype=np.float32)] + [
            np.linalg.inv(c2w).astype(np.float32)
            for _, _, c2w in rec["views"][:-1]]
        paths = {}
        for tag, mod, eng, prev in (("jax", jr, je, JPreview.COLOR),
                                    ("port", tr, te, PreviewType.COLOR)):
            paths[tag] = (
                mod.render_orbit(eng, str(out / tag / "orbit"),
                                 n_frames=N_ORBIT, radius=10.0),
                mod.render_chase_sequence(_Chase(eng, history),
                                          str(out / tag / "chase"),
                                          every=CHASE_EVERY, preview=prev))
    assert fill and max(fill) < RENDER_CAND_K
    return paths


def _pairs(renders, k):
    for a, b in zip(renders["jax"][k], renders["port"][k]):
        yield cv2.imread(a)[..., ::-1], read_png(b)


@pytest.mark.parametrize("kind", ["orbit", "chase"])
def test_renders_match_jax(renders, kind):
    k = 0 if kind == "orbit" else 1
    assert [p.rsplit("/", 1)[1] for p in renders["port"][k]] == \
        [p.rsplit("/", 1)[1] for p in renders["jax"][k]]
    n = 0
    for a, b in _pairs(renders, k):
        assert a.shape == b.shape and b.dtype == np.uint8
        assert (a == b).all(-1).mean() >= MIN_PREVIEW_EQUAL
        # every view shows part of the map
        assert (b > 0).any(-1).mean() > 0.05
        n += 1
    assert n == (N_ORBIT if kind == "orbit" else 2)
    if kind == "orbit":
        imgs = [b for _, b in _pairs(renders, 0)]
        assert (imgs[0] != imgs[2]).any()  # the views differ
