"""Process-global state that one port test module could leave behind for
the next one its process runs (``pytest-xdist --dist loadfile`` runs many
files in one worker): the port's shared tensors (``device.constant``'s
and ``resize_bilinear``'s weight matrices, made once and never written),
torch's global switches, JAX's config, and ``chip_smoke.py``'s
deterministic scope, which phase 17 enters and must leave as it found."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from dynslam_tpu_torch import device
from dynslam_tpu_torch.config import (
    DynSlamConfig, Intrinsics, MapParams, SceneParams, StereoCalibration,
    StereoMatcherParams, VisualOdometryParams, VoxelDecayParams,
)
from dynslam_tpu_torch.entry import entry
from dynslam_tpu_torch.io.synthetic import (
    SyntheticScene, render_stereo_frame, straight_trajectory,
)
from dynslam_tpu_torch.models import dispnet, layers, segnet
from dynslam_tpu_torch.ops import integrate
from dynslam_tpu_torch.pipeline.builder import build_fused_static
from torch_threads import threads

torch_threads = threads(2)

W, H, N_FRAMES = 128, 64, 3
INTR = Intrinsics(110.0, 110.0, W / 2.0, H / 2.0)
CALIB = StereoCalibration(0.5, 110.0)
CFG = DynSlamConfig(
    frame_width=W, frame_height=H, intrinsics=INTR, calibration=CALIB,
    dynamic_mode=False,
    scene=SceneParams(voxel_size_m=0.08, mu_m=0.32),
    map=MapParams(pool_capacity=8192, local_dims=(64, 32, 64),
                  max_new_blocks_per_frame=2048),
    vo=VisualOdometryParams(max_candidates=512, max_matches=256,
                            ransac_iters=30, max_disparity=48),
    stereo=StereoMatcherParams(max_disparity=48),
    decay=VoxelDecayParams(enabled=True, min_decay_age=2,
                           max_decay_weight=1),
)


def _drive_port_paths() -> None:
    """The paths that take shared tensors: a fused static slice (stereo,
    features, egomotion, fusion, raycast, decay), ``entry()``'s mapping
    step, and both models' training steps (their resizes)."""
    poses = straight_trajectory(N_FRAMES, speed=0.4, yaw_rate=0.004)
    scene = SyntheticScene.default_scene(seed=3)
    pipe = build_fused_static(CFG, CALIB, device="cpu", seed=0)
    for i in range(N_FRAMES):
        fr = render_stereo_frame(scene, poses[i], INTR, CALIB, W, H, frame=i)
        pipe.process_frame(*(np.clip(fr[k] * 255, 0, 255).astype(np.float32)
                             for k in ("left_gray", "right_gray")))
    assert np.isfinite(pipe.get_pose()).all()
    fn, args = entry("cpu")
    fn(*args)
    gen = torch.Generator().manual_seed(0)
    rgb = torch.rand(2, 3, 37, 50, generator=gen) * 255
    seg = segnet.init_params(segnet.create_model(), gen)
    segnet.make_train_step(seg, torch.optim.Adam(seg.parameters()))(
        dict(rgb=rgb, mask=rgb[:, 0] > 128))
    disp = dispnet.init_params(dispnet.DispNetLite(max_disparity=16.0), gen)
    dispnet.make_train_step(disp, torch.optim.Adam(disp.parameters()))(
        dict(left=rgb, right=rgb.flip(-1), disparity=rgb[:, 0] / 16,
             valid=rgb[:, 1] > 64))


def test_shared_tensors_are_never_written():
    """After the port's paths ran (in this process, and whatever ran
    before in it), every shared tensor is as it was made: no in-place
    write (``Tensor._version`` 0) and its values."""
    _drive_port_paths()
    assert device.CONSTANTS and layers.WEIGHTS
    for (values, dtype, dev), t in device.CONSTANTS.items():
        assert t._version == 0 and torch.equal(
            t, torch.tensor(values, dtype=dtype, device=dev)), (values, t)
    for (n_in, n_out, dtype, dev), w in layers.WEIGHTS.items():
        want = torch.tensor(layers._triangle_weights(n_in, n_out),
                            dtype=dtype, device=dev)
        assert w._version == 0 and torch.equal(w, want), (n_in, n_out)
        assert not w.requires_grad
    for name in ("_VOX_IDX", "_VOX_OFFSETS"):
        assert getattr(integrate, name)._version == 0, name


def test_torch_and_jax_globals_at_defaults():
    """What earlier files in this process left in torch's and JAX's global
    switches: the defaults, which no port test module changes (thread
    counts are set and restored per module: ``torch_threads``)."""
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.get_default_dtype() == torch.float32
    assert not torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    assert not jax.config.jax_enable_x64
    assert not jax.config.jax_debug_nans
    assert jax.config.jax_default_matmul_precision is None


@pytest.mark.parametrize("raises", [False, True])
def test_deterministic_scope_restores_settings(raises):
    """``chip_smoke.deterministic()`` turns the deterministic switches on
    for its block only, and restores them after an error too."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)

    def block():
        with chip_smoke.deterministic():
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
            if raises:
                raise RuntimeError("inside the scope")

    if raises:
        with pytest.raises(RuntimeError):
            block()
    else:
        block()
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before
