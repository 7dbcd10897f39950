"""The benchmark's copy of K1's bound against ``chip_smoke.py``'s
(``k1_pixels``, ``integrate_bound``) on a small map the port built."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def test_k1_bound_equals_chip_smoke(chip_smoke, monkeypatch):
    from benchmark import configio, scene
    from dynslam_tpu_torch.config import DynSlamConfig
    from dynslam_tpu_torch.ops import tsdf
    from dynslam_tpu_torch.pipeline import builder, fused

    conf = {**tiny.CONFIG, "dynamic_mode": False}
    config = configio.build(DynSlamConfig, conf)
    pipe = builder.build_fused_static(config, config.calibration,
                                      device="cpu", seed=3)
    calls = []
    real = fused.integrate

    def probe(cfg, state, slots, mask, rgb, depth, w2c, fidx, *a, **kw):
        calls.append((state.block_coords.clone(), slots.clone(),
                      mask.clone(), w2c.clone(), depth.shape))
        return real(cfg, state, slots, mask, rgb, depth, w2c, fidx, *a, **kw)
    monkeypatch.setattr(fused, "integrate", probe)
    drive = scene.make_drive(dict(tiny.ROAD, cars=[]), 3)
    intr = (config.intrinsics.fx, config.intrinsics.fy,
            config.intrinsics.cx, config.intrinsics.cy)
    gray = scene.render(drive, intr, config.calibration.baseline_m, tiny.W,
                        tiny.H, "cpu")
    for f in range(3):
        pipe.process_frame(gray[f, 0].numpy(), gray[f, 1].numpy())
    assert len(calls) == 2
    cfg = pipe.cfg
    intr_t = torch.tensor(intr, dtype=torch.float32)
    for coords, slots, mask, w2c, (h, w) in calls:
        want_px = chip_smoke.k1_pixels(cfg, coords, slots, mask, w2c,
                                       intr_t, h, w)
        live = coords[slots.long().clamp(0, coords.shape[0] - 1)][mask]
        got_px = roofline.k1_pixels(live, w2c, intr_t, cfg.voxel_size, h, w)
        assert got_px == want_px > 0
        want = chip_smoke.integrate_bound([int(mask.sum())], [want_px],
                                          slots.shape[0])
        got = roofline.integrate_bound_ms(int(mask.sum()), got_px,
                                          slots.shape[0])
        assert got == pytest.approx(want["bound_ms"], rel=1e-12)
    assert tsdf.BLOCK == roofline.BLOCK
    assert chip_smoke.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
    assert chip_smoke.FP32_OPS_PER_S == roofline.FP32_OPS_PER_S
    assert chip_smoke.OPS_PER_VOXEL == roofline.OPS_PER_VOXEL
    np.testing.assert_equal(roofline.bound_ms(3.35e12, 0), 1e3)
