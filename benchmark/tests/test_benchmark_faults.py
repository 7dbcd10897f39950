"""The correctness check on tiny cells on the CPU: a sound run is correct,
and each fault the cells can have, planted under the timed path, makes
``correct`` false; so does the control, the reference in bfloat16 put in
the port's place."""

import functools

import pytest
import torch

from benchmark.tests import tiny
from dynslam_tpu_torch.ops import tsdf
from dynslam_tpu_torch.pipeline import fused, fused_dynamic
from dynslam_tpu_torch.pipeline.fused_dynamic import FusedDynamicPipeline


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["tiny-static", "tiny-dynamic"])
def test_sound_run_is_correct(root, name):
    r = tiny.run(root, name)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(tiny.limits(name == "tiny-dynamic"))
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def _wrap(monkeypatch, module, name, after):
    real = getattr(module, name)

    @functools.wraps(real)
    def broken(*args, **kw):
        return after(real, *args, **kw)
    monkeypatch.setattr(module, name, broken)


def _stuck(real, cfg, sp, vp, decay, carry, *args, **kw):
    """A step that leaves the map and the pose as they were."""
    saved = carry.state.clone()
    carry2, outs = real(cfg, sp, vp, decay, carry, *args, **kw)
    tsdf.assign_state(carry.state, saved)
    return (carry2._replace(pose_w2c=carry.pose_w2c),
            outs._replace(pose_w2c=carry.pose_w2c))


def _altered(real, *args, **kw):
    """A step whose depth answer is altered where it is produced."""
    carry2, outs = real(*args, **kw)
    return carry2, outs._replace(depth_m=outs.depth_m + 0.05)


@pytest.mark.parametrize("pipeline", [fused.FusedPipeline,
                                      FusedDynamicPipeline])
def test_stale_handover_is_caught(root, monkeypatch, pipeline):
    """A pipeline that hands the next step the pose it handed this one,
    not the pose the step returned."""
    real = pipeline.process_frame

    def stale(self, *args, **kw):
        pose = None if self.carry is None else self.carry.pose_w2c.clone()
        real(self, *args, **kw)
        if pose is not None:
            self.carry = self.carry._replace(pose_w2c=pose)
    monkeypatch.setattr(pipeline, "process_frame", stale)
    r = tiny.run(root, "tiny-static" if pipeline is fused.FusedPipeline
                 else "tiny-dynamic")
    assert not r["correct"]
    assert r["checks"]["handover_diff"]["value"] > 0


@pytest.mark.parametrize("fault", [_stuck, _altered])
def test_static_fault_is_caught(root, monkeypatch, fault):
    _wrap(monkeypatch, fused, "fused_step", fault)
    assert not tiny.run(root, "tiny-static")["correct"]


def test_half_the_detections_left_out_is_caught(root, monkeypatch):
    real = FusedDynamicPipeline.select_detections

    def half(detections, k):
        return real(detections, k)[::2]
    monkeypatch.setattr(FusedDynamicPipeline, "select_detections",
                        staticmethod(half))
    r = tiny.run(root, "tiny-dynamic")
    assert not r["correct"]
    assert r["checks"]["mask_bits_diff"]["value"] > 0


def test_dynamic_altered_answer_is_caught(root, monkeypatch):
    _wrap(monkeypatch, fused_dynamic, "fused_dynamic_step", _altered)
    assert not tiny.run(root, "tiny-dynamic")["correct"]


@pytest.mark.parametrize("name", ["tiny-static", "tiny-dynamic"])
def test_control_fails(root, name):
    """The bfloat16 control reads past a limit of the cell."""
    r = tiny.run(root, name, control=True)
    lim = tiny.limits(name == "tiny-dynamic")
    assert any(v > lim[k] for k, v in r["control"].items())
    assert r["correct"]


@pytest.mark.chip
@pytest.mark.parametrize("name", ["static-drive", "dynamic-traffic"])
def test_control_fails_on_the_card(card, name):
    """At the cell's own size: the port holds the cell's limits and the
    control breaks one of them, on three seeds."""
    import time

    from benchmark import configio, harness

    limits = configio.load_workload(name)["limits"]
    for seed in (2147483647 + 11, 5, 2 ** 31 + 77):
        r = harness.run_cell(name, seed, 3.0, False, time.perf_counter(),
                             control=True)
        assert r["correct"], r["checks"]
        assert any(v > limits[k] for k, v in r["control"].items())
        torch.cuda.empty_cache()
