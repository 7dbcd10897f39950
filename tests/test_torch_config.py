"""The port's configuration copy (``dynslam_tpu_torch/config.py``) keeps
the JAX package's field names and defaults, so a configuration means the
same on both sides and the JAX objects can be passed to the port."""

import dataclasses

import pytest

from dynslam_tpu import config as jax_config
from dynslam_tpu_torch import config as port_config

CLASSES = ["StereoCalibration", "Intrinsics", "SceneParams",
           "VoxelDecayParams", "MapParams", "InstanceMapParams",
           "VisualOdometryParams", "StereoMatcherParams", "TrackerParams",
           "EvaluationParams", "DynSlamConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match(name):
    port_cls = getattr(port_config, name)
    jax_fields = {f.name: f for f in dataclasses.fields(
        getattr(jax_config, name))}
    port_obj, jax_obj = port_cls(), getattr(jax_config, name)()
    for f in dataclasses.fields(port_cls):
        assert f.name in jax_fields, f.name
        assert f.type == jax_fields[f.name].type, f.name
        pv, jv = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if dataclasses.is_dataclass(pv):
            assert dataclasses.asdict(pv).items() <= dataclasses.asdict(
                jv).items(), f.name
        else:
            assert pv == jv, f.name


def test_evaluation_fields_of_the_top_level():
    """The top-level fields the evaluation reads exist on both sides with
    the same defaults."""
    for name in ("evaluation", "fusion_every", "use_direct_refinement",
                 "dynamic_mode", "min_depth_m", "max_depth_m",
                 # the staged path's
                 "right_intrinsics", "external_odometry",
                 "use_bilateral_filter", "use_dispnet", "scale"):
        pv = getattr(port_config.DynSlamConfig(), name)
        jv = getattr(jax_config.DynSlamConfig(), name)
        if dataclasses.is_dataclass(pv):
            pv, jv = dataclasses.asdict(pv), dataclasses.asdict(jv)
        assert pv == jv, name
    assert port_config.MapParams().use_depth_weighting == \
        jax_config.MapParams().use_depth_weighting


def test_derived_values_match():
    assert port_config.StereoCalibration().bf == jax_config.StereoCalibration().bf
    assert port_config.Intrinsics().as_tuple() == \
        jax_config.Intrinsics().as_tuple()
    assert port_config.SceneParams().block_size_m == \
        jax_config.SceneParams().block_size_m
    assert port_config.VOXEL_BLOCK_SIZE == jax_config.VOXEL_BLOCK_SIZE


@pytest.mark.parametrize("size", [(128, 96), (160, 120)])
def test_tiny_test_config_matches(size):
    port = dataclasses.asdict(port_config.tiny_test_config(*size))
    jax = dataclasses.asdict(jax_config.tiny_test_config(*size))
    assert port.items() <= jax.items()
    assert set(port) == {f.name for f in dataclasses.fields(
        port_config.DynSlamConfig)}
