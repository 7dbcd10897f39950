"""The port imports torch and never jax: ``import dynslam_tpu_torch`` and
every module of the static, dynamic and staged slices, of the evaluation,
of the CLI, of the learned models, of the parallel paths, of the native
readers and of the scripts leave no
``jax*``, ``flax``, ``optax``, ``msgpack`` or ``cv2`` module and nothing
of the JAX package ``dynslam_tpu`` loaded. Checked in a fresh interpreter,
because this test process imports jax (``tests/conftest.py``)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dynslam_tpu_torch"

SLICE_MODULES = [
    "dynslam_tpu_torch",
    "dynslam_tpu_torch.device",
    "dynslam_tpu_torch.config",
    "dynslam_tpu_torch.convert",
    "dynslam_tpu_torch.io.synthetic",
    "dynslam_tpu_torch.utils.se3",
    "dynslam_tpu_torch.ops.cuda_build",
    "dynslam_tpu_torch.ops.depth",
    "dynslam_tpu_torch.ops.tsdf",
    "dynslam_tpu_torch.ops.integrate",
    "dynslam_tpu_torch.ops.raycast",
    "dynslam_tpu_torch.ops.stereo",
    "dynslam_tpu_torch.ops.features",
    "dynslam_tpu_torch.ops.egomotion",
    "dynslam_tpu_torch.ops.icp",
    "dynslam_tpu_torch.pipeline.fused",
    "dynslam_tpu_torch.pipeline.builder",
    # the dynamic slice
    "dynslam_tpu_torch.io.segmentation",
    "dynslam_tpu_torch.instances.track",
    "dynslam_tpu_torch.instances.tracker",
    "dynslam_tpu_torch.ops.masks",
    "dynslam_tpu_torch.pipeline.fused_dynamic",
    # the evaluation slice
    "dynslam_tpu_torch.io.calib",
    "dynslam_tpu_torch.io.velodyne",
    "dynslam_tpu_torch.io.input",
    "dynslam_tpu_torch.eval.records",
    "dynslam_tpu_torch.eval.csv_writer",
    "dynslam_tpu_torch.eval.evaluation",
    "dynslam_tpu_torch.eval.fused_eval",
    # the staged slice and the CLI
    "dynslam_tpu_torch.utils.timers",
    "dynslam_tpu_torch.utils.pfm",
    "dynslam_tpu_torch.io.images",
    "dynslam_tpu_torch.io.depth_providers",
    "dynslam_tpu_torch.pipeline.mapping",
    "dynslam_tpu_torch.pipeline.sparse_sf",
    "dynslam_tpu_torch.pipeline.dynslam",
    "dynslam_tpu_torch.pipeline.checkpoint",
    "dynslam_tpu_torch.instances.volume_pool",
    "dynslam_tpu_torch.instances.reconstructor",
    "dynslam_tpu_torch.main",
    # the CLI's last outputs
    "dynslam_tpu_torch.viz.meshing",
    "dynslam_tpu_torch.viz.renderer",
    "dynslam_tpu_torch.io.prefetch",
    "dynslam_tpu_torch.ops.direct_align",
    "dynslam_tpu_torch.eval.error_viz",
    "dynslam_tpu_torch.io.tracklets",
    "dynslam_tpu_torch.eval.tracking_eval",
    # the learned models and the parallel paths
    "dynslam_tpu_torch.utils.msgpack",
    "dynslam_tpu_torch.models.layers",
    "dynslam_tpu_torch.models.dispnet",
    "dynslam_tpu_torch.models.segnet",
    "dynslam_tpu_torch.parallel.launch",
    "dynslam_tpu_torch.parallel.sharding",
    "dynslam_tpu_torch.parallel.batch_eval",
    "dynslam_tpu_torch.entry",
    "dynslam_tpu_torch.scripts.train_dispnet",
    "dynslam_tpu_torch.scripts.preprocess_sequence",
    # the native readers and the last scripts
    "dynslam_tpu_torch.native",
    "dynslam_tpu_torch.native.build",
    "dynslam_tpu_torch.native.fastio",
    "dynslam_tpu_torch.scripts.bench_setup",
    "dynslam_tpu_torch.scripts.soak",
    "dynslam_tpu_torch.scripts.measure_fallback",
    "dynslam_tpu_torch.scripts.scale_sequence",
    "dynslam_tpu_torch.scripts.vo_drift",
    "dynslam_tpu_torch.scripts.vo_diag",
    "dynslam_tpu_torch.scripts.demo_synthetic",
    "dynslam_tpu_torch.scripts.experiments",
    "dynslam_tpu_torch.scripts.profile_dynamic",
]


def test_slice_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'dynslam_tpu', "
        "'cv2', 'msgpack') or k.startswith(('jax.', 'jaxlib', 'flax', "
        "'optax', 'msgpack.', 'dynslam_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    # _build/ holds what the package builds at run time, not its sources
    sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    text = path.read_text()
    assert not re.search(
        r"^\s*(from|import)\s+(jax|flax|optax|msgpack|cv2|dynslam_tpu)\b"
        r"(?!_torch)", text, re.M), path
