"""Nothing the benchmark loads is JAX or the JAX package, and its
reference loads nothing of the port: checked in fresh interpreters, by
whole top-level module names."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "dynslam_tpu"}

LOAD_ALL = r"""
import importlib.util, json, sys
from pathlib import Path
import benchmark.harness, benchmark.run, benchmark.trace, benchmark.control
import benchmark.roofline, benchmark.check
from benchmark import configio
bench = json.loads(Path("BENCHMARK.json").read_text())
for w in bench["workloads"]:
    configio.load_workload(w["name"])
for m in bench["per_layer"]:
    p = Path("benchmark/metrics") / (m["name"] + ".py")
    spec = importlib.util.spec_from_file_location(p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
# the port's pipelines as the harness builds them
from dynslam_tpu_torch.pipeline import builder, fused, fused_dynamic
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, pkgutil, sys, importlib
import benchmark.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("benchmark.reference." + m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
                              "USE_FLAX": "0"}, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(LOAD_ALL)
    assert "dynslam_tpu_torch" in mods and "benchmark" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _top_level(REFERENCE)
    assert "benchmark" in mods and "torch" in mods
    assert not mods & (FORBIDDEN | {"dynslam_tpu_torch"})
