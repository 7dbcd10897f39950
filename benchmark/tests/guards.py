"""The benchmark's guards over a root: a benchmark folder and the
``BENCHMARK.json`` that names its cells and metrics, by default the
repo's. The tests run each on the committed files, and on a copy with a
rigged cell and new metrics dropped in as files, so that a cell that
arrives as files alone passes them unedited.

Each raises (an ``AssertionError``, or the loader's ``ValueError``)
where its guard does not hold."""

import json
import math
import numbers
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import configio, harness, lidar, scene
from benchmark import trace as tr
from benchmark.reference import replay

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dynslam_tpu"}
#: a name as the contract allows it
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

#: the committed cells the guards name: the two of BENCHMARK.json, and
#: the workload file kept for ``dynamic-empty-road``'s return
COMMITTED = ("static-drive", "dynamic-traffic")
KEPT = ("dynamic-empty-road",)
#: ``static-drive``'s folder, as it was named before the hooks
STATIC_FOLDER = "static-drive-f737d675be6bc683"


def _bench(root, bench_json):
    root = Path(root)
    path = Path(bench_json) if bench_json else root.parent / "BENCHMARK.json"
    return root, path, json.loads(path.read_text())


# -- the committed cells -----------------------------------------------

def committed_cells_load(root=BENCH, bench_json=None) -> None:
    """``static-drive`` and ``dynamic-traffic`` are cells of
    BENCHMARK.json; they and the kept ``dynamic-empty-road`` load with no
    plug-in and no rig, and ``static-drive`` keeps its folder. Every other
    cell loads; a rigged one is dynamic with a valid rig, and each of its
    plug-ins gives a reading its ``limits`` name."""
    root, _, bench = _bench(root, bench_json)
    names = [w["name"] for w in bench["workloads"]]
    missing = sorted(set(COMMITTED) - set(names))
    assert not missing, f"committed cells left out of BENCHMARK.json: " \
        f"{missing}"
    for name in COMMITTED + KEPT:
        cell = configio.load_workload(name, root)
        assert cell["plugins"] == {} and "lidar" not in cell["config_file"], \
            name
    cell = configio.load_workload("static-drive", root)
    n = len(scene.make_drive(cell["drive"], harness.cell_frames(
        cell, bench["run_seconds"])).poses)
    assert harness.folder_name(cell, n) == STATIC_FOLDER
    for name in names:
        cell = configio.load_workload(name, root)
        rig = cell["config_file"].get("lidar")
        if rig is not None:
            assert cell["config_file"]["config"].get("dynamic_mode", True), \
                name
            lidar.validate(rig)
        for pname, mod in cell["plugins"].items():
            assert set(mod.READINGS) & set(cell["limits"]), (name, pname)


# -- BENCHMARK.json against the files ----------------------------------

def json_matches_the_files(root=BENCH, bench_json=None) -> None:
    """Each configuration entry is its file (source, reduced, every key a
    field of the config); each cell entry is its workload file, with the
    built-in check's first limits; each metric entry is its file's
    constants, over cells of BENCHMARK.json; the end-to-end metrics are
    among those the harness takes, ``setup_s`` among them, over cells of
    BENCHMARK.json."""
    root, path, bench = _bench(root, bench_json)
    for c in bench["configs"]:
        assert NAME.match(c["name"]), c["name"]
        file = path.parent / c["file"]
        assert file.resolve() == (root / "configs"
                                  / f"{c['name']}.json").resolve(), c["name"]
        f = json.loads(file.read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        replay.setup(f["config"])  # every key is a field of the config
    for w in bench["workloads"]:
        cell = configio.load_workload(w["name"], root)
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert set(cell["limits"]) >= {"config_diff", "depth_diff_share"}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = configio.load_module(root / "metrics" / f"{m['name']}.py",
                                   "guard_metric")
        assert (mod.LAYER, mod.UNIT, mod.MOVES) \
            == (m["layer"], m["unit"], m["moves"])
        assert set(m.get("workloads", cells)) <= cells
    names = {m["name"] for m in bench["end_to_end"]}
    assert names <= set(harness.END_TO_END) and "setup_s" in names, names
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def cells_report_what_their_metrics_move(root=BENCH, bench_json=None
                                         ) -> None:
    """Every cell reports ``setup_s``, another end-to-end metric and a
    per-layer metric, and each per-layer metric that lists it moves an
    end-to-end metric it reports."""
    root, _, bench = _bench(root, bench_json)
    cells = [w["name"] for w in bench["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in bench["end_to_end"]
               if cell in m.get("workloads", cells)}
        assert "setup_s" in e2e and len(e2e) >= 2, (cell, e2e)
        per = [m for m in bench["per_layer"]
               if cell in m.get("workloads", cells)]
        assert per, cell
        for m in per:
            assert m["moves"] in e2e, (cell, m["name"], m["moves"])


# -- the metric files on a recorded trace ------------------------------

def _frame(t0):
    """One frame's events from ``t0`` (us): host ranges, their device
    projections and the kernels inside them."""
    ev = [dict(name="bench.loop", cat="user_annotation", ts=t0, dur=400)]
    stages = [("fused_step.stereo", 10, 40, [("census_k", 30), ("cost_k", 40)]),
              ("fused_step.features", 50, 30, [("feat_k", 10)]),
              ("fused_step.egomotion", 80, 150,
               [("gn_k", 5), ("gn_k", 5), ("gn_k", 5)]),
              ("fused_step.allocate", 230, 20, [("alloc_k", 4)]),
              ("fused_step.integrate", 250, 10,
               [("void integrate_kernel(int*, int*)", 8)]),
              ("fused_step.raycast", 260, 10,
               [("candidates_kernel(int const*)", 2),
                ("march_kernel(Params, Maps)", 12)]),
              ("fused_step.decay", 270, 10, [("decay_k", 3)]),
              ("fused_dyn.obj_ransac", 280, 60, [("gn_k", 6)]),
              ("fused_dyn.instances", 340, 20,
               [("void integrate_kernel(int*, int*)", 4)])]
    g0 = t0 + 300
    for name, s, d, ks in stages:
        ev.append(dict(name=name, cat="user_annotation", ts=t0 + s, dur=d))
        g0 += 20
        t = g0
        for kname, kd in ks:
            ev.append(dict(name=kname, cat="kernel", ts=t, dur=kd))
            t += kd + 1
        ev.append(dict(name=name, cat="gpu_user_annotation", ts=g0,
                       dur=t - g0))
        if name == "fused_step.raycast":
            ev.append(dict(name="Memset (Device)", cat="gpu_memset",
                           ts=t - 1, dur=1))
        g0 = t
    # host ranges that launch nothing: the input copies before stereo,
    # the host tracker's association, its wait on the packed fetch and
    # its pass after it
    for name, s, d in (("fused_step.upload", 2, 6),
                       ("fused_dyn.associate", 362, 6),
                       ("fused_dyn.fetch_wait", 370, 2),
                       ("fused_dyn.tracker", 374, 14)):
        ev.append(dict(name=name, cat="user_annotation", ts=t0 + s, dur=d))
    return ev


#: two frames' worth of chrome-trace events, written out by hand with the
#: categories torch.profiler gives them, and a kernel before the window
EVENTS = ([dict(name="bench.window", cat="user_annotation", ts=1000,
                dur=2000)]
          + _frame(1000) + _frame(2000)
          + [dict(name="early_k", cat="kernel", ts=500, dur=50)])
EXTRA = dict(k1=dict(bound_ms=0.008, launches=2), seg_worker_ms=3.5)


def known_readings(s: tr.Summary) -> dict:
    """What each of the benchmark's 18 metrics reads on ``EVENTS``, worked
    out by hand."""
    return {
        "loop_host_ms": 0.4, "seg_worker_ms": 3.5,
        "stereo_device_ms": 0.07, "features_host_ms": 0.03,
        "egomotion_host_ms": 0.15, "egomotion_launches": 3.0,
        "allocate_host_ms": 0.02, "k1_device_ms": 0.012,
        "k1_roofline": 100 * 0.008 / 0.016, "k2_device_ms": 0.014,
        "decay_device_ms": 0.003, "obj_ransac_host_ms": 0.06,
        "instances_host_ms": 0.02,
        "device_idle": 100 * (1 - s.busy_s / s.window_s),
        "upload_host_ms": 0.006, "tracker_host_ms": 0.006 + 0.014,
        "fetch_wait_ms": 0.002,
        # a 400-us loop less the port's ranges in it: 2-8, 10-360 (the
        # stages end to end), 362-368, 370-372 and 374-388 us
        "loop_unspanned_ms": (400 - (6 + 350 + 6 + 2 + 14)) / 1e3,
    }


def metric_files_read_the_trace(root=BENCH, bench_json=None) -> None:
    """The 18 known metrics are all in BENCHMARK.json and read what
    ``known_readings`` says on ``EVENTS``. Every other metric has a file
    whose constants match its entry and whose ``read`` gives None or a
    finite number there. A metric's ``workloads`` name cells of
    BENCHMARK.json."""
    root, _, bench = _bench(root, bench_json)
    s = tr.Summary(EVENTS, 2, EXTRA)
    want = known_readings(s)
    entries = {m["name"]: m for m in bench["per_layer"]}
    missing = sorted(set(want) - set(entries))
    assert not missing, f"metrics left out of BENCHMARK.json: {missing}"
    cells = {w["name"] for w in bench["workloads"]}
    for name, m in entries.items():
        mod = configio.load_module(root / "metrics" / f"{name}.py",
                                   "guard_metric")
        got = mod.read(s)
        if name in want:
            assert got == pytest.approx(want[name]), name
        else:
            assert (mod.LAYER, mod.UNIT, mod.MOVES) \
                == (m["layer"], m["unit"], m["moves"]), name
            assert got is None or (isinstance(got, numbers.Real)
                                   and math.isfinite(got)), (name, got)
        if "workloads" in m:
            assert set(m["workloads"]) <= cells, name


# -- what a fresh interpreter loads ------------------------------------

LOAD_ALL = r"""
import json, sys
from pathlib import Path
root, bench_json = Path(sys.argv[1]), Path(sys.argv[2])
import benchmark.harness, benchmark.run, benchmark.trace, benchmark.control
import benchmark.roofline, benchmark.check
from benchmark import configio
bench = json.loads(bench_json.read_text())
for w in bench["workloads"]:
    configio.load_workload(w["name"], root)
for m in bench["per_layer"]:
    configio.load_module(root / "metrics" / (m["name"] + ".py"), "m")
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


def _top_level(code: str, root: Path, bench_json: Path) -> set:
    """The top-level modules a fresh interpreter holds after ``code``, run
    beside ``root`` (so that ``import benchmark`` is that folder, where it
    is named so) with the port importable from the repo."""
    out = subprocess.run([sys.executable, "-c", code, str(root),
                          str(bench_json)], cwd=root.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(REPO), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def harness_loads_no_jax(root=BENCH, bench_json=None) -> None:
    """A fresh interpreter that loads the harness, every cell with its
    plug-ins, every metric file and the port's pipelines holds neither
    JAX nor the JAX package, by whole top-level names."""
    root, path, _ = _bench(root, bench_json)
    mods = _top_level(LOAD_ALL, root.resolve(), path.resolve())
    assert "dynslam_tpu_torch" in mods and "benchmark" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def reference_loads_nothing_of_the_port(root=BENCH, bench_json=None) -> None:
    """Every module of the plain reference, in a fresh interpreter, loads
    neither JAX, nor the JAX package, nor the port."""
    root, path, _ = _bench(root, bench_json)
    mods = _top_level(REFERENCE, root.resolve(), path.resolve())
    assert "benchmark" in mods and "torch" in mods
    assert not mods & (FORBIDDEN | {"dynslam_tpu_torch"})
