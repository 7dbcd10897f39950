"""The benchmark is driven by its files: ``BENCHMARK.json`` agrees with the
configuration, workload and metric files, and a configuration, a cell, a
check or a metric added as files alone is found by name and passes the
benchmark's guards (``guards.py``) unedited."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import configio, harness, lidar
from benchmark import trace as tr
from benchmark.reference import replay
from benchmark.tests import guards

BENCH = Path(__file__).resolve().parents[1]

#: a check plug-in for the rigged cell: 1 for each checked frame that has
#: no depth row in the evaluation's CSVs
EVAL_ROWS = '''
import contextlib, glob, os

READINGS = ("eval_rows_missing",)


@contextlib.contextmanager
def probe(pipe, frames, run):
    yield None


def gaps(captured, su, run):
    rows = set()
    for p in glob.glob(os.path.join(run["csv_dir"],
                                    "*-unified-depth-result.csv")):
        with open(p) as f:
            rows |= {int(line.split(",")[0]) for line in f.readlines()[1:]}
    return {fi: {"eval_rows_missing": float(fi not in rows)}
            for fi in run["frames"]}


control_gaps = gaps
'''
#: a metric that collects the evaluation worker's median time a job
EVAL_JOB_MS = '''
LAYER = "evaluation"
UNIT = "ms"
MOVES = "frame_device_ms"


def collect(pipe, frames):
    jobs = sorted(pipe.evaluation.job_ms)
    return jobs[len(jobs) // 2] if jobs else None


def read(s):
    return s.extra.get("eval_job_ms")
'''
#: a metric that reads the staged evaluation's object renders
EVAL_RENDER_HOST_MS = '''
LAYER = "evaluation"
UNIT = "ms"
MOVES = "frame_device_ms"


def read(s):
    return s.stage("fused_dyn.eval_render", "host_ms")
'''
#: every guard of ``guards.py``, each taking a root and a BENCHMARK.json
GUARDS = (guards.committed_cells_load, guards.json_matches_the_files,
          guards.cells_report_what_their_metrics_move,
          guards.metric_files_read_the_trace, guards.harness_loads_no_jax,
          guards.reference_loads_nothing_of_the_port)


@pytest.fixture(scope="module")
def bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_benchmark_json_matches_the_files():
    guards.json_matches_the_files()


def test_every_cell_reports_what_its_metrics_move():
    guards.cells_report_what_their_metrics_move()


def test_new_files_are_found(tmp_path, bench):
    """A configuration, a cell and a metric dropped into a copy of the
    benchmark's folder as files: the harness loads the cell with its
    configuration, and reads the metric where BENCHMARK.json names it."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    conf = json.loads((root / "configs" / "kitti-dynamic.json").read_text())
    conf["config"]["instance_map"] = {"max_objects": 4, "max_detections": 4}
    (root / "configs" / "kitti-dynamic-k4.json").write_text(json.dumps(conf))
    cell = json.loads((root / "workloads" / "dynamic-traffic.json")
                      .read_text())
    cell["config"] = "kitti-dynamic-k4"
    (root / "workloads" / "dynamic-traffic-k4.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "cut_host_ms.py").write_text(
        'LAYER = "silhouette cut"\nUNIT = "ms"\nMOVES = "fps"\n\n\n'
        'def read(s):\n    return s.stage("fused_dyn.cut", "host_ms")\n')
    got = configio.load_workload("dynamic-traffic-k4", root)
    su = replay.setup(got["config_file"]["config"])
    assert (su.K, su.S) == (4, 4)
    assert harness.cell_frames(got, 30) == 45 + 8 * 30
    b = dict(bench, per_layer=bench["per_layer"] + [
        dict(name="cut_host_ms", unit="ms", better="lower",
             source="program_span", layer="silhouette cut", moves="fps",
             workloads=["dynamic-traffic-k4"])])
    events = [dict(name="bench.window", cat="user_annotation", ts=0,
                   dur=100),
              dict(name="fused_dyn.cut", cat="user_annotation", ts=10,
                   dur=40)]
    out = tr.read_metrics(b, "dynamic-traffic-k4", tr.Summary(events, 2),
                          root)
    assert out["cut_host_ms"] == {"value": 0.02, "unit": "ms"}
    assert "cut_host_ms" not in tr.read_metrics(
        b, "static-drive", tr.Summary(events, 2), root)


def test_check_frames_come_from_the_seed():
    cell = configio.load_workload("static-drive")
    a = harness.check_frames(cell, 2 ** 31 + 9, 1000)
    assert a == harness.check_frames(cell, 2 ** 31 + 9, 1000)
    assert a[0] == 1 and len(a) == 1 + harness.CHECK_FRAMES
    w = cell["warmup_frames"]
    assert all(w < f <= w + harness.CHECK_SPAN for f in a[1:])


def _rigged_copy(tmp: Path) -> tuple:
    """A copy of the benchmark's folder and BENCHMARK.json in ``tmp``, with
    the LIDAR-evaluation cell dropped in as files and entries: the
    configuration ``kitti-dynamic-eval`` (``kitti-dynamic`` with KITTI's
    rig), the cell ``dynamic-traffic-eval`` on the traffic drive (its
    limits and a plug-in's reading) on the device clock, the check
    plug-in and two metrics that list the cell. Returns (folder,
    BENCHMARK.json)."""
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    conf = json.loads((root / "configs" / "kitti-dynamic.json").read_text())
    conf["lidar"] = lidar.HDL64E
    (root / "configs" / "kitti-dynamic-eval.json").write_text(
        json.dumps(conf))
    cell = json.loads((root / "workloads" / "dynamic-traffic.json")
                      .read_text())
    cell.update(config="kitti-dynamic-eval",
                why="the traffic drive with each frame's HDL-64E scan and "
                    "the port's in-loop evaluation",
                limits=dict(cell["limits"], eval_rows_missing=0))
    (root / "workloads" / "dynamic-traffic-eval.json").write_text(
        json.dumps(cell))
    (root / "checks").mkdir(exist_ok=True)
    (root / "checks" / "eval_rows.py").write_text(EVAL_ROWS)
    (root / "metrics" / "eval_job_ms.py").write_text(EVAL_JOB_MS)
    (root / "metrics" / "eval_render_host_ms.py").write_text(
        EVAL_RENDER_HOST_MS)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    base = next(c for c in bench["configs"] if c["name"] == "kitti-dynamic")
    bench["configs"].append(dict(
        base, name="kitti-dynamic-eval",
        file="benchmark/configs/kitti-dynamic-eval.json",
        why="DynSLAM's dynamic mode with KITTI's HDL-64E and its LIDAR "
            "evaluation"))
    bench["workloads"].append(dict(
        name="dynamic-traffic-eval", config="kitti-dynamic-eval",
        traffic="traffic", chips=1, why=cell["why"]))
    for m in bench["end_to_end"]:
        if m["name"] == "frame_device_ms":
            m["workloads"].append("dynamic-traffic-eval")
    for name, source in (("eval_job_ms", "program_counter"),
                         ("eval_render_host_ms", "program_span")):
        bench["per_layer"].append(dict(
            name=name, unit="ms", better="lower", source=source,
            layer="evaluation", moves="frame_device_ms",
            workloads=["dynamic-traffic-eval"]))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return root, path


def _variant(path: Path, name: str, edit) -> Path:
    """``path``'s BENCHMARK.json with ``edit`` applied, beside it."""
    bench = json.loads(path.read_text())
    edit(bench)
    out = path.parent / name
    out.write_text(json.dumps(bench))
    return out


def test_a_rigged_cell_arrives_as_files(tmp_path):
    """A dynamic cell with KITTI's rig, a check plug-in and two metrics
    that list it, added to a copy as new files and entries alone, pass
    every guard; the harness loads the cell with its plug-in and reads the
    metrics in that cell alone. The guards still catch a committed cell
    left out, a known metric left out, a metric that moves what its cell
    does not report and a rig on the static configuration."""
    root, path = _rigged_copy(tmp_path)
    for guard in GUARDS:
        guard(root, path)
    cell = configio.load_workload("dynamic-traffic-eval", root)
    assert set(cell["plugins"]) == {"eval_rows"}
    assert cell["config_file"]["lidar"] == lidar.HDL64E
    bench = json.loads(path.read_text())
    events = [dict(name="bench.window", cat="user_annotation", ts=0,
                   dur=100),
              dict(name="fused_dyn.eval_render", cat="user_annotation",
                   ts=10, dur=30)]
    s = tr.Summary(events, 2, {"eval_job_ms": 12.5})
    out = tr.read_metrics(bench, "dynamic-traffic-eval", s, root)
    assert out["eval_job_ms"] == {"value": 12.5, "unit": "ms"}
    assert out["eval_render_host_ms"] == {"value": 0.015, "unit": "ms"}
    assert not {"eval_job_ms", "eval_render_host_ms"} & set(
        tr.read_metrics(bench, "dynamic-traffic", s, root))

    dropped = _variant(path, "no_static.json", lambda b: b.update(
        workloads=[w for w in b["workloads"] if w["name"] != "static-drive"]))
    with pytest.raises(AssertionError, match="static-drive"):
        guards.committed_cells_load(root, dropped)
    no_k1 = _variant(path, "no_k1.json", lambda b: b.update(
        per_layer=[m for m in b["per_layer"]
                   if m["name"] != "k1_device_ms"]))
    with pytest.raises(AssertionError, match="k1_device_ms"):
        guards.metric_files_read_the_trace(root, no_k1)
    on_fps = _variant(path, "on_fps.json", lambda b: [
        m.update(moves="fps") for m in b["per_layer"]
        if m["name"] == "eval_job_ms"])
    with pytest.raises(AssertionError, match="eval_job_ms"):
        guards.cells_report_what_their_metrics_move(root, on_fps)
    static = root / "configs" / "kitti-odometry-static.json"
    conf = json.loads(static.read_text())
    static.write_text(json.dumps(dict(conf, lidar=lidar.HDL64E)))
    with pytest.raises(ValueError, match="needs a dynamic configuration"):
        configio.load_workload("static-drive", root)
    with pytest.raises(ValueError, match="needs a dynamic configuration"):
        guards.committed_cells_load(root, path)
