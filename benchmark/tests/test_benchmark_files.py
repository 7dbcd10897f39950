"""The benchmark is driven by its files: ``BENCHMARK.json`` agrees with the
configuration, workload and metric files, and a configuration, a cell or
a metric added as files alone is found by name."""

import importlib.util
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import configio, harness
from benchmark import trace as tr
from benchmark.reference import replay

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _module(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_json_matches_the_files(bench):
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        f = json.loads((BENCH.parent / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        replay.setup(f["config"])  # every key is a field of the config
    for w in bench["workloads"]:
        cell = configio.load_workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert set(cell["limits"]) >= {"config_diff", "depth_diff_share"}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = _module(BENCH / "metrics" / f"{m['name']}.py")
        assert (mod.LAYER, mod.UNIT, mod.MOVES) \
            == (m["layer"], m["unit"], m["moves"])
        assert set(m.get("workloads", cells)) <= cells
    assert {m["name"] for m in bench["end_to_end"]} \
        == {"fps", "frame_p90_ms", "setup_s"}


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
    assert harness.cell_frames(got, 30) == 45 + 15 * 30
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
