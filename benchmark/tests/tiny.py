"""Tiny cells for the CPU tests: a 160x120 camera, small pools, decay from
frame 3, the static drive and one with two cars; written into a folder
laid out as the benchmark's (``configs/``, ``workloads/``, ``metrics/``,
``BENCHMARK.json``)."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
W, H = 160, 120
CONFIG = {
    "frame_width": W, "frame_height": H,
    "intrinsics": {"fx": 0.8 * W, "fy": 0.8 * W, "cx": W / 2, "cy": H / 2},
    "right_intrinsics": {"fx": 0.8 * W, "fy": 0.8 * W, "cx": W / 2,
                         "cy": H / 2},
    "calibration": {"baseline_m": 0.5, "focal_length_px": 0.8 * W},
    "max_depth_m": 8.0,
    "scene": {"voxel_size_m": 0.05, "mu_m": 0.30},
    "map": {"pool_capacity": 16384, "local_dims": [80, 32, 80],
            "max_new_blocks_per_frame": 4096},
    "instance_map": {"blocks_per_object": 1024, "local_dims": [48, 24, 64],
                     "max_new_blocks_per_frame": 512, "mu_m": 0.3},
    "stereo": {"max_disparity": 64},
    "vo": {"max_candidates": 1024, "max_matches": 512, "ransac_iters": 60,
           "max_disparity": 64},
    "tracker": {"min_flow_vectors": 8, "min_detection_size_px": 8},
    "decay": {"enabled": True, "min_decay_age": 3, "max_decay_weight": 1},
}
ROAD = {"scene_seed": 11, "speed_m": 0.4, "yaw_rate": 0.003}
CARS = [{"x": 1.2, "z": 6.0, "v": 0.45},
        {"x": -2.2, "z": 16.0, "v": -0.9, "spacing_m": 28.0}]


def limits(dynamic: bool) -> dict:
    lim = {"config_diff": 0, "depth_diff_share": 0.0, "pose_gap": 0.0,
           "map_diff_share": 0.0, "raycast_diff_share": 0.0,
           "handover_diff": 0}
    if dynamic:
        lim.update(mask_bits_diff=0, motion_gap=0.0,
                   instance_diff_share=0.0, cut_diff_share=0.0)
    return lim


def make_root(tmp: Path) -> Path:
    """A benchmark folder with the cells ``tiny-static`` and
    ``tiny-dynamic``, the benchmark's metric files and a BENCHMARK.json
    whose dynamic-only metrics list ``tiny-dynamic``."""
    root = Path(tmp) / "bench"
    (root / "configs").mkdir(parents=True)
    (root / "workloads").mkdir()
    shutil.copytree(BENCH / "metrics", root / "metrics")
    for name, dyn in (("tiny-static", False), ("tiny-dynamic", True)):
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            {"source": "tests", "reduced": [],
             "config": {**CONFIG, "dynamic_mode": dyn}}))
        (root / "workloads" / f"{name}.json").write_text(json.dumps(dict(
            config=name, traffic="cars" if dyn else "drive", chips=1,
            why="tests", drive={**ROAD, "cars": CARS if dyn else []},
            cap_hz=3, warmup_frames=5, limits=limits(dyn))))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-dynamic"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, name: str, seed: int = 7, **kw) -> dict:
    """One run of a tiny cell on the CPU, a 1-second window."""
    import time

    from benchmark import harness

    return harness.run_cell(name, seed, 1.0, False, time.perf_counter(),
                            root=root, bench_json=root / "BENCHMARK.json",
                            device="cpu", **kw)
