"""The traced run's summary: torch.profiler over a few frames of the
window, reduced to what the per-layer metrics read (``metrics/*.py``).

``Summary`` is a copy of ``scripts/bench_setup.py::summarize_trace``'s
reduction (each profiler range's host time, and the kernels and memsets
that ran inside its device projection), with the device's busy time taken
over the traced window's wall time (the ``bench.window`` range), kernel
time by kernel name, and the breakdown the result line carries: the
device operations that took most time and the longest idle gaps by the
host range that was open. ``device_busy`` reads the device clock of an
untraced run: the card's busy time over the whole window.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: the profiler ranges the summary keeps: the port's stages and the
#: harness's own spans
PREFIXES = ("fused_step.", "fused_dyn.", "fused_eval.", "bench.")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the traced window's range (harness)
WINDOW = "bench.window"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s0, s1 in sorted(intervals):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy


def device_busy(events) -> tuple:
    """(seconds, operations) of the card's busy time in ``events``, a
    profiler's raw events (``prof.profiler.kineto_results.events()``):
    the union of the spans of its kernels, copies and memsets, the events
    on the CUDA device that are no range's projection."""
    import numpy as np
    from torch.autograd import DeviceType

    iv = np.array([(e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation()],
                  dtype=np.int64).reshape(-1, 2)
    if not len(iv):
        return 0.0, 0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    before = np.concatenate((iv[:1, 0], ends[:-1]))
    busy = np.clip(iv[:, 1] - np.maximum(iv[:, 0], before), 0, None).sum()
    return float(busy) / 1e9, len(iv)


def _gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] between the (start, end) intervals."""
    out, cur = [], lo
    for s0, s1 in sorted(intervals):
        if s0 > cur:
            out.append((cur, min(s0, hi)))
        cur = max(cur, s1)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Summary:
    """What ``n`` traced frames recorded. ``extra`` carries what the
    harness counted beside the trace (K1's bound)."""

    def __init__(self, events: List[dict], n: int, extra: Optional[dict]
                 = None):
        self.n = n
        self.extra = extra or {}
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW} range")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        self.window_s = (w1 - w0) / 1e6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and w0 <= e["ts"] < w1]
        self.device = [(e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev]
        self.busy_s = union_us(self.device) / 1e6
        kernels = sorted((e["ts"], e["dur"], e["name"]) for e in dev
                         if e["cat"] == "kernel")
        memsets = sorted(e["ts"] for e in dev if e["cat"] == "gpu_memset")
        self.kernel_count = len(kernels)
        self.ops: Dict[str, float] = defaultdict(float)
        for e in dev:
            self.ops[e["name"]] += e["dur"] / 1e6
        #: per range: [host ms, device kernel ms, kernels, memsets] summed
        self.stages: Dict[str, List[float]] = {}
        #: per range: kernel us by kernel name inside its device projection
        #: (a range that launched nothing on the card has no entry)
        self.stage_kernels: Dict[str, Dict[str, float]] = {}
        self.host_ranges = []
        for e in events:
            name = e.get("name", "")
            if not name.startswith(PREFIXES) or name == WINDOW:
                continue
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            if not (w0 <= t0 < w1):
                continue
            st = self.stages.setdefault(name, [0.0, 0.0, 0.0, 0.0])
            if e.get("cat") == "user_annotation":
                st[0] += e["dur"] / 1e3
                self.host_ranges.append((t0, t1, name))
            elif e.get("cat") == "gpu_user_annotation":
                inside = [(d, k) for t, d, k in kernels if t0 <= t < t1]
                st[1] += sum(d for d, _ in inside) / 1e3
                st[2] += len(inside)
                st[3] += sum(t0 <= t < t1 for t in memsets)
                by = self.stage_kernels.setdefault(name, defaultdict(float))
                for d, k in inside:
                    by[k] += d
        self.gaps = _gaps(self.device, w0, w1)

    # -- what the metric files read ------------------------------------
    def stage(self, name: str, field: str) -> Optional[float]:
        """A range's ``host_ms``, ``device_ms``, ``launches`` or
        ``memsets`` a frame; None where the range was not recorded."""
        st = self.stages.get(name)
        if st is None:
            return None
        i = ("host_ms", "device_ms", "launches", "memsets").index(field)
        if i and name not in self.stage_kernels:
            return None
        return st[i] / self.n

    def kernel_ms(self, match: str, stage: Optional[str] = None
                  ) -> Optional[float]:
        """Time a frame of the kernels whose name contains ``match`` (inside
        ``stage``'s device projection when given); None where none ran."""
        if stage is None:
            t = [v for k, v in self.ops.items() if match in k]
            return sum(t) * 1e3 / self.n if t else None
        t = [v for k, v in self.stage_kernels.get(stage, {}).items()
             if match in k]
        return sum(t) / 1e3 / self.n if t else None

    def breakdown(self) -> dict:
        """The 10 device operations that took most time and the 10 longest
        idle gaps, each named by the innermost harness or port range open
        on the host at its middle ("host" where none was)."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            open_ = [(t1 - t0, n) for t0, t1, n in self.host_ranges
                     if t0 <= mid < t1]
            gaps.append([min(open_)[1] if open_ else "host", (b - a) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def export_and_read(prof, tmp_dir: str) -> List[dict]:
    """The profiler's chrome trace events, written into ``tmp_dir`` and
    read back; the file is removed."""
    path = os.path.join(tmp_dir, f"bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _metric_files(bench: dict, cell: str, root):
    """(entry, module) of each per-layer metric of ``bench`` that ``cell``
    reports, its module ``metrics/<name>.py``."""
    from pathlib import Path

    from benchmark.configio import load_module

    for m in bench["per_layer"]:
        if cell in m.get("workloads", [cell]):
            yield m, load_module(Path(root) / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric")


def collect_metrics(bench: dict, cell: str, pipe, frames, root) -> dict:
    """What the cell's metric files that define ``collect(pipe, frames)``
    collect from the pipeline after a traced run (``frames``: the traced
    ones), by metric name: the harness puts each in ``Summary.extra``,
    where that metric's ``read`` finds it."""
    return {m["name"]: mod.collect(pipe, frames)
            for m, mod in _metric_files(bench, cell, root)
            if hasattr(mod, "collect")}


def read_metrics(bench: dict, cell: str, summary: Summary, root) -> dict:
    """The cell's per-layer metrics of ``bench`` (``BENCHMARK.json``): each
    read by its own file ``metrics/<name>.py`` (``read(summary)``), left
    out where the reader finds nothing."""
    out = {}
    for m, mod in _metric_files(bench, cell, root):
        value = mod.read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
