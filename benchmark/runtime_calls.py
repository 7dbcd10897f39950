"""A traced run's CUDA runtime calls beside the port's ranges: the
synchronising calls the frame thread makes inside ``bench.loop``, the
runtime calls a frame by name, and what the host was in while the card
sat through each of the breakdown's longest idle gaps: the runtime calls
that overlap it and the collector's passes.

    python3 -m benchmark.runtime_calls --workload <cell> --seed <n> \
        --seconds <s>

runs the cell as ``python3 -m benchmark.run --trace 1`` does, with each
pass of Python's cyclic collector in the window in a ``bench.gc`` range
while the profiler runs (so the breakdown names a gap that a pass
explains ``bench.gc``), prints the run's result line, then one JSON line
more: ``loop_syncs`` (synchronising calls a frame), ``loop_calls`` (every
runtime call's count a frame, by name), ``syncs_by_loop`` (each frame's
synchronising calls), ``gc`` (the traced passes: count, ms, longest)
and ``gap_calls`` (one entry a gap). The functions below read a chrome
trace's events (``trace.py``); ``trace.Summary`` keeps none of these
calls.
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter
from typing import Dict, List, Tuple

from benchmark import trace as tr

#: the trace's categories of CUDA runtime and driver calls
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: the calls that block the calling thread until the card has run what
#: was enqueued before them (a ``cudaMemcpy`` without ``Async`` too; a
#: blocking ``tensor.to`` or ``.item()`` is a ``cudaMemcpyAsync`` and a
#: ``cudaStreamSynchronize``)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")
#: the harness's span around ``process_frame``
LOOP = "bench.loop"
#: the collector's passes
GC = "bench.gc"


def runtime_calls(events: List[dict], w0: float, w1: float
                  ) -> List[Tuple[float, float, str, object]]:
    """(ts, dur, name, thread) of the runtime and driver calls that start
    in [w0, w1) (us), in time order."""
    return sorted((e["ts"], e["dur"], e["name"], e.get("tid"))
                  for e in events if e.get("cat") in RUNTIME_CATS
                  and w0 <= e["ts"] < w1)


def _ranges(events: List[dict], name: str):
    return [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
            if e.get("name") == name and e.get("cat") == "user_annotation"]


def loop_calls(events: List[dict], n: int) -> Dict[str, float]:
    """Runtime calls a frame by name that start inside a ``bench.loop``
    range, on that range's thread, over ``n`` frames."""
    count = Counter()
    for t0, t1, tid in _ranges(events, LOOP):
        count.update(name for _, _, name, t in runtime_calls(events, t0, t1)
                     if t == tid)
    return {k: v / n for k, v in sorted(count.items())}


def loop_syncs(events: List[dict], n: int) -> float:
    """Synchronising calls (``SYNC_CALLS``) a frame that start inside a
    ``bench.loop`` range on its thread."""
    calls = loop_calls(events, n)
    return sum(calls.get(k, 0.0) for k in SYNC_CALLS)


def syncs_by_loop(events: List[dict]) -> List[Dict[str, int]]:
    """Each ``bench.loop`` range's synchronising calls by name, in time
    order."""
    return [dict(Counter(name for _, _, name, t
                         in runtime_calls(events, t0, t1)
                         if t == tid and name in SYNC_CALLS))
            for t0, t1, tid in sorted(_ranges(events, LOOP))]


def gap_calls(summary: tr.Summary, events: List[dict]) -> List[dict]:
    """For each idle gap of ``summary``'s breakdown, in its order: its
    length (ms), the innermost range open at its middle (the breakdown's
    name), the ms of it that ``bench.gc`` ranges cover, and the five
    runtime calls that overlap it most, each [name, ms of overlap, ms
    long]."""
    calls = runtime_calls(events, float("-inf"), float("inf"))
    gcs = [(t0, t1) for t0, t1, _ in _ranges(events, GC)]
    out = []
    names = summary.breakdown()["idle_gaps"]
    # the breakdown's gaps: the longest, in its order
    for (a, b), (name, _) in zip(
            sorted(summary.gaps, key=lambda g: g[0] - g[1]), names):
        over = sorted(((min(ts + d, b) - max(ts, a), d, k)
                       for ts, d, k, _ in calls if ts < b and ts + d > a),
                      reverse=True)[:5]
        gc_us = tr.union_us([(max(t0, a), min(t1, b)) for t0, t1 in gcs
                             if t0 < b and t1 > a])
        out.append(dict(range=name, ms=(b - a) / 1e3, gc_ms=gc_us / 1e3,
                        calls=[[k, o / 1e3, d / 1e3] for o, d, k in over]))
    return out


def main(argv=None) -> int:
    """``benchmark.run``'s traced run of a cell with the collector's
    passes as ranges; the extra line after its result."""
    # run.main's settings, made before the harness imports torch
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    from benchmark import harness, run

    kept = {}
    real_export, real_clock = tr.export_and_read, harness.GcClock

    class TracedGcClock(real_clock):
        """The harness's collector clock, each pass also a ``bench.gc``
        range while the profiler runs."""

        _range = None

        def __call__(self, phase, info):
            if phase == "start" and torch.autograd._profiler_enabled():
                self._range = torch.profiler.record_function(GC)
                self._range.__enter__()
            super().__call__(phase, info)
            if phase == "stop" and self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None

    def export_and_keep(prof, tmp_dir):
        kept["events"] = real_export(prof, tmp_dir)
        return kept["events"]

    argv = list(sys.argv[1:] if argv is None else argv)
    tr.export_and_read, harness.GcClock = export_and_keep, TracedGcClock
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        tr.export_and_read, harness.GcClock = real_export, real_clock
    if rc or "events" not in kept:
        return rc or 1
    events, n = kept["events"], harness.TRACE_FRAMES
    summary = tr.Summary(events, n)
    gcs = [t1 - t0 for t0, t1, _ in _ranges(events, GC)]
    print(json.dumps(dict(
        loop_syncs=loop_syncs(events, n), loop_calls=loop_calls(events, n),
        syncs_by_loop=syncs_by_loop(events),
        gc=dict(passes=len(gcs), ms=sum(gcs) / 1e3,
                longest_ms=max(gcs, default=0.0) / 1e3),
        gap_calls=gap_calls(summary, events))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
