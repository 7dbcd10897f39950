"""Named stage timers — a copy of ``dynslam_tpu/utils/timers.py``, the
reference's `utils::Timers` registry
(Utils.h:183-247) with Tic/Toc/TocMicro semantics, plus an FPS report.

Used by the pipeline to produce the per-stage timing narration the
reference prints each frame ("Semantic segmentation took Xms",
"[Finished frame N in X ms @ Y FPS]", DynSLAMGUI.cpp:923-930).

Note: like the reference, the registry is not thread-safe by design
(Utils.cpp:109,119); it is only touched from the host orchestration
thread. For device work the caller must synchronise before Toc for meaningful
numbers, since CUDA launches are asynchronous.
"""

from __future__ import annotations

import time
from typing import Dict, List


class _Timer:
    __slots__ = ("name", "start_ns", "elapsed_ns", "count", "total_ns")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = 0
        self.elapsed_ns = 0
        self.count = 0
        self.total_ns = 0


class Timers:
    """Global named-timer registry with a stack of active timers."""

    def __init__(self):
        self._timers: Dict[str, _Timer] = {}
        self._stack: List[str] = []

    def tic(self, name: str) -> None:
        t = self._timers.setdefault(name, _Timer(name))
        t.start_ns = time.perf_counter_ns()
        self._stack.append(name)

    def toc(self, name: str | None = None) -> float:
        """Stop a timer, return elapsed milliseconds."""
        return self.toc_micro(name) / 1000.0

    def toc_micro(self, name: str | None = None) -> float:
        """Stop a timer, return elapsed microseconds."""
        if name is None:
            if not self._stack:
                raise RuntimeError("toc() with no active timer")
            name = self._stack[-1]
        if name in self._stack:
            # pop through (allows toc of an outer timer to discard inner ones,
            # matching the reference's stack semantics)
            while self._stack and self._stack[-1] != name:
                self._stack.pop()
            if self._stack:
                self._stack.pop()
        t = self._timers.get(name)
        if t is None:
            raise KeyError(f"unknown timer: {name}")
        t.elapsed_ns = time.perf_counter_ns() - t.start_ns
        t.count += 1
        t.total_ns += t.elapsed_ns
        return t.elapsed_ns / 1000.0

    def latest_ms(self, name: str) -> float:
        return self._timers[name].elapsed_ns / 1e6

    def mean_ms(self, name: str) -> float:
        t = self._timers[name]
        return (t.total_ns / max(t.count, 1)) / 1e6

    def count(self, name: str) -> int:
        return self._timers[name].count

    def names(self) -> List[str]:
        return list(self._timers)

    def report(self) -> str:
        lines = []
        for name, t in sorted(self._timers.items()):
            mean_ms = (t.total_ns / max(t.count, 1)) / 1e6
            lines.append(
                f"{name:<32s} last {t.elapsed_ns / 1e6:8.2f} ms  "
                f"mean {mean_ms:8.2f} ms  n={t.count}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._timers.clear()
        self._stack.clear()


_GLOBAL = Timers()


def tic(name: str) -> None:
    _GLOBAL.tic(name)


def toc(name: str | None = None) -> float:
    return _GLOBAL.toc(name)


def toc_micro(name: str | None = None) -> float:
    return _GLOBAL.toc_micro(name)


def global_timers() -> Timers:
    return _GLOBAL
