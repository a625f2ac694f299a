"""Scoped wall-clock profiling of the planner's phases.

Counterpart of mpc_planner_tpu/utils/profiling.py (ref ros_tools
PROFILE_SCOPE / Benchmarker, planner.cpp:69-75): running stats per scope
and, with `record_trace`, a chrome-tracing export. Differences: each
`Planner` owns its `Profiler` (no process-wide instance), the per-scope
sample window is bounded, and a scope records its time even when the
body raises.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import time
from typing import Dict, List


class ScopeStats:
    """Running stats of one scope; `samples` keeps the newest `window`."""

    __slots__ = ("count", "total", "min", "max", "last", "samples")

    def __init__(self, window: int = 1000):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self.last = 0.0
        self.samples: collections.deque = collections.deque(maxlen=window)

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        self.last = dt
        self.samples.append(dt)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def median(self) -> float:
        """Median of the retained window."""
        return statistics.median(self.samples) if self.samples else 0.0


class Profiler:
    def __init__(self, window: int = 1000):
        self._window = window
        self.stats: Dict[str, ScopeStats] = {}
        # With record_trace, each scope's span as a chrome-tracing complete
        # event, in microseconds from the profiler's start (or last reset).
        self.events: List[dict] = []
        self.record_trace = False
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def scope(self, name: str):
        """Time the body on the host clock; recorded on normal exit and
        on an exception alike. Device work the body enqueues is included
        only up to the body's own synchronisation points."""
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            stats = self.stats.get(name)
            if stats is None:
                stats = self.stats[name] = ScopeStats(self._window)
            stats.add(dt)
            if self.record_trace:
                self.events.append({"name": name, "ph": "X", "ts": (start - self._t0) * 1e6,
                                    "dur": dt * 1e6, "pid": 0, "tid": 0})

    def export_chrome_trace(self, path: str) -> None:
        """Chrome-tracing JSON like the reference's Instrumentor."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)

    def summary(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:24s} n={s.count:5d} mean={s.mean*1e3:8.2f}ms "
                f"median={s.median*1e3:8.2f}ms "
                f"min={s.min*1e3:8.2f}ms max={s.max*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self.events.clear()
        self._t0 = time.perf_counter()
