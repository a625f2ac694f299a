"""Scoped wall-clock profiling of the planner's phases.

Counterpart of mpc_planner_tpu/utils/profiling.py (ref ros_tools
PROFILE_SCOPE / Benchmarker, planner.cpp:69-75). Differences: each
`Planner` owns its `Profiler` (no process-wide instance), the per-scope
sample window is bounded, and a scope records its time even when the
body raises.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time
from typing import Dict


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

    @contextlib.contextmanager
    def scope(self, name: str):
        """Time the body on the host clock; recorded on normal exit and
        on an exception alike. Device work the body enqueues is included
        only up to the body's own synchronisation points."""
        start = time.perf_counter()
        try:
            yield
        finally:
            stats = self.stats.get(name)
            if stats is None:
                stats = self.stats[name] = ScopeStats(self._window)
            stats.add(time.perf_counter() - start)

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
