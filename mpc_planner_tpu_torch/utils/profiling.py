"""Scoped wall-clock profiling of the planner's phases.

Counterpart of mpc_planner_tpu/utils/profiling.py (ref ros_tools
PROFILE_SCOPE / Benchmarker, planner.cpp:69-75): running stats per scope
and, with `record_trace`, a chrome-tracing export. Differences: each
`Planner` owns its `Profiler` (no process-wide instance) and shares it with
its solver, the per-scope sample window is bounded, a scope records its
time even when the body raises, counters (`count`) sit beside the scopes,
every device-to-host read of the main path goes through `pull`, and a
Profiler built with `track_gc` records each garbage collection as a `gc`
span while `record_trace` is on.

Events are on `time.perf_counter`, in microseconds from `_t0` (the last
reset); `reset` also keeps the wall and monotonic clocks at that moment,
which the export writes under "otherData" so that a device trace on either
clock can be laid over the spans.
"""

from __future__ import annotations

import collections
import gc
import json
import statistics
import time
import weakref
from typing import Dict, List, Union


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


class CounterStats:
    """One counter: `total`, the sum of the counted amounts, over `count`
    calls."""

    __slots__ = ("count", "total")

    def __init__(self):
        self.count = 0
        self.total = 0

    def add(self, n: int) -> None:
        self.count += 1
        self.total += n


class _Scope:
    """The context manager of `Profiler.scope` (a class: half the cost of a
    generator-based one, paid on every scope with tracing on or off)."""

    __slots__ = ("_profiler", "_name", "_start")

    def __init__(self, profiler: "Profiler", name: str):
        self._profiler = profiler
        self._name = name

    def __enter__(self) -> None:
        self._start = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        self._profiler._record(self._name, self._start, time.perf_counter() - self._start)
        return False


def _gc_callback(profiler_ref):
    """A gc.callbacks entry that times each collection into the Profiler
    behind `profiler_ref`, holding it only weakly."""
    started = [0.0]

    def callback(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
            return
        prof = profiler_ref()
        if prof is not None:
            prof._record("gc", started[0], time.perf_counter() - started[0])

    return callback


def _remove_callback(callback) -> None:
    if callback in gc.callbacks:
        gc.callbacks.remove(callback)


class Profiler:
    def __init__(self, window: int = 1000, track_gc: bool = False):
        self._window = window
        self.stats: Dict[str, Union[ScopeStats, CounterStats]] = {}
        # With record_trace, each scope's span as a chrome-tracing complete
        # event, in microseconds from the profiler's start (or last reset).
        self.events: List[dict] = []
        # With record_trace, each count as a chrome-tracing counter event
        # (its running total); kept apart from the spans of `events`.
        self._counter_events: List[dict] = []
        self._record_trace = False
        self._gc_callback = None
        if track_gc:
            self._gc_callback = _gc_callback(weakref.ref(self))
            weakref.finalize(self, _remove_callback, self._gc_callback)
        self.reset()

    @property
    def record_trace(self) -> bool:
        return self._record_trace

    @record_trace.setter
    def record_trace(self, on: bool) -> None:
        """Turning tracing on installs the gc callback (track_gc only);
        turning it off removes it."""
        self._record_trace = bool(on)
        if self._gc_callback is None:
            return
        if self._record_trace:
            self._open_gc_entry()
            if self._gc_callback not in gc.callbacks:
                gc.callbacks.append(self._gc_callback)
        else:
            _remove_callback(self._gc_callback)

    def _open_gc_entry(self) -> None:
        # A collection can start while a caller iterates over `stats`: the
        # callback then finds its entry and never adds a key.
        self.stats.setdefault("gc", ScopeStats(self._window))

    def _record(self, name: str, start: float, dt: float) -> None:
        stats = self.stats.get(name)
        if stats is None:
            stats = self.stats[name] = ScopeStats(self._window)
        stats.add(dt)
        if self._record_trace:
            self.events.append({"name": name, "ph": "X", "ts": (start - self._t0) * 1e6,
                                "dur": dt * 1e6, "pid": 0, "tid": 0})

    def scope(self, name: str) -> "_Scope":
        """Time the body on the host clock; recorded on normal exit and
        on an exception alike. Device work the body enqueues is included
        only up to the body's own synchronisation points."""
        return _Scope(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` (a stats entry with `total` and
        `count`, beside the scopes)."""
        stats = self.stats.get(name)
        if stats is None:
            stats = self.stats[name] = CounterStats()
        stats.add(n)
        if self._record_trace:
            self._counter_events.append({
                "name": name, "ph": "C", "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": 0, "tid": 0, "args": {name: stats.total}})

    def pull(self, name: str, tensor):
        """The device-to-host read `tensor.cpu().numpy()`, timed as the span
        `pull.<name>` and counted in `host_syncs`: on the card it waits for
        the work queued before it."""
        with self.scope("pull." + name):
            out = tensor.cpu().numpy()
        self.count("host_syncs")
        return out

    def export_chrome_trace(self, path: str) -> None:
        """Chrome-tracing JSON like the reference's Instrumentor, with the
        counters as "C" events and the clock anchors of `_t0`."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events + self._counter_events,
                       "otherData": dict(self.clock_anchor)}, f)

    def summary(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            if isinstance(s, CounterStats):
                lines.append(f"{name:24s} n={s.count:5d} count={s.total}")
                continue
            lines.append(
                f"{name:24s} n={s.count:5d} mean={s.mean*1e3:8.2f}ms "
                f"median={s.median*1e3:8.2f}ms "
                f"min={s.min*1e3:8.2f}ms max={s.max*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self.events.clear()
        self._counter_events.clear()
        pc_ns = time.perf_counter_ns()
        self._t0 = pc_ns / 1e9
        self.clock_anchor = {"clock": "perf_counter", "unit": "us", "perf_counter_ns": pc_ns,
                             "time_ns": time.time_ns(), "monotonic_ns": time.monotonic_ns()}
        if self._record_trace and self._gc_callback is not None:
            self._open_gc_entry()
