"""The card: its presence, its name and power limit, its memory peak, and the
reduction of a torch.profiler trace to busy time, kernel sums and idle gaps.

Nothing here falls back to the CPU: a run without a card stops before it
measures anything.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import torch


class NoCard(RuntimeError):
    pass


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("CUDA is not available: the benchmark runs only on the card")
    if torch.cuda.device_count() < count:
        raise NoCard(f"the cell needs {count} card(s), {torch.cuda.device_count()} found")


def card_text() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_record(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                     for i in range(count))}


class DeviceTrace:
    """torch.profiler over the measured window, CUDA activity only (the
    device's operations and their launches), read from the raw kineto
    events so that a window of a million kernels reduces in seconds."""

    def __init__(self):
        self._prof = None
        self.start_pc = self.end_pc = 0.0
        self._wall_ns = self._mono_ns = self._pc_ns = 0
        self.kernels: List[Tuple[str, int, int]] = []  # (name, start ns, end ns) on the perf clock

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._wall_ns, self._mono_ns = time.time_ns(), time.monotonic_ns()
        self._pc_ns = time.perf_counter_ns()
        self.start_pc = self._pc_ns / 1e9
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.end_pc = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._collect()
        return False

    def _collect(self) -> None:
        events = self._prof.profiler.kineto_results.events()
        rows = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1e3)
            rows.append((e.name(), int(start), int(dur)))
        if not rows:
            self.kernels = []
            return
        # The trace's clock: the wall clock or the monotonic one, whichever
        # its first event lies nearer; mapped onto perf_counter nanoseconds.
        first = min(r[1] for r in rows)
        if abs(first - self._wall_ns) < abs(first - self._mono_ns):
            offset = self._pc_ns - self._wall_ns
        else:
            offset = self._pc_ns - self._mono_ns
        self.kernels = [(n, s + offset, s + offset + d) for n, s, d in rows]

    @property
    def window_s(self) -> float:
        return self.end_pc - self.start_pc

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the operations' intervals inside the window, sorted,
        in perf ns."""
        out: List[List[int]] = []
        lo, hi = int(self.start_pc * 1e9), int(self.end_pc * 1e9)
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        for n, s, e in self.kernels:
            sums[n] = sums.get(n, 0.0) + (e - s) / 1e9
        return sums

    def seconds_matching(self, fragment: str) -> float:
        return sum(v for k, v in self.kernel_seconds().items() if fragment in k)

    def idle_gaps(self, scopes: Sequence[Tuple[str, float, float]], top: int = 10):
        """The `top` longest gaps between device operations inside the
        window, each named by the innermost host scope that holds its
        midpoint (scopes: (name, start s, end s) on perf_counter)."""
        busy = self.busy_intervals()
        lo, hi = int(self.start_pc * 1e9), int(self.end_pc * 1e9)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        out = []
        for dur, a, b in gaps[:top]:
            mid = (a + b) / 2e9
            name, width = "outside_scopes", float("inf")
            for sname, s, e in scopes:
                if s <= mid <= e and e - s < width:
                    name, width = sname, e - s
            out.append([name, dur / 1e9])
        return out

    def top_ops(self, top: int = 10):
        sums = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])[:top]
        return [[_short(k), v] for k, v in sums]


def _short(name: str, width: int = 64) -> str:
    out = "".join(c if c.isalnum() or c in "_.-" else "_" for c in name)
    return out[:width]
