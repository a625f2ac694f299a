"""Per-cycle totals of the spans and counters that the port's Profiler
records inside its solve step (`k3_launch`, `exit_codes`, `pull.*`,
`host_syncs`, the escalations, `gc`), for the corridor's per-layer metrics.

A program whose Profiler keeps no `host_syncs` counter records none of
them: the reading is then None, and the line leaves the metric out. A
program that records them and never opened one of the named spans reads
0.0.
"""

from __future__ import annotations

from typing import Iterable, Optional


def per_cycle(run, names: Iterable[str] = (), prefix: Optional[str] = None):
    """The summed totals of the stats entries `names` (and those whose name
    starts with `prefix`) over the window's cycles, in the entries' unit."""
    s = run["scopes"]
    if run["driver"] != "closed_loop" or not run["cycles"] or "host_syncs" not in s:
        return None
    names = set(names)
    total = sum(v[0] for k, v in s.items()
                if k in names or (prefix is not None and k.startswith(prefix)))
    return total / run["cycles"]


def ms_per_cycle(run, names: Iterable[str] = (), prefix: Optional[str] = None):
    value = per_cycle(run, names, prefix)
    return None if value is None else 1e3 * value
