"""Host time of the planner around the solve, ms a cycle: the `planning`
scope of Planner.profiler less its `optimization` scope, totals over the
window's cycles."""


def read(run):
    s = run["scopes"]
    if run["driver"] != "closed_loop" or "planning" not in s or not run["cycles"]:
        return None
    return 1e3 * (s["planning"][0] - s.get("optimization", (0.0, 0))[0]) / run["cycles"]
