"""The solve and its dispatch, ms a cycle: the `optimization` scope of
Planner.profiler (for T-MPC++ the host assembly, dispatch, solve, pull and
escalation), total over the window's cycles."""


def read(run):
    s = run["scopes"]
    if run["driver"] != "closed_loop" or "optimization" not in s or not run["cycles"]:
        return None
    return 1e3 * s["optimization"][0] / run["cycles"]
