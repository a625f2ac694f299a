"""The T-MPC++ guidance search, ms a cycle: the `guidance_update` scope of
Planner.profiler, total over the window's cycles."""


def read(run):
    s = run["scopes"]
    if run["driver"] != "closed_loop" or "guidance_update" not in s or not run["cycles"]:
        return None
    return 1e3 * s["guidance_update"][0] / run["cycles"]
