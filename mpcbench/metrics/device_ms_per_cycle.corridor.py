"""Device time a planner cycle, ms: the union of the device's operations in
the traced window over its cycles."""


def read(run):
    trace = run["trace"]
    if trace is None or run["driver"] != "closed_loop" or not run["cycles"]:
        return None
    busy = trace.busy_s()
    return 1e3 * busy / run["cycles"] if busy > 0 else None
