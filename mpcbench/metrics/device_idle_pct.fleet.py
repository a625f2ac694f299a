"""The share of the traced window in which no operation ran on the card, %,
in the fleet."""


def read(run):
    trace = run["trace"]
    if trace is None or run["driver"] != "fleet" or trace.window_s <= 0:
        return None
    busy = trace.busy_s()
    return 100.0 * (1.0 - busy / trace.window_s) if busy > 0 else None
