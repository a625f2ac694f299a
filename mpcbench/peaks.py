"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit), and the roofline of a count of work."""

PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k3_work(run: dict):
    """(flops, bytes) that the window's solves need by the configuration's
    frozen count of K3's work per element solve: one solve per planner per
    cycle, cold where a cycle starts without carried duals, warm after; the
    escalations' second solves are not needed work."""
    work = run["config"]["k3_work"]
    cold, warm = work["cold"], work["warm"]
    if run["driver"] == "fleet":
        n_cold, n_warm = 0, run["cycles"] * run["robots"]
    else:
        batch = run["config"]["batch"]
        starts = run["episodes"] if run["config"]["duals_carried"] else run["cycles"]
        n_cold, n_warm = starts * batch, (run["cycles"] - starts) * batch
    return (n_cold * cold["flops"] + n_warm * warm["flops"],
            n_cold * cold["bytes"] + n_warm * warm["bytes"])


def k3_roofline_pct(run: dict):
    trace = run["trace"]
    if trace is None or run["cycles"] == 0:
        return None
    k3_s = trace.seconds_matching(run["config"]["k3_kernel"])
    if k3_s <= 0:
        return None
    return 100.0 * bound_s(*k3_work(run)) / k3_s
