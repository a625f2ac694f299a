"""K3 launches a planner cycle (the port's cuda_qp.launch_counts["rti"] over
the window): 1 a cycle, and one more for each escalation."""


def read(run):
    if run["driver"] != "closed_loop" or not run["cycles"]:
        return None
    return run["k3_launches"] / run["cycles"]
