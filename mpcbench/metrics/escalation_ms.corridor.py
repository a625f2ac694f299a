"""The in-cycle cold re-solves, ms a cycle: the `tmpc_escalation` and
`solve_batch_escalation` spans of the program's Profiler, total over the
window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.ms_per_cycle(run, ["tmpc_escalation", "solve_batch_escalation"])
