"""The exit codes' evaluation after each solve, ms a cycle: the
`exit_codes` span of the program's Profiler (residual and cost of the final
iterates, enqueued), total over the window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.ms_per_cycle(run, ["exit_codes"])
