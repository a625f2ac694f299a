"""Device-to-host reads a cycle: the program's `host_syncs` counter (one
for each `Profiler.pull`) over the window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.per_cycle(run, ["host_syncs"])
