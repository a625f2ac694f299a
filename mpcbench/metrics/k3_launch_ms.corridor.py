"""K3's host launch, ms a cycle: the `k3_launch` span of the program's
Profiler (library lookup, argument checks, output allocation, the ctypes
launch), total over the window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.ms_per_cycle(run, ["k3_launch"])
