"""Device-to-host reads, ms a cycle: the `pull.*` spans of the program's
Profiler, each of which waits for the work queued before it, total over
the window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.ms_per_cycle(run, prefix="pull.")
