"""Python's garbage collections, ms a cycle: the program's `gc` spans (one
per collection while tracing is on), total over the window's cycles."""

from mpcbench import program_spans


def read(run):
    return program_spans.ms_per_cycle(run, ["gc"])
