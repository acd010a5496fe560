"""compare_s: the window's seconds over the comparisons completed in
it."""

from benchmark.readings import window_s


def read(run):
    return window_s(run) / len(run.calls)
