"""sketch_mbases_s: bases of every call completed in the window, in
millions, over the window's seconds (whole calls only)."""

from benchmark.readings import bases, window_s


def read(run):
    return bases(run) / 1e6 / window_s(run)
