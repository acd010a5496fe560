"""parse.ms_per_mbase: the program's phase "parse" (summed over its threads)
per million bases sketched in the window, ms."""

from benchmark.readings import phase_ms_per_mbase


def read(run):
    return phase_ms_per_mbase(run, "parse")
