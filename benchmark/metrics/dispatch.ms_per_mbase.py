"""dispatch.ms_per_mbase: the program's phase "dispatch" (summed over its threads)
per million bases sketched in the window, ms."""

from benchmark.readings import phase_ms_per_mbase


def read(run):
    return phase_ms_per_mbase(run, "dispatch")
