"""finish.ms_per_mbase: the C finisher, the program's phases "assemble"
and "serialize", per million bases sketched in the window, ms."""

from benchmark.readings import phase_ms_per_mbase


def read(run):
    return phase_ms_per_mbase(run, "assemble", "serialize")
