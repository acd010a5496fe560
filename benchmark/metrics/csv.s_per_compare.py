"""csv.s_per_compare: self time of the program's spans "compare.csv",
the containment and Jaccard CSV texts, per comparison in the traced
window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "compare.csv")
