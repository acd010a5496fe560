"""group.sort.s_per_compare: self time of the program's span
"group.sort", the lexsort of every decoded pair by (minimizer, k-mer,
file) and its gathers, per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "group.sort")
