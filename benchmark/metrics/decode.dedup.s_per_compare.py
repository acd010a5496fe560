"""decode.dedup.s_per_compare: self time of the program's span
"decode.dedup", the per-bucket dedup of the k-mers (lexsort, keep mask), per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.dedup")
