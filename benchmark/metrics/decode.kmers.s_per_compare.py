"""decode.kmers.s_per_compare: self time of the program's span
"decode.kmers", the canonical k-mers of every row window (canonical_kmers), per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.kmers")
