"""decode.buckets.s_per_compare: self time of the program's span
"decode.buckets", the walk over each sketch's buckets (iter_buckets), per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.buckets")
