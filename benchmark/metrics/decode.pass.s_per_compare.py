"""decode.pass.s_per_compare: self time of the program's span
"decode.pass", the native pass that decodes each sketch's buckets to its distinct k-mers, per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.pass")
