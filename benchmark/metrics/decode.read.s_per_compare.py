"""decode.read.s_per_compare: self time of the program's span
"decode.read", opening and inflating each sketch (SketchFile), per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.read")
