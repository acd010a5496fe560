"""decode.s_per_compare: seconds in the comparator's decode step (the entry's
span around it) per comparison in the traced window."""

from benchmark.readings import span_s_per_call


def read(run):
    return span_s_per_call(run, "decode")
