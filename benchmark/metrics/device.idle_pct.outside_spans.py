"""device.idle_pct.outside_spans: the share of the traced window in
which no operation ran on the device while a comparison was under way
(its root span ``compare.call`` open) but none of its layers' spans
was, %: the comparator's own host work that no layer names. The
harness's time between calls does not count."""

from benchmark.spans import idle_outside_spans_pct


def read(run):
    return idle_outside_spans_pct(run)
