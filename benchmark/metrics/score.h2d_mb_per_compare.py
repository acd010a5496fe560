"""score.h2d_mb_per_compare: the program's counter "score.h2d_bytes",
the (group, file) coordinates copied to the device for the presence
product, per comparison in the traced window, MB."""

from benchmark.spans import counter_total


def read(run):
    n = counter_total(run, "score.h2d_bytes")
    return None if n is None else n / 1e6 / len(run.calls)
