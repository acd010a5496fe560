"""decode.pairs_per_window: the program's counter "decode.pairs" (the
distinct (minimizer, k-mer) pairs the dedup keeps) over "decode.windows"
(the k-mer windows before it) in the traced window: the share of the
k-mer work that is kept."""

from benchmark.spans import counter_total


def read(run):
    pairs = counter_total(run, "decode.pairs")
    windows = counter_total(run, "decode.windows")
    if not pairs or not windows:
        return None
    return pairs / windows
