"""decode.rows.s_per_compare: self time of the program's span
"decode.rows", the per-bucket build of k-mer rows (decode_bucket_pairs), per comparison in the traced window, s."""

from benchmark.spans import self_s_per_call


def read(run):
    return self_s_per_call(run, "decode.rows")
