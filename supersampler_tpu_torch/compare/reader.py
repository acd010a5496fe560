"""Sketch decoding: sketch bytes -> (minimizer, canonical k-mer) pair
arrays.

The one module of the comparator that knows the sketch format, with the
native pass. Replicates the reference's bucket decode (reference
Comparator.cpp:78-92 inject_minimizer, 97-264 rolling k-mer extraction
+ canonize) in one native pass over a byte window of whole buckets
(native.py ``decode_pairs_native``, C
``supersampler_tpu_torch/csrc/spsp_decode.c``): 2-bit blob unpack,
minimizer re-injection, rolling canonical k-mers as (hi, lo) uint64
pairs, the per-bucket dedup. The streaming comparator finds bucket
bounds with ``parse_bucket_at`` and hands its windows to the same
pass. The port's counterpart of supersampler_tpu/compare/reader.py.

A window is (data, pos0, end, k, m): the inflated sketch bytes
data[pos0:end], whole buckets, and the header's k and m.

Spans and counters (utils/profiling.py, in a profiler session):
``decode.read`` (open and inflate) and ``decode.pass`` (the native
pass); ``decode.windows`` (k-mer windows before the dedup) and
``decode.pairs`` (after it).
"""

from __future__ import annotations

import struct

import numpy as np

from supersampler_tpu_torch.core.scalar import NUC2INT_LUT
from supersampler_tpu_torch.io.fasta import open_maybe_gzip
from supersampler_tpu_torch.native import decode_pairs_native
from supersampler_tpu_torch.utils.profiling import count, phase


def parse_header(data: bytes):
    """The header line that starts a sketch's inflated bytes (super-k-mer
    size, m, ...). Returns (k, m, offset of the first bucket); raises
    ValueError when data holds no whole line."""
    nl = data.index(b"\n")
    parts = data[:nl].split(b" ")
    m = int(parts[1])
    return (int(parts[0]) + m) // 2, m, nl + 1


def parse_bucket_at(data: bytes, pos: int, m: int):
    """Find the bounds of ONE raw bucket at byte ``pos`` of a
    decompressed sketch (wire format: m ASCII minimizer chars, u32 LE
    blob size, blob, plaintext line pairs, blank-pair terminator —
    reference SubSampler.cpp:456-504). Returns (minimizer, end,
    payload bytes): the payload is the blob's size plus the lines'
    lengths. Copies neither.

    Raises ValueError/struct.error/IndexError when ``data`` does not
    contain the whole bucket — streaming callers extend their window
    and retry."""
    minstr = data[pos : pos + m]
    if len(minstr) < m:
        raise ValueError("short window")
    (size,) = struct.unpack_from("<I", data, pos + m)
    pos += m + 4 + size
    if pos > len(data):
        raise ValueError("short window")
    payload = size
    while True:
        nl2 = data.index(b"\n", data.index(b"\n", pos) + 1)
        if nl2 == pos + 1:          # the blank pair
            break
        payload += nl2 - pos - 1    # both lines, less their newlines
        pos = nl2 + 1
    mval = 0
    for c in NUC2INT_LUT[np.frombuffer(minstr, dtype=np.uint8)]:
        mval = (mval << 2) | int(c)
    return mval, nl2 + 1, payload


def read_sketch(path: str):
    """The window of a whole sketch's buckets, read and inflated inside
    ``decode.read``."""
    with phase("decode.read"):
        with open_maybe_gzip(path) as f:
            data = f.read()
        k, m, pos0 = parse_header(data)
    return data, pos0, len(data), k, m


def decode_window(data: bytes, pos0: int, end: int, k: int, m: int):
    """The native pass over the buckets of data[pos0:end], with its
    counters: distinct (mins, hi, lo) pairs, deduplicated per
    (minimizer, kmer) as the reference's per-bucket color/skip maps do
    (Comparator.cpp:97-264), and the bucket minimizers."""
    with phase("decode.pass"):
        mins, his, los, bmins, windows = decode_pairs_native(data, pos0,
                                                             end, k, m)
    count("decode.windows", windows)
    count("decode.pairs", mins.size)
    return mins, his, los, bmins


def decode_sketch_pairs(path: str):
    """Decode a whole sketch to distinct (minimizer, kmer_hi, kmer_lo)
    arrays. Returns (mins u64[], hi u64[], lo u64[], k, m,
    minimizer_set)."""
    window = read_sketch(path)
    mins, his, los, bmins = decode_window(*window)
    return mins, his, los, window[3], window[4], set(bmins.tolist())
