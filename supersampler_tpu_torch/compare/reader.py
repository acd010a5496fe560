"""Sketch decoding: sketch files -> (minimizer, canonical k-mer) pair
arrays.

The one module of the comparator that knows the sketch format, with the
native stages it drives (native.py, C in supersampler_tpu_torch/csrc/).
Replicates the reference's bucket decode (reference
Comparator.cpp:78-92 inject_minimizer, 97-264 rolling k-mer extraction
+ canonize) in two native calls a decode, each on up to 8 threads:

* the read (``read_sketches``, ``spsp_read.c``): every sketch opened,
  read and inflated, the bytes pooled in file order, then each header
  line parsed here (``parse_header``);
* the pass (``decode_pass``, ``spsp_decode.c``): every window of whole
  buckets at once, 2-bit blob unpack, minimizer re-injection, rolling
  canonical k-mers as (hi, lo) uint64 pairs, the per-bucket dedup,
  written into one set of concatenated pair arrays and file ids.

The streaming comparator finds bucket bounds with ``parse_bucket_at``
and hands its windows to the same pass. The port's counterpart of
supersampler_tpu/compare/reader.py.

A window is (data, pos0, end, k, m): the inflated sketch bytes
data[pos0:end], whole buckets, and the header's k and m.

Spans and counters (utils/profiling.py, in a profiler session), one of
each per read and per pass, whatever the number of files: ``decode.read``
(open and inflate) and ``decode.pass`` (the native pass);
``decode.read.threads`` and ``decode.pass.threads`` (the threads each
ran on), ``decode.inflated_bytes`` (the bytes read, inflated),
``decode.windows`` (k-mer windows before the dedup) and
``decode.pairs`` (after it).
"""

from __future__ import annotations

import struct

import numpy as np

from supersampler_tpu_torch.core.scalar import NUC2INT_LUT
from supersampler_tpu_torch.native import (decode_windows_native,
                                           read_files_native)
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


def read_sketches(paths):
    """The windows of whole sketches, read and inflated in one native
    call inside ``decode.read``: one window a file, in file order, each
    over its file's part of one buffer of their bytes. Raises for the
    first file, in order, that cannot be read or has no header what
    reading it alone with Python's open and gzip, then parse_header,
    raises: OSError (such as FileNotFoundError), EOFError for a gzip
    member cut short, gzip.BadGzipFile or zlib.error for bad gzip data,
    ValueError for no header line."""
    with phase("decode.read"):
        got = read_files_native(paths)
        windows = []
        for i, (status, start, end, line) in enumerate(zip(
                got.status.tolist(), got.offs[:-1].tolist(),
                got.offs[1:].tolist(), got.pos0.tolist())):
            if status:
                raise got.error(i, paths[i])
            data = got.pool[start:end]
            k, m, pos0 = parse_header(data[:line or None].tobytes())
            windows.append((data, pos0, end - start, k, m))
    count("decode.read.threads", got.threads)
    count("decode.inflated_bytes", got.pool.size)
    return windows


def read_sketch(path: str):
    """The window of a whole sketch's buckets (read_sketches of one)."""
    return read_sketches([path])[0]


def decode_pass(windows, fids, n_query: int):
    """The native pass over every window at once inside ``decode.pass``,
    with its counters: native.py ``decode_windows_native``'s Decoded,
    the distinct (mins, hi, lo) pairs of each window, deduplicated per
    (minimizer, kmer) as the reference's per-bucket color/skip maps do
    (Comparator.cpp:97-264), with fids, each window's file id, beside
    them, and the bucket minimizers of the first n_query windows."""
    with phase("decode.pass"):
        got = decode_windows_native(windows, fids, n_query)
    count("decode.pass.threads", got.threads)
    count("decode.windows", got.windows)
    count("decode.pairs", got.mins.size)
    return got


def decode_window(data, pos0: int, end: int, k: int, m: int):
    """The native pass over the buckets of data[pos0:end] alone: its
    distinct (mins, hi, lo) pairs and its bucket minimizers."""
    got = decode_pass([(data, pos0, end, k, m)], [0], 1)
    return got.mins, got.his, got.los, got.bmins


def decode_sketch_pairs(path: str):
    """Decode a whole sketch to distinct (minimizer, kmer_hi, kmer_lo)
    arrays. Returns (mins u64[], hi u64[], lo u64[], k, m,
    minimizer_set)."""
    window = read_sketch(path)
    mins, his, los, bmins = decode_window(*window)
    return mins, his, los, window[3], window[4], set(bmins.tolist())
