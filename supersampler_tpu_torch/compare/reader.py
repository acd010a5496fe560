"""Sketch decoding: sketch file -> (minimizer, canonical k-mer) pair
arrays.

Replicates the reference's bucket decode (reference Comparator.cpp:78-92
inject_minimizer, 97-264 rolling k-mer extraction + canonize) in one
native pass a sketch (native.py ``decode_pairs_native``, C
``supersampler_tpu_torch/csrc/spsp_decode.c``): 2-bit blob unpack,
minimizer re-injection, rolling canonical k-mers as (hi, lo) uint64
pairs, the per-bucket dedup. The wire parse of one bucket stays in
Python for the streaming comparator. The port's counterpart of
supersampler_tpu/compare/reader.py.

Spans and counters (utils/profiling.py, in a profiler session):
``decode.read`` (open and inflate) and ``decode.pass`` (the native
pass); ``decode.windows`` (k-mer windows before the dedup) and
``decode.pairs`` (after it).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from supersampler_tpu_torch.core.scalar import NUC2INT_LUT
from supersampler_tpu_torch.io.fasta import open_maybe_gzip
from supersampler_tpu_torch.native import decode_pairs_native
from supersampler_tpu_torch.utils.profiling import count, phase

U64 = np.uint64
_ACTG = np.frombuffer(b"ACTG", dtype=np.uint8)


def parse_bucket_at(data: bytes, pos: int, m: int):
    """Parse ONE raw bucket at byte ``pos`` of a decompressed sketch
    (wire format: m ASCII minimizer chars, u32 LE blob size, blob,
    plaintext line pairs, blank-pair terminator — reference
    SubSampler.cpp:456-504). Returns ((mval, blob, lines), end_pos).

    Raises ValueError/struct.error/IndexError when ``data`` does not
    contain the whole bucket — streaming callers extend their window
    and retry; whole-file callers never hit it on a valid sketch."""
    minstr = data[pos : pos + m]
    if len(minstr) < m:
        raise ValueError("short window")
    pos += m
    (size,) = struct.unpack_from("<I", data, pos)
    pos += 4
    blob = data[pos : pos + size]
    if len(blob) < size:
        raise ValueError("short window")
    pos += size
    lines: List[bytes] = []
    while True:
        nl1 = data.index(b"\n", pos)
        l1 = data[pos:nl1]
        pos = nl1 + 1
        nl2 = data.index(b"\n", pos)
        l2 = data[pos:nl2]
        pos = nl2 + 1
        if not l1 and not l2:
            break
        lines.append(l1)
        lines.append(l2)
    mcodes = NUC2INT_LUT[np.frombuffer(minstr, dtype=np.uint8)]
    mval = 0
    for c in mcodes:
        mval = (mval << 2) | int(c)
    return (mval, blob, lines), pos


class SketchFile:
    """A sketch read whole: its header and inflated bytes, the buckets
    from ``pos0`` on."""

    def __init__(self, path: str):
        with open_maybe_gzip(path) as f:
            self.data = f.read()
        nl = self.data.index(b"\n")
        parts = self.data[:nl].split(b" ")
        self.skmer_size_hdr = int(parts[0])
        self.m = int(parts[1])
        self.nb_kmer_tot = int(parts[2])
        self.sub_rate = int(float(parts[3]))
        self.k = (self.skmer_size_hdr + self.m) // 2
        self.pos0 = nl + 1


def _decode_pass(data: bytes, pos0: int, k: int, m: int):
    """The native pass over the buckets of data[pos0:], with its
    counters: (mins, hi, lo, bucket minimizers)."""
    with phase("decode.pass"):
        mins, his, los, bmins, windows = decode_pairs_native(data, pos0, k,
                                                             m)
    count("decode.windows", windows)
    count("decode.pairs", mins.size)
    return mins, his, los, bmins


def decode_bucket_pairs(buckets, k: int, m: int):
    """Raw (mval, blob, lines) buckets, as parse_bucket_at gives them ->
    distinct (minimizer u64[], kmer_hi u64[], kmer_lo u64[]) pair
    arrays, deduplicated per (minimizer, kmer) as the reference's
    per-bucket color/skip maps do (Comparator.cpp:97-264). For the
    chunked comparator (compare/stream.py): the buckets are framed as
    wire bytes again and go through the whole-file decode's native
    pass."""
    parts = []
    if buckets:
        mvals = np.array([b[0] for b in buckets], dtype=U64)
        shifts = np.arange(2 * (m - 1), -1, -2, dtype=U64)
        chars = _ACTG[(mvals[:, None] >> shifts) & U64(3)]
        for row, (_mval, blob, lines) in zip(chars, buckets):
            parts += [row.tobytes(), struct.pack("<I", len(blob)), blob]
            parts += [b"\n".join(lines), b"\n\n\n" if lines else b"\n\n"]
    mins, his, los, _ = _decode_pass(b"".join(parts), 0, k, m)
    return mins, his, los


def decode_sketch_pairs(path: str):
    """Decode a whole sketch to distinct (minimizer, kmer_hi, kmer_lo)
    arrays. Returns (mins u64[], hi u64[], lo u64[], k, m,
    minimizer_set)."""
    with phase("decode.read"):
        sk = SketchFile(path)
    mins, his, los, bmins = _decode_pass(sk.data, sk.pos0, sk.k, sk.m)
    return mins, his, los, sk.k, sk.m, set(bmins.tolist())
