"""Vectorized sketch decoding: sketch file -> (minimizer, canonical k-mer)
pair arrays.

Replicates the reference's bucket decode (reference Comparator.cpp:78-92
inject_minimizer, 97-264 rolling k-mer extraction + canonize) with numpy
batch operations: 2-bit blob unpack, minimizer re-injection, rolling
k-mer windows as (hi, lo) uint64 pairs, reverse-complement via the
reversed-complemented code array. The port's copy of
supersampler_tpu/compare/reader.py.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

import numpy as np

from supersampler_tpu_torch.core.scalar import NUC2INT_LUT
from supersampler_tpu_torch.io.fasta import open_maybe_gzip
from supersampler_tpu_torch.utils.profiling import count, phase

U64 = np.uint64
_0 = U64(0)


def blob_to_codes(blob: bytes) -> np.ndarray:
    """Decode a strCompressor blob to 2-bit codes
    (inverse of reference utils.cpp:48-68; see core.scalar)."""
    if not blob:
        return np.zeros(0, dtype=np.uint8)
    b = np.frombuffer(blob, dtype=np.uint8)
    mod = int(b[0])
    last = len(b) if mod == 0 else len(b) - 1
    full = b[1:last]
    out = np.empty(full.size * 4 + mod, dtype=np.uint8)
    out[0 : full.size * 4 : 4] = (full >> 6) & 3
    out[1 : full.size * 4 : 4] = (full >> 4) & 3
    out[2 : full.size * 4 : 4] = (full >> 2) & 3
    out[3 : full.size * 4 : 4] = full & 3
    if mod:
        v = int(b[last])
        for j in range(mod):
            out[full.size * 4 + j] = (v >> (2 * (mod - j))) & 3
    return out


def rolling_kmers_u128(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All k-mer windows of each row of ``codes`` (2D: n x S) as
    (hi, lo) uint64 arrays of shape (n, S-k+1). Rolling update with mask,
    matching updateK (reference utils.cpp:752-757)."""
    n, S = codes.shape
    nw = S - k + 1
    hi = np.zeros(n, dtype=U64)
    lo = np.zeros(n, dtype=U64)
    out_hi = np.empty((n, nw), dtype=U64)
    out_lo = np.empty((n, nw), dtype=U64)
    if k > 32:
        hi_mask = U64((1 << (2 * k - 64)) - 1)
    c62 = U64(62)
    c2 = U64(2)
    for t in range(S):
        c = codes[:, t].astype(U64)
        hi = ((hi << c2) | (lo >> c62))
        lo = (lo << c2) | c
        if k > 32:
            hi &= hi_mask
        else:
            hi[:] = _0
            lo &= U64((1 << (2 * k)) - 1) if k < 32 else U64(0xFFFFFFFFFFFFFFFF)
        if t >= k - 1:
            out_hi[:, t - k + 1] = hi
            out_lo[:, t - k + 1] = lo
    return out_hi, out_lo


def canonical_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical (min of fwd/rc) k-mers for every window of each row."""
    fwd_hi, fwd_lo = rolling_kmers_u128(codes, k)
    rc_codes = (codes[:, ::-1] ^ 2).astype(np.uint8)
    rch, rcl = rolling_kmers_u128(rc_codes, k)
    # rc of fwd window t is rc window S-k-t: reverse the window axis.
    rc_hi = rch[:, ::-1]
    rc_lo = rcl[:, ::-1]
    take_rc = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
    hi = np.where(take_rc, rc_hi, fwd_hi)
    lo = np.where(take_rc, rc_lo, fwd_lo)
    return hi, lo


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
    """Parsed sketch: header + per-bucket raw payloads."""

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

    def iter_buckets(self) -> Iterator[Tuple[int, bytes, List[bytes]]]:
        """Yield (minimizer_value, blob_bytes, plaintext_lines) per bucket
        in file order (ascending minimizer)."""
        pos = self.pos0
        n = len(self.data)
        while pos + self.m <= n:
            bucket, pos = parse_bucket_at(self.data, pos, self.m)
            yield bucket


def decode_bucket_pairs(buckets, k: int, m: int):
    """Vectorized decode of raw (mval, blob, lines) buckets ->
    distinct (minimizer u64[], kmer_hi u64[], kmer_lo u64[]) pair
    arrays, deduplicated per (minimizer, kmer) as the reference's
    per-bucket color/skip maps do (Comparator.cpp:97-264).

    k-mer extraction is batched ACROSS buckets (all maximal
    super-k-mers share one row length; plaintext ones group by
    length), so the rolling-window cost is a handful of big numpy
    passes instead of thousands of tiny per-bucket ones. Shared by
    the whole-file decode below and the chunked streaming comparator
    (compare/stream.py)."""
    half = k - m
    bucket_minimizers: List[int] = []
    max_rows: List[np.ndarray] = []
    max_bids: List[np.ndarray] = []
    plain = {}   # row length -> (bids list, rows list)
    with phase("decode.rows"):
        for bid, (mval, blob, lines) in enumerate(buckets):
            bucket_minimizers.append(mval)
            mcodes = np.empty(m, dtype=np.uint8)
            v = mval
            for j in range(m - 1, -1, -1):
                mcodes[j] = v & 3
                v >>= 2
            codes = blob_to_codes(blob)
            n_sk = codes.size // (2 * half) if half > 0 else 0
            if n_sk > 0:
                halves = codes[: n_sk * 2 * half].reshape(n_sk, 2 * half)
                rows = np.concatenate(
                    [halves[:, :half],
                     np.broadcast_to(mcodes, (n_sk, m)),
                     halves[:, half:]], axis=1)
                max_rows.append(rows)
                max_bids.append(np.full(n_sk, bid, np.int64))
            for i in range(0, len(lines), 2):
                left = NUC2INT_LUT[np.frombuffer(lines[i], dtype=np.uint8)]
                right = NUC2INT_LUT[np.frombuffer(lines[i + 1],
                                                  dtype=np.uint8)]
                seq = np.concatenate([left, mcodes, right])
                if seq.size >= k:
                    bids, rows = plain.setdefault(seq.size, ([], []))
                    bids.append(bid)
                    rows.append(seq)

    bid_l: List[np.ndarray] = []
    his_l: List[np.ndarray] = []
    los_l: List[np.ndarray] = []
    with phase("decode.kmers"):
        if max_rows:
            rows = np.concatenate(max_rows)
            bids = np.concatenate(max_bids)
            hi, lo = canonical_kmers(rows, k)
            nw = hi.shape[1]
            bid_l.append(np.repeat(bids, nw))
            his_l.append(hi.ravel())
            los_l.append(lo.ravel())
        for size, (bids, rows) in plain.items():
            arr = np.stack(rows)
            hi, lo = canonical_kmers(arr, k)
            nw = hi.shape[1]
            bid_l.append(np.repeat(np.asarray(bids, np.int64), nw))
            his_l.append(hi.ravel())
            los_l.append(lo.ravel())

    with phase("decode.dedup"):
        if bid_l:
            bids = np.concatenate(bid_l)
            his = np.concatenate(his_l)
            los = np.concatenate(los_l)
            n_windows = his.size
            # global dedup per (bucket, kmer)
            order = np.lexsort((los, his, bids))
            bids, his, los = bids[order], his[order], los[order]
            keep = np.ones(his.size, dtype=bool)
            keep[1:] = ((bids[1:] != bids[:-1]) | (his[1:] != his[:-1])
                        | (los[1:] != los[:-1]))
            bids, his, los = bids[keep], his[keep], los[keep]
            mins = np.asarray(bucket_minimizers, dtype=U64)[bids]
        else:
            n_windows = 0
            mins = np.zeros(0, dtype=U64)
            his, los = mins.copy(), mins.copy()
    count("decode.windows", n_windows)
    count("decode.pairs", mins.size)
    return mins, his, los


def decode_sketch_pairs(path: str):
    """Decode a whole sketch to distinct (minimizer, kmer_hi, kmer_lo)
    arrays. Returns (mins u64[], hi u64[], lo u64[], k, m,
    minimizer_set)."""
    with phase("decode.read"):
        sk = SketchFile(path)
    with phase("decode.buckets"):
        buckets = list(sk.iter_buckets())
    mins, his, los = decode_bucket_pairs(buckets, sk.k, sk.m)
    return (mins, his, los, sk.k, sk.m,
            set(b[0] for b in buckets))
