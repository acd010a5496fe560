"""Reads a sketch as the tool writes it, to judge it against the plain
reference (sketch.py).

Layout (SubSampler.cpp:456-504): a header line "2k-m m kept s"; then per
bucket, in ascending minimizer order, the minimizer's m bases, a u32
little-endian blob size, the blob (strCompressor, utils.cpp:48-68: a
byte len % 4, then four bases a byte, most significant first, and a
last partial byte shifted once more) holding the maximal super-k-mers
as their (k - m)-base left and right halves, then one "left\\nright\\n"
line pair per other super-k-mer, split at the minimizer's first
occurrence, and an empty pair "\\n\\n" to close the bucket. The minimizer
sits between the halves. Every k-mer of every super-k-mer is one
written (minimizer, oriented k-mer) pair.
"""

from __future__ import annotations

import struct

import numpy as np

_CODE = np.array([(c >> 1) & 3 for c in range(256)], dtype=np.int64)


def _unpack_blob(blob: bytes) -> np.ndarray:
    if not blob:
        return np.zeros(0, np.int64)
    b = np.frombuffer(blob, dtype=np.uint8).astype(np.int64)
    mod = int(b[0])
    full = b[1:] if mod == 0 else b[1:-1]
    out = np.stack([(full >> 6) & 3, (full >> 4) & 3, (full >> 2) & 3,
                    full & 3], 1).reshape(-1)
    if mod:
        last = int(b[-1])
        tail = [(last >> (2 * (mod - j))) & 3 for j in range(mod)]
        out = np.concatenate([out, np.asarray(tail, np.int64)])
    return out


def _kmers(rows: np.ndarray, k: int) -> np.ndarray:
    """Every k-mer value of each row of codes, (n, L - k + 1)."""
    n, L = rows.shape
    v = np.zeros(n, np.int64)
    mask = (1 << (2 * k)) - 1
    out = np.empty((n, L - k + 1), np.int64)
    for t in range(L):
        v = ((v << 2) | rows[:, t]) & mask
        if t >= k - 1:
            out[:, t - k + 1] = v
    return out


def decode(raw: bytes):
    """(pairs, kept, k, m): the sorted unique (minimizer, k-mer) rows
    the sketch writes, its header's kept count, k and m. Raises
    ValueError on a sketch it cannot read to its end."""
    nl = raw.index(b"\n")
    head = raw[:nl].split(b" ")
    width, m, kept = int(head[0]), int(head[1]), int(head[2])
    k = (width + m) // 2
    half = k - m
    pos = nl + 1
    groups = {}                   # super-k-mer length -> (mins, rows)
    n = len(raw)
    while pos < n:
        if pos + m + 4 > n:
            raise ValueError(f"sketch cut inside a bucket at byte {pos}")
        mcodes = _CODE[np.frombuffer(raw, np.uint8, m, pos)]
        mval = 0
        for x in mcodes.tolist():
            mval = (mval << 2) | x
        pos += m
        (size,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        codes = _unpack_blob(raw[pos : pos + size])
        pos += size
        n_max = codes.size // (2 * half) if half else 0
        if n_max:
            h = codes[: n_max * 2 * half].reshape(n_max, 2 * half)
            rows = np.concatenate([h[:, :half], np.tile(mcodes, (n_max, 1)),
                                   h[:, half:]], 1)
            g = groups.setdefault(rows.shape[1], ([], []))
            g[0].append(np.full(n_max, mval, np.int64))
            g[1].append(rows)
        while True:
            e1 = raw.index(b"\n", pos)
            e2 = raw.index(b"\n", e1 + 1)
            left, right = raw[pos:e1], raw[e1 + 1 : e2]
            pos = e2 + 1
            if not left and not right:
                break
            row = np.concatenate([_CODE[np.frombuffer(left, np.uint8)],
                                  mcodes,
                                  _CODE[np.frombuffer(right, np.uint8)]])
            if row.size < k:
                raise ValueError("a super-k-mer shorter than k")
            g = groups.setdefault(row.size, ([], []))
            g[0].append(np.asarray([mval], np.int64))
            g[1].append(row[None, :])
    parts = []
    for mins, rows in groups.values():
        km = _kmers(np.concatenate(rows), k)
        mv = np.repeat(np.concatenate(mins), km.shape[1])
        parts.append(np.stack([mv, km.reshape(-1)], 1))
    if not parts:
        return np.zeros((0, 2), np.int64), kept, k, m
    pairs = np.unique(np.concatenate(parts), axis=0)
    return pairs, kept, k, m


def pair_gaps(got: np.ndarray, want: np.ndarray):
    """(missing, extra): rows of want not in got, rows of got not in
    want (both sorted unique (n, 2) int64)."""
    def keys(a):
        return a.view([("a", np.int64), ("b", np.int64)]).reshape(-1)
    g, w = keys(np.ascontiguousarray(got)), keys(np.ascontiguousarray(want))
    common = np.intersect1d(g, w).size
    return int(w.size - common), int(g.size - common)
