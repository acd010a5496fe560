"""Mykkeltveit decycling-set membership (reference Decycling.cpp:1-51).

The port's copy of supersampler_tpu/core/decycling.py (numpy).

Present-but-disabled in the reference: the DecyclingSet is constructed
per Subsampler (SubSampler.h:64) and referenced only in dead code after
an early return in unrevhash (SubSampler.cpp:67-79), where it would
bias hash ordering so decycling-set m-mers win minimizer elections.
Provided for component parity; no sketch path calls it, as in the
reference.
"""

from __future__ import annotations

import math

import numpy as np

EPS = 0.0001  # reference Decycling.h epsilon


class DecyclingSet:
    def __init__(self, k: int):
        self.k = k
        self.unit = 2 * math.pi / k
        coef = [0.0] * (4 * k)
        for i in range(4, 4 * k, 4):
            s = math.sin(self.unit * (i // 4))
            coef[i + 1] = s
            coef[i + 2] = 2 * s
            coef[i + 3] = 3 * s
        self.coef = coef

    def compute_r(self, seq: int) -> float:
        r = 0.0
        for i in range(4 * (self.k - 1), 0, -4):
            r += self.coef[i + (seq & 0b11)]
            seq >>= 2
        return r

    def mem(self, seq: int) -> bool:
        if self.compute_r(seq) > EPS:
            rot = ((seq & 0b11) << (2 * (self.k - 1))) + (seq >> 2)
            return self.compute_r(rot) < EPS
        return False

    def mem_double(self, seq: int) -> int:
        r = self.compute_r(seq)
        if r > EPS:
            rot = ((seq & 0b11) << (2 * (self.k - 1))) + (seq >> 2)
            if self.compute_r(rot) < EPS:
                return 2
        elif r < -EPS:
            rot = ((seq & 0b11) << (2 * (self.k - 1))) + (seq >> 2)
            if self.compute_r(rot) > -EPS:
                return 1
        return 0


def compute_r_vec(seqs: np.ndarray, k: int) -> np.ndarray:
    """Vectorized compute_r over an array of 2k-bit m-mer codes."""
    d = DecyclingSet(k)
    coef = np.asarray(d.coef)
    r = np.zeros(seqs.shape, dtype=np.float64)
    s = seqs.astype(np.uint64).copy()
    for i in range(4 * (k - 1), 0, -4):
        r += coef[i + (s & 0b11).astype(np.int64)]
        s >>= np.uint64(2)
    return r


def mem_double_vec(seqs: np.ndarray, k: int) -> np.ndarray:
    """Vectorized memDouble classification (0/1/2)."""
    r = compute_r_vec(seqs, k)
    s = seqs.astype(np.uint64)
    rot = ((s & np.uint64(3)) << np.uint64(2 * (k - 1))) | (s >> np.uint64(2))
    rrot = compute_r_vec(rot, k)
    out = np.zeros(seqs.shape, dtype=np.uint8)
    out[(r > EPS) & (rrot < EPS)] = 2
    out[(r < -EPS) & (rrot > -EPS)] = 1
    return out
