"""Plain reference of the SuperSampler sketch, in plain PyTorch.

What a sketch holds, for records of A, C, G and T: every k-mer whose
minimizer (the canonical m-mer of least XXHash64 among the k-mer's
k - m + 1 m-mers, on both strands) hashes at or below the FHS threshold
is kept once per (minimizer, k-mer) pair, the k-mer oriented by the
strand of the minimizer's occurrence; ``kept`` counts those k-mer
positions with repeats (the sketch header's third field). A pair is
written when its count, kept in 8 bits as the tool keeps it, reaches
the abundance.

The tool (TimRouze/supersampler, SubSampler.cpp:81-169 and 350-454)
finds each k-mer's minimizer by a streaming scan. Its minimizer is
always the window's least m-mer, so the value is computed here for all
k-mers at once. Only the strand can depend on the scan's history: when
the least m-mer occurs in a window on both strands, the occurrence the
scan holds decides it. Those rare k-mers are replayed by ``_Replay``, a
scalar copy of the scan from its last history-free point (a strictly
smaller m-mer entering the window, or the record's start).

Nothing here imports the program under test or JAX. All integer
arithmetic is on int64 tensors, wrapping mod 2^64 as the tool's uint64.
"""

from __future__ import annotations

import numpy as np
import torch

M64 = (1 << 64) - 1
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
SEED = 1312
_SIGN = -(1 << 63)


def _s64(x: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def threshold(k: int, m: int, s: float, dtype=np.longdouble) -> int:
    """The FHS threshold (SubSampler.cpp:622-631): uint64((1 - (1 - 1/s)
    ^ (1 / (k - m + 1))) * 2^63) * 2, every step in ``dtype`` (the tool
    uses 80-bit long double); s <= 1 keeps everything."""
    if s <= 1:
        return M64
    one = dtype(1)
    root = np.power(one - one / dtype(s), one / dtype(k - m + 1))
    return (int((one - root) * dtype(2.0 ** 63)) * 2) & M64


# ---- XXHash64 of one 8-byte word, vectorized over int64 tensors ----
def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def xxh64(x: torch.Tensor) -> torch.Tensor:
    """XXHash64 (seed 1312) of each int64 as 8 little-endian bytes."""
    h0 = _s64(SEED + _P5 + 8)
    single = _rotl(x * _s64(_P2), 31) * _s64(_P1)
    h = _rotl(single ^ h0, 27) * _s64(_P1) + _s64(_P4)
    h = h ^ _lsr(h, 33)
    h = h * _s64(_P2)
    h = h ^ _lsr(h, 29)
    h = h * _s64(_P3)
    return h ^ _lsr(h, 32)


def xxh64_int(x: int) -> int:
    """The same on one Python integer."""
    def rotl(v, r):
        return ((v << r) | (v >> (64 - r))) & M64
    h = (SEED + _P5 + 8) & M64
    single = rotl((x * _P2) & M64, 31) * _P1 & M64
    h = (rotl(h ^ single, 27) * _P1 + _P4) & M64
    h ^= h >> 33
    h = (h * _P2) & M64
    h ^= h >> 29
    h = (h * _P3) & M64
    return h ^ (h >> 32)


def codes_of(ascii_bytes: torch.Tensor) -> torch.Tensor:
    """The tool's 2-bit code of each ASCII base: (c / 2) % 4, so A=0,
    C=1, T=2, G=3 (utils.cpp:13-16)."""
    return ((ascii_bytes >> 1) & 3).to(torch.int64)


def _rolling(c: torch.Tensor, width: int, rc: bool) -> torch.Tensor:
    """The 2-bit value of every width-mer of c (forward, or its reverse
    complement: complement is code ^ 2)."""
    n = c.numel() - width + 1
    v = torch.zeros(max(n, 0), dtype=torch.int64, device=c.device)
    if n <= 0:
        return v
    for t in range(width):
        part = c[t : t + n]
        if rc:
            v |= (part ^ 2) << (2 * t)
        else:
            v = (v << 2) | part
    return v


def _window_min(key: torch.Tensor, w: int) -> torch.Tensor:
    """min(key[j : j + w]) for every j, by doubling."""
    pows = {1: key}
    p = 1
    while 2 * p <= w:
        a = pows[p]
        pows[2 * p] = torch.minimum(a[:-p], a[p:])
        p *= 2
    n = key.numel() - w + 1
    out, off = None, 0
    for p in sorted(pows, reverse=True):
        if w - off >= p:
            part = pows[p][off : off + n]
            out = part if out is None else torch.minimum(out, part)
            off += p
    return out


class _Replay:
    """The tool's streaming scan (SubSampler.cpp:350-454) on one record,
    on Python integers, for the strand of the rare k-mers whose window
    holds its least m-mer on both strands."""

    def __init__(self, codes: np.ndarray, off: int, k: int, m: int):
        self.c = codes.tolist()           # the record's codes from off
        self.off = off
        self.k, self.m = k, m

    def _canon(self, p: int):
        fwd = rc = 0
        p -= self.off
        for t in range(self.m):
            fwd = (fwd << 2) | self.c[p + t]
            rc |= (self.c[p + t] ^ 2) << (2 * t)
        return min(fwd, rc), rc < fwd

    def elect(self, start: int):
        """(value, in-window position, strand) of the k-mer at start,
        with the tool's tie rules and its position arithmetic
        (SubSampler.cpp:81-169)."""
        k, m = self.k, self.m
        mini, is_rev = self._canon(start + k - m)
        position = 0 if is_rev else k - m
        h_min = xxh64_int(mini)
        for i in range(1, k - m + 1):
            mm, local_rev = self._canon(start + k - m - i)
            h = xxh64_int(mm)
            if h_min > h:
                position, mini, is_rev, h_min = k - m - i, mm, local_rev, h
            elif mm == mini and local_rev == is_rev:
                if is_rev and position > i:
                    position = i
                if not is_rev and position > k - m - i:
                    position = k - m - i
        return mini, position, is_rev

    def strand(self, step0: int, q: int) -> bool:
        """The strand the scan holds at k-mer q, replayed from the state
        after a strictly smaller m-mer entered at step step0 (advancing
        to k-mer step0 + 1), or from the record's start (step0 == -1)."""
        k, m = self.k, self.m
        if step0 < 0:
            mini, pos, rev = self.elect(0)
            first = 0
        else:
            pos = step0 + k - m + 1
            mini, rev = self._canon(pos)
            first = step0 + 1
        h_min = xxh64_int(mini)
        for i in range(first, q):
            p = i + k - m + 1
            mm, local_rev = self._canon(p)
            h = xxh64_int(mm)
            if h < h_min:
                mini, h_min, pos, rev = mm, h, p, local_rev
            elif i >= pos:
                mini, position, rev = self.elect(i + 1)
                h_min = xxh64_int(mini)
                pos = position + i + 1
        return rev


def sketch_pairs(seq: np.ndarray, starts: np.ndarray, k: int, m: int,
                 s: float, abundance: int = 1, thr: int | None = None,
                 device="cpu", canonical: bool = True):
    """Reference sketch of one file. seq: the file's records' ASCII
    bases (ACGT) laid end to end, uint8; starts: each record's first
    index, with len(seq) appended. Returns (pairs, kept): pairs is a
    sorted int64 numpy array of shape (n, 2), one (minimizer, oriented
    k-mer) row per written pair; kept counts the kept k-mer positions.
    ``thr`` replaces the threshold; ``canonical=False`` hashes the
    forward strand's m-mers only (both break the tool's guarantees:
    the control's)."""
    if thr is None:
        thr = threshold(k, m, s)
    thr_key = _s64(thr) ^ _SIGN
    w = k - m + 1
    if seq.size < k:
        return np.zeros((0, 2), np.int64), 0
    a = torch.from_numpy(np.ascontiguousarray(seq)).to(device)
    c = codes_of(a)
    del a
    fwd = _rolling(c, m, False)
    rc = _rolling(c, m, True)
    if canonical:
        canon = torch.minimum(fwd, rc)
        rev = rc < fwd
    else:
        canon, rev = fwd, torch.zeros_like(fwd, dtype=torch.bool)
    del fwd, rc
    key = xxh64(canon) ^ _SIGN                # signed order == unsigned
    wmin = _window_min(key, w)                # one per k-mer start
    # a k-mer counts only inside one record
    st = torch.from_numpy(np.asarray(starts, np.int64)).to(c.device)
    j = torch.arange(wmin.numel(), device=c.device)
    rec = torch.searchsorted(st, j, right=True) - 1
    ok = (wmin <= thr_key) & (j + k <= st[rec + 1])
    sel = torch.nonzero(ok).flatten()
    del j, rec, ok
    n_kept = int(sel.numel())
    if n_kept == 0:
        return np.zeros((0, 2), np.int64), 0
    idx = sel[:, None] + torch.arange(w, device=c.device)
    eq = key[idx] == wmin[sel][:, None]
    first = eq.to(torch.int32).argmax(1)
    minval = canon[idx].gather(1, first[:, None])[:, 0]
    rv = rev[idx]
    any_rev = (eq & rv).any(1)
    any_fwd = (eq & ~rv).any(1)
    del idx, eq, rv
    kidx = sel[:, None] + torch.arange(k, device=c.device)
    kc = c[kidx]
    shifts = 2 * torch.arange(k - 1, -1, -1, device=c.device)
    kf = (kc << shifts).sum(1)
    kr = ((kc ^ 2) << torch.flip(shifts, [0])).sum(1)
    orient = any_rev
    mixed = torch.nonzero(any_rev & any_fwd).flatten()
    if mixed.numel():
        orient = orient.cpu().numpy().copy()
        orient[mixed.cpu().numpy()] = _replay_strands(
            c, key, wmin, sel[mixed].cpu().numpy(),
            np.asarray(starts, np.int64), k, m)
        orient = torch.from_numpy(orient).to(c.device)
    pairs = torch.stack([minval, torch.where(orient, kr, kf)], 1)
    uniq, counts = torch.unique(pairs, dim=0, return_counts=True)
    keep = (counts & 0xFF) >= abundance
    return uniq[keep].cpu().numpy(), n_kept


def _replay_strands(c, key, wmin, js, starts, k, m) -> np.ndarray:
    """The scan's strand at each k-mer start j of js, each replayed in
    its own record."""
    out = np.empty(js.size, dtype=bool)
    for t, jg in enumerate(js.tolist()):
        r = int(np.searchsorted(starts, jg, side="right")) - 1
        s0, s1 = int(starts[r]), int(starts[r + 1])
        q = jg - s0
        rkey = key[s0 : s1 - m + 1].cpu().numpy()
        rmin = wmin[s0 : s1 - k + 1].cpu().numpy()
        # a strictly smaller m-mer enters at step i (advancing to k-mer
        # i + 1) when its key is below the least key of k-mer i's window
        n_steps = rmin.size - 1
        strict = rkey[k - m + 1 : k - m + 1 + n_steps] < rmin[:n_steps]
        steps = np.flatnonzero(strict[: max(q, 0)])
        step0 = int(steps[-1]) if steps.size else -1
        lo = max(step0, 0)
        rp = _Replay(c[s0 + lo : s0 + q + k].cpu().numpy(), lo, k, m)
        out[t] = rp.strand(step0, q)
    return out


def canonical_kmer(kmers: np.ndarray, k: int) -> np.ndarray:
    """min(k-mer, reverse complement) of 2-bit k-mer values."""
    rc = np.zeros_like(kmers)
    x = kmers.copy()
    for _ in range(k):
        rc = (rc << 2) | ((x & 3) ^ 2)
        x >>= 2
    return np.minimum(kmers, rc)
