"""Plain per-position m-mer scan on flat tensors.

Counterpart of the parts of supersampler_tpu/ops/minimizer.py that the
field scan uses: ``unpack_2bit`` (minimizer.py:334), the rolling
canonical m-mers and hashes of ``_mmer_build_block`` (:383) and the
exact right-to-left election fold of ``_mmer_elect_block`` (:399,
reference SubSampler.cpp:81-169). The JAX versions work on (R, C+halo)
row blocks; these work on one flat position axis, which the caller
extends with the lookahead it needs. The fold is exact, so the port has
no collision flag (``elect_block_flagged``'s is constant False).

These are the plain versions the CUDA scan kernel (csrc/scan.cu) is
held to; they run on any device.

The exact fallback engine's successor tables (``ScanTables``,
minimizer.py:42) come from the same scan: ``succ_tables`` derives every
field from the scan kernel's output plus a W-position lookahead pass in
plain torch ops (the XLA part of ``_block_tables``, minimizer.py:663-689).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from supersampler_tpu_torch.ops import u64 as U
from supersampler_tpu_torch.ops.hashing import xxh64_u32

_I32 = torch.int32
_M30 = (1 << 30) - 1


class ScanTables(NamedTuple):
    """What the chain walker needs, per loop position i in [0, P - k)
    (the valid region is i <= length - k - 1). u32 values are int32 bit
    patterns; the init_* fields are 0-d tensors."""

    nxt_pos_a: torch.Tensor    # int32 next event after an adoption at i, or -1
    nxt_adopt_a: torch.Tensor  # bool: that next event is an adoption
    nxt_pos_r: torch.Tensor    # the same after a rescan at i
    nxt_adopt_r: torch.Tensor
    val_a: torch.Tensor        # int32 minimizer value held after an adoption
    rev_a: torch.Tensor        # bool strand
    sel_a: torch.Tensor        # bool FHS select (hash <= threshold)
    val_r: torch.Tensor        # the same after a rescan (election of i + 1)
    rev_r: torch.Tensor
    sel_r: torch.Tensor
    init_nxt_pos: torch.Tensor  # first event after the window-0 election
    init_nxt_adopt: torch.Tensor
    init_val: torch.Tensor
    init_rev: torch.Tensor
    init_sel: torch.Tensor


def unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    """2-bit-packed uint8 (4 codes per byte, LSB first like the host
    packer) -> n uint8 codes."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    return ((packed.reshape(-1, 1) >> shifts) & 3).reshape(n)


def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of unpack_2bit; len(codes) must be a multiple of 4."""
    c = codes.reshape(-1, 4).to(torch.uint8)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def mmer_build(codes: torch.Tensor, m: int, n: int):
    """Canonical m-mers starting at positions [0, n) of an int64 code
    array holding at least n + m - 1 codes. Returns (canon int64,
    rev bool, hash int64 u64 bits)."""
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(m):
        c = codes[j : j + n]
        fwd = (fwd << 2) | c
        rc = rc | ((c ^ 2) << (2 * j))
    rev = rc < fwd
    canon = torch.where(rev, rc, fwd)
    return canon, rev, xxh64_u32(canon)


def mmer_elect(canon, rev, hh, k: int, m: int, n: int):
    """Exact window elections (regular_minimizer_pos) for the windows
    starting at [0, n); the m-mer arrays must hold n + k - m entries.
    Returns (em int64 value, ep int64 in-window position, er bool,
    eh int64 hash bits)."""
    W = k - m + 1
    km = k - m
    hkey = U.key(hh)
    mini = canon[km : km + n]
    is_rev = rev[km : km + n]
    pos = torch.where(is_rev, 0, km)
    hmin = hkey[km : km + n]
    for i in range(1, W):
        off = km - i
        mm = canon[off : off + n]
        lr = rev[off : off + n]
        h = hkey[off : off + n]
        replace = hmin > h
        same = (mm == mini) & ~replace & (lr == is_rev)
        tie_take = same & ((is_rev & (pos > i)) | (~is_rev & (pos > off)))
        take = replace | tie_take
        new_pos = torch.where(replace, off, torch.where(is_rev, i, off))
        pos = torch.where(take, new_pos, pos)
        mini = torch.where(take, mm, mini)
        is_rev = torch.where(take, lr, is_rev)
        hmin = torch.where(take, h, hmin)
    return mini, pos, is_rev, U.key(hmin)


def succ_tables(tabs, init, k: int, m: int, length: int, thr_hi: int,
                thr_lo: int) -> ScanTables:
    """ScanTables of one sequence from its field scan.

    tabs: the scan's (h_hi, h_lo, cv, em, ep, eh_hi, eh_lo), P entries
    each (ops/scan_kernel.py); init: its window-0 election (value|
    rev<<30, position, hash hi, hash lo) as 0-d tensors. length: the
    real sequence length the chain may reach; a non-final tile passes
    the remaining length, so successors may point past the tile.

    The successor of an event at j is the first i in (j, p] whose
    entering hash is strictly below the held one (an adoption, checked
    first, reference SubSampler.cpp:374) and otherwise the rescan at
    i == p (SubSampler.cpp:391); p - j <= W always. Positions are walked
    from W down to 1 so that the last write is the first event."""
    h_hi, h_lo, cv, em, ep, eh_hi, eh_lo = tabs
    W = k - m + 1
    P = h_hi.numel()
    n = P - k
    dev = h_hi.device
    last_i = length - k - 1
    thr = U.key_int((thr_hi << 32) | thr_lo)
    hk = U.key(U.join(h_hi, h_lo))
    ha = hk[:n]
    hr = U.key(U.join(eh_hi[:n], eh_lo[:n]))
    j = torch.arange(n, dtype=_I32, device=dev)
    pr = ep[:n] + j + 1
    na_pos = torch.full((n,), -1, dtype=_I32, device=dev)
    nr_pos = torch.full((n,), -1, dtype=_I32, device=dev)
    na_adopt = torch.zeros(n, dtype=torch.bool, device=dev)
    nr_adopt = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in range(W, 0, -1):
        i = j + w
        ok = i <= last_i
        hi = hk[w : w + n]
        lt = hi < ha
        # adoption node: p = j + W, so i <= p for every w
        ev = ok & (lt | (w == W))
        na_pos = torch.where(ev, i, na_pos)
        na_adopt = torch.where(ev, lt, na_adopt)
        lt = hi < hr
        ev = ok & ((lt & (i <= pr)) | (i == pr))
        nr_pos = torch.where(ev, i, nr_pos)
        nr_adopt = torch.where(ev, lt, nr_adopt)

    # the window-0 election's successor: events at i = 0 .. W-1
    init_val, init_p, init_hh, init_hl = init
    h0 = U.key(U.join(init_hh, init_hl))
    i = torch.arange(W, dtype=_I32, device=dev)
    lt = hk[:W] < h0
    ok = i <= last_i
    ev = ((i <= init_p) & lt & ok) | ((i == init_p) & ~lt & ok)
    first = torch.argmax(ev.to(torch.uint8))
    found = ev.any()
    return ScanTables(
        nxt_pos_a=na_pos, nxt_adopt_a=na_adopt,
        nxt_pos_r=nr_pos, nxt_adopt_r=nr_adopt,
        val_a=cv[:n] & _M30, rev_a=((cv[:n] >> 30) & 1) == 1,
        sel_a=ha <= thr,
        val_r=em[:n] & _M30, rev_r=((em[:n] >> 30) & 1) == 1,
        sel_r=hr <= thr,
        init_nxt_pos=torch.where(found, first.to(_I32), -1),
        init_nxt_adopt=found & lt[first],
        init_val=init_val & _M30, init_rev=((init_val >> 30) & 1) == 1,
        init_sel=h0 <= thr)


def scan_tables_2d_packed(packed: torch.Tensor, k: int, m: int,
                          padded_len: int, length: int, thr_hi: int,
                          thr_lo: int) -> ScanTables:
    """Scan one sequence's 2-bit packed codes (padded_len / 4 bytes)
    into ScanTables (counterpart of minimizer.py:367): one launch of the
    field scan, then succ_tables."""
    # scan_kernel imports this module for the plain m-mer helpers
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel

    last_i = torch.tensor([length - k - 1], dtype=_I32, device=packed.device)
    *tabs, _sync, init = scan_kernel(packed, k, m, padded_len, last_i)
    return succ_tables(tabs, init[:, 0], k, m, length, thr_hi, thr_lo)
