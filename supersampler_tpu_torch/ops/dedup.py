"""Device-side k-mer extraction and dedup of the selected super-k-mers.

Counterpart of supersampler_tpu/ops/dedup.py. In place of the
reference's per-k-mer hash-map insert (SubSampler.cpp:258-301) the
selected spans expand on the device to per-position oriented k-mers,
which sort by (minimizer, k-mer, insertion order) and segment-unique;
only the unique k-mers, with their counts, first-occurrence minimizer
offsets and first-insertion order, go to the host, which merges them
into the Python k-mer store (sketch/store.py) for reconstruction.

Contract replicated bit for bit (the JAX module's docstring):
  * the stored key is the oriented k-mer (reverse-complemented when the
    super-k-mer's minimizer was reverse-strand, SubSampler.cpp:246-249);
  * enumeration order within a reversed span runs from the span's end;
  * pos_min is the first offset of the minimizer string inside the
    oriented k-mer (kmerstr.find(minstr)), which can be a textual match
    before the elected position;
  * counts are occurrence counts; the host merge wraps them to uint8.

Plain PyTorch on the given device: the JAX function is XLA (a sort,
scatters and a nonzero), no Pallas kernel. u32 values ride in int64 (as
ops/u64.py does), so the invalid sentinel 0xFFFFFFFF sorts last; the
fetch arrays are int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from supersampler_tpu_torch.ops import u64 as U
from supersampler_tpu_torch.ops.field import _HEAD, parse_field_array
from supersampler_tpu_torch.ops.minimizer import unpack_2bit
from supersampler_tpu_torch.ops.walker import (pack_compact_outs,
                                               parse_compact_array)

_I32 = torch.int32
_I64 = torch.int64
_INVALID = 0xFFFFFFFF
_OKEY_PAD = 2**31 - 1
_HALO_LEFT = 128    # covers the longest span (2k-m-1 < 128 chars) of a
                    # boundary event near a tile's start


def _stable_order(keys) -> torch.Tensor:
    """The permutation that sorts rows by the int64 keys, most
    significant first, keeping equal rows in place: stable sorts from
    the least significant key up."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order


def dedup_spans(codes: torch.Tensor, spans, k: int, m: int, P: int,
                K: int):
    """Extract and dedup the selected k-mers of one walk's spans
    (dedup.py:41).

    codes: uint8[P] 2-bit codes on the device.
    spans: (sel_pos [cap], sel_last [cap], sel_val [cap] (u32 values),
            sel_rev [cap] (bool or 0/1), n_sel (0-d tensor)).
    K: k-mer-occurrence capacity; rows past it are dropped (the caller
       retries bigger; the true count comes back in n_kmers).

    Returns (n_kmers, n_unique, minval [K], limbs [K, 4] (l3..l0,
    big-endian), okey [K] first-insertion order, pos_min [K],
    count [K]), int64 0-d / int64 arrays with u32 values as int64. Rows
    past n_unique hold the fill values; rows are sorted by (minval,
    k-mer); the host orders by okey."""
    sel_pos, sel_last, sel_val, sel_rev, n_sel = spans
    dev = codes.device
    sel_pos = sel_pos.to(_I64)
    sel_last = sel_last.to(_I64)
    sel_val = sel_val.to(_I64) & U.MASK32
    sel_rev = sel_rev.to(torch.bool)
    cap = sel_pos.numel()
    W = k - m + 1

    ok = (torch.arange(cap, device=dev) < n_sel) & (sel_pos >= 0)
    okn = ok.to(_I64)
    pos_c = torch.clamp(sel_pos, 0, P - 1)
    last_c = torch.clamp(sel_last, 0, P - 1)
    zero = torch.zeros(P + 1, dtype=_I64, device=dev)
    starts = zero.index_add(0, torch.where(ok, last_c, 0), okn)
    ends = zero.index_add(0, torch.where(ok, pos_c + 1, 0), okn)
    in_span = (torch.cumsum(starts, 0) - torch.cumsum(ends, 0))[:P] > 0
    sid_scatter = torch.full((P,), -1, dtype=_I64, device=dev).scatter_reduce(
        0, torch.where(ok, last_c, 0),
        torch.where(ok, torch.arange(cap, device=dev), -1), "amax",
        include_self=True)
    span_id = torch.cummax(sid_scatter, 0).values
    sid_c = torch.clamp(span_id, 0, cap - 1)

    # k trailing zeros: every tap below is a full P-long slice
    cs = torch.cat([codes.to(_I64), torch.zeros(k, dtype=_I64, device=dev)])

    # oriented k-mer limbs: forward = codes[p..p+k) packed big-endian;
    # reverse = complemented codes packed in reverse order
    fwd = [torch.zeros(P, dtype=_I64, device=dev) for _ in range(4)]
    rc = [torch.zeros(P, dtype=_I64, device=dev) for _ in range(4)]
    for j in range(k):
        c = cs[j : j + P]
        b = 2 * (k - 1 - j)
        fwd[b >> 5] |= c << (b & 31)
        b = 2 * j
        rc[b >> 5] |= (c ^ 2) << (b & 31)

    rev_at = sel_rev[sid_c]
    limbs = [torch.where(rev_at, r, f) for f, r in zip(fwd, rc)]
    del fwd, rc

    # minimizer-string matches: the oriented m-mer at q equals the
    # span's minimizer value (fwd m-mer for forward spans, rc m-mer for
    # reversed ones)
    fwd_m = torch.zeros(P, dtype=_I64, device=dev)
    rc_m = torch.zeros(P, dtype=_I64, device=dev)
    for j in range(m):
        c = cs[j : j + P]
        fwd_m = (fwd_m << 2) | c
        rc_m |= (c ^ 2) << (2 * j)
    minval_at = sel_val[sid_c]
    # a k-mer's search window [g, g+k-m] can cross into the next span,
    # so compare against the k-mer's own span minimizer (indexed by g);
    # the W-long pad never matches (minimizers are < 2^30)
    pad = torch.full((W,), _INVALID, dtype=_I64, device=dev)
    fwd_m_pad = torch.cat([fwd_m, pad])
    rc_m_pad = torch.cat([rc_m, pad])

    def first_off(vals, back: bool):
        pm = torch.full((P,), k, dtype=_I64, device=dev)
        found = torch.zeros(P, dtype=torch.bool, device=dev)
        for o in range(W):
            q_off = (k - m - o) if back else o
            hit = vals[q_off : q_off + P] == minval_at
            pm = torch.where(hit & ~found, o, pm)
            found |= hit
        return pm

    pos_min = torch.where(rev_at, first_off(rc_m_pad, True),
                          first_off(fwd_m_pad, False))

    # first-insertion order: forward spans enumerate left to right,
    # reversed spans right to left (handle_superkmer runs over the RC'd
    # string, SubSampler.cpp:246-258)
    pidx = torch.arange(P, dtype=_I64, device=dev)
    j_or = torch.where(rev_at, sel_pos[sid_c] - pidx, pidx - sel_last[sid_c])
    okey = span_id * 64 + j_or

    # jnp.nonzero(in_span, size=K, fill_value=P - 1): the first K
    # in-span positions in order, P - 1 past them; overflow rows land in
    # a dropped slot K
    rank = torch.cumsum(in_span.to(_I64), 0) - 1
    slot = torch.where(in_span & (rank < K), rank, K)
    idx = torch.full((K + 1,), P - 1, dtype=_I64, device=dev).scatter_(
        0, slot, pidx)[:K]
    n_kmers = in_span.sum()
    valid = torch.arange(K, device=dev) < n_kmers
    g_min = torch.where(valid, minval_at[idx], _INVALID)
    g_l = [torch.where(valid, lm[idx], _INVALID) for lm in limbs]
    g_okey = torch.where(valid, okey[idx], _OKEY_PAD)
    g_pm = pos_min[idx]

    # sort by (minimizer, k-mer, insertion order); invalid rows sink.
    # Three int64 keys carry the six u32 keys: minimizers are < 2^30
    # and the sentinel 0xFFFFFFFF, so (min' << 32 | l3) with the
    # sentinel as 2^30 stays non-negative; the other two pairs use the
    # unsigned-order key of ops/u64.py
    min_key = torch.where(g_min == _INVALID, 1 << 30, g_min)
    order = _stable_order([
        (min_key << 32) | g_l[3],
        U.key((g_l[2] << 32) | g_l[1]),
        U.key((g_l[0] << 32) | g_okey)])
    g_min = g_min[order]
    l3, l2, l1, l0 = (g_l[3][order], g_l[2][order], g_l[1][order],
                      g_l[0][order])
    g_okey = g_okey[order]
    g_pm = g_pm[order]

    same = torch.zeros(K, dtype=torch.bool, device=dev)
    same[1:] = ((g_min[1:] == g_min[:-1]) & (l3[1:] == l3[:-1])
                & (l2[1:] == l2[:-1]) & (l1[1:] == l1[:-1])
                & (l0[1:] == l0[:-1]))
    row_valid = g_min != _INVALID
    new = ~same & row_valid
    gid = torch.clamp(torch.cumsum(new.to(_I64), 0) - 1, 0, K - 1)
    counts = torch.zeros(K, dtype=_I64, device=dev).index_add(
        0, gid, row_valid.to(_I64))
    n_unique = new.sum()

    def firsts(a, fill: int):
        # exactly one `new` row lands on each gid < n_unique, so a
        # masked scatter-max is a plain scatter of the group's first row
        return torch.full((K,), fill, dtype=_I64, device=dev).scatter_reduce(
            0, torch.where(new, gid, K - 1), torch.where(new, a, fill),
            "amax", include_self=True)

    return (n_kmers, n_unique, firsts(g_min, 0),
            torch.stack([firsts(a, 0) for a in (l3, l2, l1, l0)], 1),
            firsts(g_okey, -1), firsts(g_pm, -1), counts)


def _dedup_tail_arrays(outs, packed_ext: torch.Tensor, length: int, k: int,
                       m: int, P_ext: int, K: int) -> torch.Tensor:
    """Spans (and the tail span) -> the dedup part of a fetch array
    (dedup.py:184).

    outs: the compact outputs (pos, last, val, rev, n_sel, n_ev,
    last_pos, tail_val, tail_rev, tail_sel) of a walk or a field
    resolve, positions local to the walked region.
    packed_ext: 2-bit packed codes of [region_start - 128, region_start
    + P), the left halo covering spans whose opening event precedes the
    region (tile carries; a sequence start has zero padding).
    length: local sequence length, or -1 for a non-final tile (its tail
    flush belongs to a later tile).

    Returns int32 [n_kmers, n_unique, u_min[K], limbs l3[K] l2[K] l1[K]
    l0[K], okey[K], pos_min[K], counts[K]]."""
    (pos, last, val, rev, n_sel, n_ev, last_pos, tail_val, tail_rev,
     tail_sel) = outs
    dev = pos.device
    cap = pos.numel()
    ns = n_sel.to(_I64).reshape(())
    add_tail = (tail_sel.reshape(()) != 0) & (length >= 0)
    neg = torch.full((1,), -1, dtype=_I64, device=dev)
    pos_x = torch.cat([pos.to(_I64), neg])
    last_x = torch.cat([last.to(_I64), neg])
    val_x = torch.cat([val.to(_I64) & U.MASK32, neg + 1])
    rev_x = torch.cat([rev.to(torch.bool),
                       torch.zeros(1, dtype=torch.bool, device=dev)])
    # the tail span goes in slot n_sel; with n_sel > cap (a truncated
    # list, retried by the caller) the write is dropped, as JAX's
    # out-of-range .at[].set is
    in_b = ns <= cap
    at = torch.clamp(ns, max=cap)
    tail_l = torch.where(n_ev.reshape(()) > 0,
                         last_pos.to(_I64).reshape(()) + 1, 0)
    pos_x[at] = torch.where(in_b & add_tail, length - k, -1)
    last_x[at] = torch.where(in_b & add_tail, tail_l, -1)
    val_x[at] = torch.where(in_b, tail_val.to(_I64).reshape(()) & U.MASK32,
                            0)
    rev_x[at] = in_b & (tail_rev.reshape(()) != 0)
    n_spans = ns + add_tail.to(_I64)

    # spans in the halo'd frame; -1 sentinels stay
    pos_h = torch.where(pos_x >= 0, pos_x + _HALO_LEFT, -1)
    last_h = torch.where(pos_x >= 0, last_x + _HALO_LEFT, -1)

    codes = unpack_2bit(packed_ext, P_ext)
    (n_kmers, n_unique, u_min, limbs, okey, pm, counts) = dedup_spans(
        codes, (pos_h, last_h, val_x, rev_x, n_spans), k, m, P_ext, K)
    return torch.cat([torch.stack([n_kmers, n_unique]), u_min,
                      limbs.t().reshape(-1), okey, pm, counts]).to(_I32)


def dedup_chain_packed(outs, scal, packed_ext: torch.Tensor, length: int,
                       k: int, m: int, P_ext: int, K: int) -> torch.Tensor:
    """One fetch array for the walker's dedup path (dedup.py:226): the
    compact array (walker.pack_compact_outs) and the walk's unique
    k-mers."""
    return torch.cat([
        pack_compact_outs(outs, scal),
        _dedup_tail_arrays(outs, packed_ext, length, k, m, P_ext, K)])


def field_dedup_packed(arr: torch.Tensor, cap: int, packed_ext: torch.Tensor,
                       length: int, k: int, m: int, P_ext: int,
                       K: int) -> torch.Tensor:
    """One fetch array for the field resolve's dedup path (dedup.py:
    238): resolve_field's array (head of 12, ops/field.py) and the
    region's unique k-mers."""
    H = _HEAD
    outs = (arr[H : H + cap], arr[H + cap : H + 2 * cap],
            arr[H + 2 * cap : H + 3 * cap], arr[H + 3 * cap : H + 4 * cap],
            arr[1], arr[2], arr[3], arr[4], arr[5], arr[6])
    return torch.cat([arr, _dedup_tail_arrays(outs, packed_ext, length, k,
                                              m, P_ext, K)])


def _parse_dedup_tail(arr: np.ndarray, base: int, K: int):
    n_kmers = int(arr[base])
    n_unique = int(arr[base + 1])
    base += 2
    u_min = arr[base : base + K].view(np.uint32)
    base += K
    limbs = arr[base : base + 4 * K].view(np.uint32).reshape(4, K).T
    base += 4 * K
    okey = arr[base : base + K]
    base += K
    pm = arr[base : base + K]
    base += K
    counts = arr[base : base + K]
    return n_kmers, (n_unique, u_min, limbs, okey, pm, counts)


def parse_dedup_array(arr: np.ndarray, cap: int, K: int):
    """Split a dedup_chain_packed fetch into (compact 9-tuple, n_sel,
    n_kmers, uniques); uniques feeds merge_unique_host."""
    comp = parse_compact_array(arr, cap)
    n_kmers, uniques = _parse_dedup_tail(arr, 8 + 4 * cap, K)
    return comp, int(arr[0]), n_kmers, uniques


def parse_field_dedup_array(arr: np.ndarray, cap: int, K: int):
    """Split a field_dedup_packed fetch into (status, compact 9-tuple,
    n_sel, n_kmers, uniques)."""
    status, comp, n_sel = parse_field_array(arr, cap)
    n_kmers, uniques = _parse_dedup_tail(arr, _HEAD + 4 * cap, K)
    return status, comp, n_sel, n_kmers, uniques


def merge_unique_host(ss, fetched) -> None:
    """Merge one dispatch's unique k-mers into ss's k-mer store
    (sketch/store.py) in first-insertion order, counts wrapped to uint8
    (dedup.py:302): the host side of the device dedup, in place of the
    per-occurrence inserts of handle_superkmer."""
    # here, not at the top: the sketch package imports the pipeline,
    # which imports this module
    from supersampler_tpu_torch.sketch.store import KmerInfo

    n_unique, minv, limbs, okey, pos_min, counts = fetched
    if n_unique == 0:
        return
    order = np.argsort(okey[:n_unique], kind="stable")
    minv = minv[:n_unique][order]
    limbs = limbs[:n_unique][order]
    pos_min = pos_min[:n_unique][order]
    counts = counts[:n_unique][order]
    kmers = ((limbs[:, 0].astype(object) << 96)
             | (limbs[:, 1].astype(object) << 64)
             | (limbs[:, 2].astype(object) << 32)
             | limbs[:, 3].astype(object))
    mmap = ss.minimizer_map
    for mv, km, pm, c in zip(minv.tolist(), kmers, pos_min.tolist(),
                             counts.tolist()):
        bucket = mmap.get(mv)
        if bucket is None:
            bucket = {}
            mmap[mv] = bucket
        info = bucket.get(km)
        if info is None:
            bucket[km] = KmerInfo(c & 0xFF, pm)
        else:
            info.count = (info.count + c) & 0xFF
