"""Sync-field scan and resolve: walker-free event extraction.

Counterpart of supersampler_tpu/ops/field.py (v1 path). A position
whose entering hash is strictly below every hash of the preceding 2W
positions forces an adoption whatever came before (the sync theorem,
supersampler_tpu/ops/event_field.py), so the streaming machine's state
there is known locally. The sequence is cut into 256-position lanes;
sweep 1 resolves each lane's suffix from its first sync (which also
gives the lane's exit state), and up to _MAX_PASSES prefix sweeps
resolve each prefix from its predecessor's exit. Lanes still open after
the passes (pathological content such as kilobase homopolymers), a
per-lane list overflow or a collision flag raise ``status``.

Layout at the public functions is the JAX one: flat per-position
tables (P a multiple of 256), u32 fields as int32 bit patterns, sync
bool, positions int32. The per-position work runs in two kernels, the
scan (ops/scan_kernel.py, csrc/scan.cu) and the sweep (``sweep_kernel``
here, csrc/sweep.cu); the glue between sweeps is plain torch ops on the
device, as it is XLA in JAX. The opt-in v2 path (ops/fused.py, CUDA
only, ``SPSP_FUSED=1``) shares the resolve below with the tables in the
sweep's column layout.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from supersampler_tpu_torch.ops import _build
from supersampler_tpu_torch.ops import u64 as U
from supersampler_tpu_torch.ops.minimizer import pack_2bit
from supersampler_tpu_torch.ops.scan_kernel import scan_kernel

_I32 = torch.int32
_I64 = torch.int64
_B = 256                 # positions per lane
_MAX_PASSES = 4          # prefix sweeps (syncless-run budget)
_HEAD = 12
_BHEAD = 8
_M30 = (1 << 30) - 1


class FieldTables(NamedTuple):
    """Flat per-loop-position tables of one sequence (P % 256 == 0).
    The v2 path holds the seven tables in the (256, P/256) column layout
    and no sync (its lanes' first syncs come from the scan kernel)."""

    h_hi: torch.Tensor     # entering m-mer hash at j (u32 bits, int32)
    h_lo: torch.Tensor
    cv: torch.Tensor       # entering canon value | rev<<30
    em: torch.Tensor       # election of window j+1: value | rev<<30
    ep: torch.Tensor       # election in-window position
    eh_hi: torch.Tensor    # election hash
    eh_lo: torch.Tensor
    sync: torch.Tensor     # bool: guaranteed adoption at j
    last_i: torch.Tensor   # int32 scalar: final valid loop position
    init_val: torch.Tensor  # window-0 election value | rev<<30
    init_p: torch.Tensor    # int32 absolute position_min
    init_h_hi: torch.Tensor
    init_h_lo: torch.Tensor
    eflag: torch.Tensor    # bool scalar, always False (the fold is exact)


class BatchedFieldTables(NamedTuple):
    """Tables of a batch of records laid back to back: record b owns
    flat positions [b*P_rec, (b+1)*P_rec). Per-record scalars are
    (B,) tensors."""

    h_hi: torch.Tensor
    h_lo: torch.Tensor
    cv: torch.Tensor
    em: torch.Tensor
    ep: torch.Tensor
    eh_hi: torch.Tensor
    eh_lo: torch.Tensor
    sync: torch.Tensor
    last_i: torch.Tensor
    init_val: torch.Tensor
    init_p: torch.Tensor
    init_h_hi: torch.Tensor
    init_h_lo: torch.Tensor
    eflag: torch.Tensor


class FieldState(NamedTuple):
    """Per-lane machine state, int32 bit patterns."""

    val: torch.Tensor      # value | rev<<30 | sel<<31 of the held minimizer
    h_hi: torch.Tensor
    h_lo: torch.Tensor
    p: torch.Tensor        # absolute position_min
    last_ev: torch.Tensor  # absolute position of the last event (-1)
    n_ev: torch.Tensor     # events so far in this lane's resolved part


# ----------------------------------------------------------------------
# scan
# ----------------------------------------------------------------------

def scan_field_2d_packed(packed: torch.Tensor, k: int, m: int,
                         padded_len: int, length: int) -> FieldTables:
    """Field scan of one sequence from its 2-bit packed codes
    (padded_len / 4 bytes) on packed's device."""
    P = padded_len
    if P % _B or packed.numel() * 4 != P:
        raise ValueError(f"padded_len={P} must be a multiple of {_B} "
                         f"and match {packed.numel()} packed bytes")
    dev = packed.device
    last_i = torch.tensor([int(length) - k - 1], dtype=_I32, device=dev)
    *tabs, sync, init = scan_kernel(packed, k, m, P, last_i)
    return FieldTables(*tabs, sync=sync, last_i=last_i[0],
                       init_val=init[0, 0], init_p=init[1, 0],
                       init_h_hi=init[2, 0], init_h_lo=init[3, 0],
                       eflag=torch.zeros((), dtype=torch.bool, device=dev))


def scan_field_2d(codes: torch.Tensor, k: int, m: int, padded_len: int,
                  length: int) -> FieldTables:
    """scan_field_2d_packed over an unpacked uint8 code array."""
    return scan_field_2d_packed(pack_2bit(codes[:padded_len]), k, m,
                                padded_len, length)


def scan_field_batched(packed: torch.Tensor, k: int, m: int, P_rec: int,
                       lengths: torch.Tensor) -> BatchedFieldTables:
    """Field scan of B records at once: packed (B, P_rec/4) slabs,
    lengths (B,) int32 cleaned lengths (< k => the record is inert).
    Each record's sync lookback and positions are local to it."""
    B_n = packed.shape[0]
    if P_rec % _B or packed.shape[1] * 4 != P_rec:
        raise ValueError(f"P_rec={P_rec} must be a multiple of {_B} "
                         f"and match packed rows of {packed.shape[1]}")
    last_i = (lengths.to(_I32) - (k + 1)).contiguous()
    *tabs, sync, init = scan_kernel(packed.reshape(-1), k, m, P_rec, last_i)
    return BatchedFieldTables(
        *tabs, sync=sync, last_i=last_i, init_val=init[0], init_p=init[1],
        init_h_hi=init[2], init_h_lo=init[3],
        eflag=torch.zeros(B_n, dtype=torch.bool, device=packed.device))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)              # a writable copy; keeps 0-d shapes
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def tables_from_numpy(d: dict, device="cpu") -> FieldTables:
    """A JAX FieldTables fetched as numpy (field name -> array) as the
    port's tables on ``device``."""
    return FieldTables(*(_from_numpy(d[f], device)
                         for f in FieldTables._fields))


def batched_tables_from_numpy(d: dict, device="cpu") -> BatchedFieldTables:
    """tables_from_numpy for a JAX BatchedFieldTables."""
    return BatchedFieldTables(*(_from_numpy(d[f], device)
                                for f in BatchedFieldTables._fields))


# ----------------------------------------------------------------------
# sweep: the streaming machine over each lane's columns
# ----------------------------------------------------------------------

_LAYOUTS = ("lane", "col")
_MAX_CAPL = 256          # the kernel stages the lists in shared memory


def _col(a: torch.Tensor, n: int, layout: str) -> torch.Tensor:
    """(256, n) column view of a table: a flat lane-major table ("lane",
    column r of lane l at l*256 + r) or one already in the column layout
    ("col", at r*n + l)."""
    return a if layout == "col" else a.view(n, _B).t()


def _first_sync(sync: torch.Tensor, n: int) -> torch.Tensor:
    """Each lane's first sync column, 256 where it has none."""
    sync2 = sync.view(n, _B)
    return torch.where(sync2.any(1),
                       sync2.to(torch.uint8).argmax(1).to(_I32), _B)


def sweep_plain(tabs, se, st0, thr_hi: int, thr_lo: int, W: int,
                capl: int, force_entry: bool, layout: str = "lane"):
    """Plain sweep: the machine over every lane's columns [start, end)
    (reference SubSampler.cpp:367-440) as dense column steps, then the
    per-lane selected-emit lists. The kernel's executable spec.

    tabs: the seven tables (h_hi, h_lo, cv, em, ep, eh_hi, eh_lo), n*256
    int32 each, flat lane-major (layout "lane") or (256, n) (layout
    "col"); se (5, n) int32 = start, end, active, j0, lastiv; st0 (6, n)
    int32 = entry FieldState. Returns (xs (7, n) = exit state + cnt,
    pos, pval, plast (capl, n)) as int32. cnt counts past capl; entry
    events (forced adoption at start) never emit."""
    n = se.shape[1]
    dev = se.device
    hh, hl, cv, em, ep, ehh, ehl = (_col(a, n, layout) for a in tabs)
    start, end, active, j0, lastiv = se.to(_I64)
    active = active != 0
    thr = U.key_int((thr_hi << 32) | thr_lo)
    val = U.u32(st0[0])
    hk = U.key(U.join(st0[1], st0[2]))
    p, last_ev, n_ev = (a.to(_I64) for a in st0[3:6])
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    evs, pvals, plasts, ents = [], [], [], []
    for r in range(_B):
        j = j0 + r
        act = active & (r >= start) & (r < end) & (j <= lastiv)
        is_entry = act & (start == r) if force_entry else no
        nk = U.key(U.join(hh[r], hl[r]))
        adopt = (act & (nk < hk)) | is_entry
        ev = adopt | (act & ~adopt & (j >= p))
        new_k = torch.where(adopt, nk, U.key(U.join(ehh[r], ehl[r])))
        sel = (new_k <= thr).to(_I64)
        new_val = (torch.where(adopt, U.u32(cv[r]), U.u32(em[r]))
                   | (sel << 31))
        new_p = torch.where(adopt, j + W, ep[r].to(_I64) + j + 1)
        evs.append(ev)
        pvals.append(torch.where(ev, val, 0))
        plasts.append(torch.where(ev, last_ev + 1, -1))
        ents.append(is_entry)
        val = torch.where(ev, new_val, val)
        hk = torch.where(ev, new_k, hk)
        p = torch.where(ev, new_p, p)
        last_ev = torch.where(ev, j, last_ev)
        n_ev = n_ev + ev.to(_I64)
    ev, pval, plast, isent = (torch.stack(a) for a in
                              (evs, pvals, plasts, ents))
    # dense (256, n) events -> per-lane lists of selected emits
    emit = ev & (((pval >> 31) & 1) == 1) & ~isent
    cnt = emit.sum(0)
    slot = emit.to(_I64).cumsum(0) - 1
    put = emit & (slot < capl)
    lanes = torch.arange(n, device=dev).expand(_B, n)[put]
    rows = slot[put]
    jpos = (j0 + torch.arange(_B, device=dev)[:, None])[put]
    lists = []
    for src in (jpos, pval[put], plast[put]):
        out = torch.zeros((capl, n), dtype=_I64, device=dev)
        out[rows, lanes] = src
        lists.append(out.to(_I32))
    hi, lo = U.split(U.key(hk))
    xs = torch.stack([val.to(_I32), hi, lo, p.to(_I32), last_ev.to(_I32),
                      n_ev.to(_I32), cnt.to(_I32)])
    return (xs, *lists)


def _check_sweep_args(tabs, se, st0, capl, layout):
    n = se.shape[1]
    dev = se.device
    for name, a, shape in (("se", se, (5, n)), ("st0", st0, (6, n))):
        if (a.dtype != _I32 or a.shape != shape or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {shape} "
                             f"on {dev}")
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}")
    tshape = (_B, n) if layout == "col" else (n * _B,)
    for a in tabs:
        if (a.dtype != _I32 or a.shape != tshape or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(f"tables must be contiguous int32 {tshape} "
                             f"on {dev}")
    if not 1 <= capl <= _MAX_CAPL:
        raise ValueError(f"capl must be in [1, {_MAX_CAPL}]")


def sweep_kernel(tabs, se, st0, thr_hi: int, thr_lo: int, W: int,
                 capl: int, force_entry: bool, layout: str = "lane"):
    """Sweep: the CUDA kernel for CUDA tensors, sweep_plain for CPU
    tensors (same arguments and results). ``sweep_kernel.launches``
    counts kernel launches."""
    if se.device.type == "cpu":
        return sweep_plain(tabs, se, st0, thr_hi, thr_lo, W, capl,
                           force_entry, layout)
    if se.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {se.device}")
    _check_sweep_args(tabs, se, st0, capl, layout)
    n = se.shape[1]
    dev = se.device
    xs = torch.empty((7, n), dtype=_I32, device=dev)
    lists = [torch.empty((capl, n), dtype=_I32, device=dev)
             for _ in range(3)]
    _build.launch(
        "spsp_sweep", dev, *(a.data_ptr() for a in tabs), se.data_ptr(),
        st0.data_ptr(), thr_hi, thr_lo, n, W, capl, int(force_entry),
        int(layout == "col"), xs.data_ptr(),
        *(a.data_ptr() for a in lists))
    sweep_kernel.launches += 1
    return (xs, *lists)


sweep_kernel.launches = 0


def _run_sweep(sweep, tabs, j0, lastiv, W, state0: FieldState, start,
               end, active, force_entry, thr_hi, thr_lo, capl, layout):
    """Returns (exit_state, cnt, pos_list, pval_list, plast_list)."""
    se = torch.stack([start.to(_I32), end.to(_I32), active.to(_I32),
                      j0.to(_I32), lastiv.to(_I32)])
    st0 = torch.stack([a.to(_I32) for a in state0])
    xs, lp, lv, ll = sweep(tabs, se, st0, thr_hi, thr_lo, W, capl,
                           force_entry, layout)
    return FieldState(*xs[:6]), xs[6], lp, lv, ll


# ----------------------------------------------------------------------
# resolve
# ----------------------------------------------------------------------

def _pow2_ge(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _capl(sel_cap: int, n: int) -> int:
    """Per-lane list capacity: ~8x headroom over the expected occupancy
    (overflowing lanes raise status)."""
    return min(128, max(16, _pow2_ge(-((-8 * sel_cap) // max(n, 1)))))


def _sel(h_hi, h_lo, thr_hi: int, thr_lo: int) -> torch.Tensor:
    """FHS select bit: hash <= threshold (unsigned)."""
    return U.key(U.join(h_hi, h_lo)) <= U.key_int((thr_hi << 32) | thr_lo)


def _resolve_lanes(t, fs, W, capl, lane_base, lastiv, live, is_head, head,
                   thr_hi, thr_lo, sweep, layout, gate_passes):
    """Sweep 1 plus the prefix passes over every lane.

    fs: each lane's first sync column (256: none). is_head marks lanes
    whose predecessor state is ``head`` (the (val, h_hi, h_lo, p,
    last_ev) entry, per lane) instead of the previous lane's exit. With
    gate_passes (the v2 path, fused.py:411-415) passes 2.. run only when
    pass 1 left a lane pending: one host sync instead of three sweeps in
    the common case. Returns a dict of per-lane results."""
    n = lane_base.numel()
    dev = lane_base.device
    has_sync = fs < _B
    tabs = (t.h_hi, t.h_lo, t.cv, t.em, t.ep, t.eh_hi, t.eh_lo)
    zero = torch.zeros(n, dtype=_I32, device=dev)
    neg = torch.full((n,), -1, dtype=_I32, device=dev)
    zst = FieldState(zero, neg, neg, zero, neg, zero)

    st1, c_suf, suf_p, suf_v, suf_l = _run_sweep(
        sweep, tabs, lane_base, lastiv, W, zst, fs,
        torch.full((n,), _B, dtype=_I32, device=dev), has_sync, True,
        thr_hi, thr_lo, capl, layout)
    exit_ = list(st1[:5])
    exit_known = has_sync | ~live

    def pred(a, headv):
        return torch.where(is_head, headv, torch.cat([a[:1], a[:-1]]))

    prefix_done = ~live
    prefix_ev = zero
    pre_val = zero
    pre_le = neg
    c_pre = zero
    lzero = torch.zeros((capl, n), dtype=_I32, device=dev)
    pre_p = pre_v = pre_l = lzero
    for i in range(_MAX_PASSES):
        can = ~prefix_done & pred(exit_known, True)
        # a pass that finds no lane pending leaves every later one idle
        if gate_passes and i == 1 and not bool(can.any()):
            break
        st0 = FieldState(*(pred(a, h) for a, h in zip(exit_, head)),
                         n_ev=zero)
        st2, c2, p2, v2, l2 = _run_sweep(
            sweep, tabs, lane_base, lastiv, W, st0, zero, fs, can, False,
            thr_hi, thr_lo, capl, layout)
        pre_p = torch.where(can, p2, pre_p)
        pre_v = torch.where(can, v2, pre_v)
        pre_l = torch.where(can, l2, pre_l)
        c_pre = torch.where(can, c2, c_pre)
        prefix_ev = torch.where(can, st2.n_ev, prefix_ev)
        pre_val = torch.where(can, st2.val, pre_val)
        pre_le = torch.where(can, st2.last_ev, pre_le)
        # a syncless lane's prefix is the whole lane: its end state is
        # the lane exit
        newly = can & ~has_sync
        exit_ = [torch.where(newly, s, e) for s, e in zip(st2[:5], exit_)]
        exit_known = exit_known | newly
        prefix_done = prefix_done | can

    # deferred entry emits: each sync event closes the super-k-mer held
    # at the end of its own prefix
    e_sel = has_sync & (((pre_val >> 31) & 1) == 1)
    return dict(
        open=~prefix_done, over_suf=c_suf > capl, over_pre=c_pre > capl,
        counts=c_pre + e_sel.to(_I32) + c_suf, c_pre=c_pre, e_sel=e_sel,
        pre=(pre_p, pre_v, pre_l), suf=(suf_p, suf_v, suf_l),
        ent=(lane_base + fs, pre_val, pre_le + 1),
        n_ev=st1.n_ev + prefix_ev, exit=exit_)


def _rank_to_lane(offs, counts, sel_cap: int):
    """Lane owning each output rank in [0, sel_cap): scatter each
    non-empty lane's id at its start rank, then a running max fills
    the gaps. Ranks past the total return the last non-empty lane;
    callers mask them out."""
    starts = offs - counts
    lanes = torch.arange(counts.numel(), dtype=_I64, device=offs.device)
    tgt = torch.where(counts > 0, starts, sel_cap)
    keep = tgt < sel_cap
    seed = torch.zeros(sel_cap, dtype=_I64, device=offs.device)
    seed.scatter_reduce_(0, tgt[keep], lanes[keep], "amax")
    return torch.cummax(seed, 0).values


def _extract(r, sel_cap: int, capl: int):
    """Selected boundaries in global rank order: per lane the prefix
    list, the entry event, the suffix list; lanes ascend. Returns
    (pos, last, val|rev<<30|sel<<31) of sel_cap ranks (pad -1, -1, 0)
    and n_sel."""
    counts = r["counts"]
    n = counts.numel()
    offs = torch.cumsum(counts, 0)
    n_sel = counts.sum()
    iidx = torch.arange(sel_cap, dtype=_I64, device=counts.device)
    lane = torch.clamp(_rank_to_lane(offs, counts, sel_cap), 0, n - 1)
    r_in = iidx - (offs[lane] - counts[lane])
    cp = r["c_pre"][lane]
    es = r["e_sel"][lane]
    in_pre = r_in < cp
    is_ent = (r_in == cp) & es
    pre_idx = torch.clamp(r_in, 0, capl - 1) * n + lane
    suf_idx = torch.clamp(r_in - cp - es.to(_I64), 0, capl - 1) * n + lane
    ok = iidx < n_sel

    def pick(i, pad):
        v = torch.where(in_pre, r["pre"][i].reshape(-1)[pre_idx],
                        torch.where(is_ent, r["ent"][i][lane],
                                    r["suf"][i].reshape(-1)[suf_idx]))
        return torch.where(ok, v, pad)

    return pick(0, -1), pick(2, -1), pick(1, 0), n_sel


def _vals(x):
    """(value, rev, sel) of val|rev<<30|sel<<31 bit patterns."""
    return x & _M30, (x >> 30) & 1, (x >> 31) & 1


def resolve_field(t: FieldTables, k: int, m: int, sel_cap: int,
                  entry: torch.Tensor, thr_hi: int, thr_lo: int,
                  sweep=sweep_kernel) -> torch.Tensor:
    """Resolve the whole event chain of one sequence.

    entry: int32[8] machine state entering this region, [val|rev<<30|
    sel<<31, h_hi, h_lo, p, last_ev, n_ev_prior, 0, 0] (field_entry_init
    or field_carry). sweep: the sweep implementation (sweep_kernel
    dispatches by device).

    Returns one int32 fetch array:
      [status, n_sel, n_ev, last_ev_pos, tail_val, tail_rev, tail_sel,
       exit_val, exit_h_hi, exit_h_lo, exit_p, exit_last_ev,
       pos[cap], last[cap], val[cap], rev[cap]]
    status != 0 => unresolved lanes, a list overflow or a flag."""
    fs = _first_sync(t.sync, t.h_hi.numel() // _B)
    return _resolve_field(t, fs, k, m, sel_cap, entry, thr_hi, thr_lo,
                          sweep, "lane", False)


def _resolve_field(t: FieldTables, fs, k: int, m: int, sel_cap: int,
                   entry: torch.Tensor, thr_hi: int, thr_lo: int, sweep,
                   layout: str, gate_passes: bool) -> torch.Tensor:
    """resolve_field from the lanes' first syncs fs (t.sync unread),
    tables in ``layout``."""
    W = k - m + 1
    n = t.h_hi.numel() // _B
    dev = t.h_hi.device
    capl = _capl(sel_cap, n)
    lanes = torch.arange(n, dtype=_I32, device=dev)
    lane_base = lanes * _B
    r = _resolve_lanes(t, fs, W, capl, lane_base, t.last_i.expand(n),
                       lane_base <= t.last_i, lanes == 0, entry[:5],
                       thr_hi, thr_lo, sweep, layout, gate_passes)
    status = (r["open"].sum() + r["over_suf"].sum() + r["over_pre"].sum()
              + t.eflag.to(_I64))
    pos, last, valw, n_sel = _extract(r, sel_cap, capl)
    n_ev = r["n_ev"].sum() + entry[5]

    # tail/carry: the last live lane's exit; with no live lane the
    # entry passes through
    lane_q = torch.clamp(t.last_i // _B, 0, n - 1)
    no_live = t.last_i < 0
    x = [torch.where(no_live, e, ex[lane_q])
         for e, ex in zip(entry[:5], r["exit"])]
    head = torch.stack([a.to(_I32) for a in (
        status, n_sel, n_ev, x[4], *_vals(x[0]), *x)])
    val, rev, _ = _vals(valw)
    return torch.cat([head, pos, last, val, rev]).to(_I32)


def resolve_field_batched(t: BatchedFieldTables, k: int, m: int,
                          sel_cap: int, P_rec: int, thr_hi: int,
                          thr_lo: int, sweep=sweep_kernel) -> torch.Tensor:
    """Resolve the event chains of a whole record batch. Lanes carry
    record-local positions, and each record's head lane starts from the
    record's window-0 election (reference SubSampler.cpp:359-365).

    Returns one int32 fetch array:
      [global_status, n_sel_total,
       B x _BHEAD heads: (status, n_sel, n_ev, last_ev_pos, tail_val,
                          tail_rev, tail_sel, 0),
       pos[sel_cap], last[sel_cap], val[sel_cap], rev[sel_cap]]
    with record-major, record-local event lists. n_sel_total > sel_cap
    means truncated lists; a record's status != 0 means it is
    unresolved."""
    fs = _first_sync(t.sync, t.h_hi.numel() // _B)
    return _resolve_field_batched(t, fs, k, m, sel_cap, P_rec, thr_hi,
                                  thr_lo, sweep, "lane", False)


def _resolve_field_batched(t: BatchedFieldTables, fs, k: int, m: int,
                           sel_cap: int, P_rec: int, thr_hi: int,
                           thr_lo: int, sweep, layout: str,
                           gate_passes: bool) -> torch.Tensor:
    """resolve_field_batched from the lanes' first syncs fs (t.sync
    unread), tables in ``layout``."""
    W = k - m + 1
    B_n = t.last_i.numel()
    lpr = P_rec // _B
    n = t.h_hi.numel() // _B
    dev = t.h_hi.device
    capl = _capl(sel_cap, n)
    lanes = torch.arange(n, dtype=_I32, device=dev)
    lane_rec = torch.clamp(lanes // lpr, 0, B_n - 1).to(_I64)
    lane_base = (lanes % lpr) * _B
    lastiv = t.last_i[lane_rec]
    ent_val = t.init_val | (_sel(t.init_h_hi, t.init_h_lo, thr_hi, thr_lo)
                            .to(_I32) << 31)
    head = (ent_val[lane_rec], t.init_h_hi[lane_rec],
            t.init_h_lo[lane_rec], t.init_p[lane_rec],
            torch.full((n,), -1, dtype=_I32, device=dev))
    r = _resolve_lanes(t, fs, W, capl, lane_base, lastiv,
                       lane_base <= lastiv, lanes % lpr == 0, head, thr_hi,
                       thr_lo, sweep, layout, gate_passes)

    def per_record(v):
        return torch.zeros(B_n, dtype=_I64, device=dev).index_add_(
            0, lane_rec, v.to(_I64))

    bad = r["open"] | r["over_suf"] | r["over_pre"]
    status_rec = per_record(bad) + t.eflag.to(_I64)
    pos, last, valw, n_sel = _extract(r, sel_cap, capl)

    lane_q = (torch.arange(B_n, dtype=_I64, device=dev) * lpr
              + torch.clamp(t.last_i // _B, 0, lpr - 1))
    no_live = t.last_i < 0
    x_val = torch.where(no_live, ent_val, r["exit"][0][lane_q])
    x_le = torch.where(no_live, -1, r["exit"][4][lane_q])
    heads = torch.stack([a.to(_I32) for a in (
        status_rec, per_record(r["counts"]), per_record(r["n_ev"]), x_le,
        *_vals(x_val), torch.zeros_like(x_le))], 1)
    g = torch.stack([status_rec.sum(), n_sel]).to(_I32)
    val, rev, _ = _vals(valw)
    return torch.cat([g, heads.reshape(-1), pos, last, val, rev]).to(_I32)


def field_entry_init(t: FieldTables, thr_hi: int, thr_lo: int):
    """Entry state of a sequence's first region: the window-0 election
    (reference SubSampler.cpp:359-365) with its sel bit."""
    val = t.init_val | (_sel(t.init_h_hi, t.init_h_lo, thr_hi, thr_lo)
                        .to(_I32) << 31)
    z = torch.zeros((), dtype=_I32, device=val.device)
    return torch.stack([val, t.init_h_hi, t.init_h_lo, t.init_p.to(_I32),
                        z - 1, z, z, z])


def field_carry(arr: torch.Tensor, own: int) -> torch.Tensor:
    """Next tile's entry from this region's fetch array: the exit state
    re-based by -own (positions go local to the next tile)."""
    z = torch.zeros((), dtype=_I32, device=arr.device)
    return torch.stack([arr[7], arr[8], arr[9], arr[10] - own,
                        arr[11] - own, z, z, z])


def field_entry_to_walker_init(t: FieldTables, entry: torch.Tensor):
    """A field entry state as the exact walker's entering chain state
    (init5, fb = [value, rev]) for the same region (field.py:1253).

    The first event of the region is the first position whose entering
    hash strictly undercuts the held one (an adoption, reference
    SubSampler.cpp:374-388) or the expiry at the first position >= p
    (SubSampler.cpp:391-399); adoption wins a tie. cur_pos is the
    entry's last event (negative, local): the first emit's last
    position + 1 is the start of the super-k-mer carried in."""
    P = t.h_hi.numel()
    j = torch.arange(P, dtype=_I32, device=entry.device)
    lt = U.key(U.join(t.h_hi, t.h_lo)) < U.key(U.join(entry[1], entry[2]))
    j_adopt = torch.where(lt & (j <= t.last_i), j, P).min()
    p = entry[3]
    j_exp = torch.where(p <= t.last_i, torch.clamp(p, min=0), P)
    npos = torch.minimum(j_adopt, j_exp)
    init5 = torch.stack([
        torch.where(npos <= t.last_i, npos, -1),
        (j_adopt > j_exp).to(_I32), (entry[0] >> 31) & 1, entry[4],
        torch.zeros((), dtype=_I32, device=entry.device)]).to(_I32)
    fb = torch.stack([entry[0] & _M30, (entry[0] >> 30) & 1])
    return init5, fb


def walker_exit_to_field_entry(t: FieldTables, scal: torch.Tensor,
                               entry: torch.Tensor, k: int, m: int,
                               own: int, thr_hi: int,
                               thr_lo: int) -> torch.Tensor:
    """The walker's exit state after a fallback tile as the next tile's
    field entry, re-based by -own (field.py:1295). The state held after
    the last event comes from the field tables there: an adoption at j
    holds the entering m-mer (cv, h, p = j + W), a rescan the window
    election (em, eh, p = ep + j + 1, the reference's position_min +=
    i + 1, SubSampler.cpp:397). With no event the entry passes through."""
    W = k - m + 1
    P = t.h_hi.numel()
    cur_pos, cur_typ = scal[1], scal[2]
    no_ev = cur_pos < 0
    pc = torch.clamp(cur_pos, 0, P - 1)
    is_a = cur_typ == 0
    val = torch.where(is_a, t.cv[pc], t.em[pc])
    hh = torch.where(is_a, t.h_hi[pc], t.eh_hi[pc])
    hl = torch.where(is_a, t.h_lo[pc], t.eh_lo[pc])
    p_new = torch.where(is_a, pc + W, t.ep[pc] + pc + 1)
    valb = val | (_sel(hh, hl, thr_hi, thr_lo).to(_I32) << 31)
    z = torch.zeros((), dtype=_I32, device=scal.device)
    return torch.stack([
        torch.where(no_ev, entry[0], valb), torch.where(no_ev, entry[1], hh),
        torch.where(no_ev, entry[2], hl),
        torch.where(no_ev, entry[3], p_new) - own,
        torch.where(no_ev, entry[4], cur_pos) - own, z, z, z]).to(_I32)


def _use_fused(device: torch.device) -> bool:
    """Whether the single and batch routes take the v2 path
    (ops/fused.py): only on a CUDA device and only with SPSP_FUSED set
    and not "0" (supersampler_tpu/ops/field.py:1162). v1 is the
    default."""
    return (device.type == "cuda"
            and os.environ.get("SPSP_FUSED", "0") != "0")


def scan_resolve_single(slab: torch.Tensor, k: int, m: int, P: int,
                        sel_cap: int, length: int, thr_hi: int,
                        thr_lo: int) -> torch.Tensor:
    """Scan, entry and resolve of a single-tile record. slab: the
    record's packed bytes with a 128-position (32-byte) leading halo,
    (128 + P) / 4 bytes. Returns resolve_field's fetch array."""
    if _use_fused(slab.device):
        from supersampler_tpu_torch.ops.fused import fused_single

        return fused_single(slab, k, m, P, sel_cap, length, thr_hi, thr_lo)
    t = scan_field_2d_packed(slab[32:], k, m, P, length)
    entry = field_entry_init(t, thr_hi, thr_lo)
    return resolve_field(t, k, m, sel_cap, entry, thr_hi, thr_lo)


def scan_resolve_batch(packed: torch.Tensor, k: int, m: int, P_rec: int,
                       sel_cap: int, lengths: torch.Tensor, thr_hi: int,
                       thr_lo: int) -> torch.Tensor:
    """Scan and resolve of a (B, P_rec/4) packed record batch. Returns
    resolve_field_batched's fetch array."""
    if _use_fused(packed.device):
        from supersampler_tpu_torch.ops.fused import fused_batch

        return fused_batch(packed, k, m, P_rec, sel_cap, lengths, thr_hi,
                           thr_lo)
    t = scan_field_batched(packed, k, m, P_rec, lengths)
    return resolve_field_batched(t, k, m, sel_cap, P_rec, thr_hi, thr_lo)


# ----------------------------------------------------------------------
# host-side parsing of the fetch arrays (numpy)
# ----------------------------------------------------------------------

def parse_batched_heads(arr: np.ndarray, cap: int, B_n: int):
    """Split resolve_field_batched's fetch array: (global_status,
    n_sel_total, heads (B_n, _BHEAD) i32, pos, last, val u32, rev).
    Truncation (n_total > cap) returns None bodies; the caller
    re-dispatches with a bigger cap."""
    gstatus = int(arr[0])
    n_total = int(arr[1])
    heads = arr[2 : 2 + _BHEAD * B_n].reshape(B_n, _BHEAD)
    if n_total > cap:
        return gstatus, n_total, heads, None, None, None, None
    body = arr[2 + _BHEAD * B_n:]
    return (gstatus, n_total, heads, body[:cap], body[cap : 2 * cap],
            body[2 * cap : 3 * cap].view(np.uint32),
            body[3 * cap : 4 * cap])


def parse_batched_array(arr: np.ndarray, cap: int, B_n: int):
    """Split resolve_field_batched's fetch array into (global_status,
    n_sel_total, per-record compact 9-tuples, per-record status).
    Truncation (n_sel_total > cap) returns comps None; the caller
    re-dispatches with a bigger cap (supersampler_tpu/ops/field.py:1134)."""
    gstatus, n_total, heads, pos, last, val, rev = parse_batched_heads(
        arr, cap, B_n)
    if pos is None:
        return gstatus, n_total, None, None
    offs = np.concatenate([[0], np.cumsum(heads[:, 1].astype(np.int64))])
    comps = []
    for b in range(B_n):
        s, e = int(offs[b]), int(offs[b + 1])
        comps.append((
            pos[s:e].astype(np.int64), last[s:e].astype(np.int64),
            val[s:e], rev[s:e] != 0, int(heads[b, 2]),
            int(heads[b, 3]), int(np.int64(heads[b, 4]) & 0xFFFFFFFF),
            bool(heads[b, 5]), bool(heads[b, 6])))
    return gstatus, n_total, comps, heads[:, 0].astype(np.int64)


def parse_field_array(arr: np.ndarray, cap: int):
    """Split resolve_field's fetch array into (status, compact 9-tuple,
    n_sel)."""
    status = int(arr[0])
    n_sel = int(arr[1])
    body = arr[_HEAD : _HEAD + 4 * cap]
    sel_pos = body[:n_sel].astype(np.int64)
    sel_last = body[cap : cap + n_sel].astype(np.int64)
    sel_val = body[2 * cap : 2 * cap + n_sel].view(np.uint32)
    sel_rev = body[3 * cap : 3 * cap + n_sel] != 0
    comp = (sel_pos, sel_last, sel_val, sel_rev, int(arr[2]),
            int(arr[3]), int(np.int64(arr[4]) & 0xFFFFFFFF),
            bool(arr[5]), bool(arr[6]))
    return status, comp, n_sel
