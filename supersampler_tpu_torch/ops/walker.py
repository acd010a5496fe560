"""The exact fallback engine's chain walk, compaction and carry.

Counterpart of supersampler_tpu/ops/walker.py. The successor tables
(ops/minimizer.py ``succ_tables``) give, for every position and event
type, the next event; the super-k-mer boundary chain is their walk from
the window-0 election (reference SubSampler.cpp:367-454). ``pack_succ``
packs both tables and the select bits into one int32 per position,
``walk_kernel`` chases the chain (the CUDA kernel csrc/walk.cu on a CUDA
tensor: per-block transfer maps composed across blocks, then every block
re-walked from its true entry; ``walk_plain`` on a CPU tensor),
``_compact_emits`` gathers the selected boundaries and their payloads
into one fetch array, and ``_carry_next`` hands the walk's final state
to the next tile without a host read.

Packed word layout (bits), per loop position j; the two node types sit
in symmetric 16-bit halves, so the walker decodes with one shift by
typ * 16:
  [0:6]   delta_a   next-event distance from the A(doption) node (0 = none)
  [6]     typ_a     next event type from the A node (0 = A, 1 = R(escan))
  [7]     sel_a     FHS-selected bit of the A node's payload
  [16:22] delta_r   the same three fields for the R node
  [22]    typ_r
  [23]    sel_r

Walk outputs (the ``walk_pallas`` contract, walker.py:157): per
2048-position block b, emit rows ei/el/es (boundary position, last
position + 1, source state 2*pos + typ or -1) for the transitions into
events inside block b, ``cnt[b]`` rows, -1 past them; and
``scal = [n_ev, cur_pos, cur_typ, cur_sel, nxt_pos, nxt_typ]``.
"""

from __future__ import annotations

import numpy as np
import torch

from supersampler_tpu_torch.ops import _build
from supersampler_tpu_torch.ops.field import _pow2_ge
from supersampler_tpu_torch.ops.minimizer import ScanTables

_I32 = torch.int32
_I64 = torch.int64
_BP = 2048          # positions per emit block


def pack_succ(t: ScanTables, n_pad: int) -> torch.Tensor:
    """Both successor tables and the sel bits as one int32 per position,
    zero-padded (delta 0 = the chain ends) or truncated to n_pad.
    Truncation is the tiled path: positions >= n_pad belong to the next
    tile; successor targets may still point past n_pad (the carry)."""
    n = t.nxt_pos_a.numel()
    j = torch.arange(n, dtype=_I32, device=t.nxt_pos_a.device)
    da = torch.where(t.nxt_pos_a >= 0, t.nxt_pos_a - j, 0)
    dr = torch.where(t.nxt_pos_r >= 0, t.nxt_pos_r - j, 0)
    ta = (~t.nxt_adopt_a).to(_I32)
    tr = (~t.nxt_adopt_r).to(_I32)
    w = (da | (ta << 6) | (t.sel_a.to(_I32) << 7)
         | (dr << 16) | (tr << 22) | (t.sel_r.to(_I32) << 23))
    if n_pad > n:
        return torch.cat([w, w.new_zeros(n_pad - n)])
    return w[:n_pad].contiguous()


def make_init5(init_nxt_pos: torch.Tensor, init_nxt_typ, init_sel,
               cur_pos=-1, cur_typ=0) -> torch.Tensor:
    """Entering chain state of a walk: [nxt_pos, nxt_typ, cur_sel,
    cur_pos, cur_typ] int32 on init_nxt_pos's device. cur_pos < 0 means
    the open super-k-mer began before this walk (its payload is the
    fallback pair fb)."""
    dev = init_nxt_pos.device
    return torch.stack([torch.as_tensor(a, device=dev).to(_I32).reshape(())
                        for a in (init_nxt_pos, init_nxt_typ, init_sel,
                                  cur_pos, cur_typ)])


def _init5_from_tables(t: ScanTables) -> torch.Tensor:
    """Entering state of a sequence's first walk: the scan's window-0
    election (reference SubSampler.cpp:359-365)."""
    return make_init5(t.init_nxt_pos, ~t.init_nxt_adopt, t.init_sel)


def _fb_from_tables(t: ScanTables) -> torch.Tensor:
    """Fallback payload [value, rev] of a sequence's first walk: the
    window-0 election's."""
    return torch.stack([t.init_val.to(_I32), t.init_rev.to(_I32)])


def walk_plain(packed: torch.Tensor, init5: torch.Tensor):
    """Plain walk: a Python loop over integers (the words are taken to a
    list once). The kernel's executable spec; same arguments and
    results as walk_kernel."""
    n_pad = packed.numel()
    _check_walk_args(packed, init5)
    words = packed.tolist()
    npos, ntyp, cur_sel, cur_pos, cur_typ = init5.tolist()
    n_blocks = n_pad // _BP
    cnt = [0] * n_blocks
    rows, ei, el, es = [], [], [], []
    n_ev = 0
    while 0 <= npos < n_pad:
        if cur_sel:
            b = npos // _BP
            rows.append(b * _BP + cnt[b])
            cnt[b] += 1
            ei.append(npos)
            el.append(cur_pos + 1)
            es.append(-1 if cur_pos < 0 else 2 * cur_pos + cur_typ)
        h = words[npos] >> (ntyp << 4)
        delta = h & 63
        cur_pos, cur_typ, cur_sel = npos, ntyp, (h >> 7) & 1
        npos = npos + delta if delta > 0 else -1
        ntyp = (h >> 6) & 1
        n_ev += 1
    outs = []
    for vals in (ei, el, es):
        a = np.full(n_pad, -1, np.int32)
        a[rows] = vals
        outs.append(torch.from_numpy(a).view(n_blocks, _BP)
                    .to(packed.device))
    scal = [n_ev, cur_pos, cur_typ, cur_sel, npos, ntyp]
    return (*outs, torch.tensor(cnt, dtype=_I32, device=packed.device),
            torch.tensor(scal, dtype=_I32, device=packed.device))


def _check_walk_args(packed, init5):
    n_pad = packed.numel()
    if (packed.dtype != _I32 or packed.dim() != 1 or n_pad == 0
            or n_pad % _BP or not packed.is_contiguous()):
        raise ValueError(f"packed must be contiguous int32 [n_pad], "
                         f"n_pad a positive multiple of {_BP}")
    if (init5.dtype != _I32 or init5.shape != (5,)
            or init5.device != packed.device or not init5.is_contiguous()):
        raise ValueError("init5 must be contiguous int32 (5,) on packed's "
                         "device")


def walk_kernel(packed: torch.Tensor, init5: torch.Tensor):
    """Chain walk over packed successor words (n_pad a multiple of
    2048): the CUDA kernel for CUDA tensors, walk_plain for CPU tensors.
    Returns (ei, el, es (n_blocks, 2048), cnt (n_blocks,), scal (6,)),
    int32, -1 past each block's cnt rows. ``walk_kernel.launches``
    counts kernel launches."""
    if packed.device.type == "cpu":
        return walk_plain(packed, init5)
    if packed.device.type != "cuda":
        raise ValueError(f"no walk kernel for device {packed.device}")
    _check_walk_args(packed, init5)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    n_blocks = packed.numel() // _BP
    dev = packed.device
    outs = [torch.empty((n_blocks, _BP), dtype=_I32, device=dev)
            for _ in range(3)]
    cnt = torch.empty(n_blocks, dtype=_I32, device=dev)
    scal = torch.empty(6, dtype=_I32, device=dev)
    work = torch.empty(_build.lib().spsp_walk_work_bytes(n_blocks),
                       dtype=torch.uint8, device=dev)
    _build.launch("spsp_walk", dev, packed.data_ptr(), n_blocks,
                  init5.data_ptr(), *(a.data_ptr() for a in outs),
                  cnt.data_ptr(), scal.data_ptr(), work.data_ptr())
    walk_kernel.launches += 1
    return (*outs, cnt, scal)


walk_kernel.launches = 0


def _payload(t: ScanTables, src, fb):
    """(value, rev) int32 of source states 2*pos + typ; src < 0 takes
    the fallback pair fb = [value, rev]."""
    p = torch.clamp(src >> 1, 0, t.val_a.numel() - 1)
    is_a = (src & 1) == 0
    val = torch.where(src < 0, fb[0],
                      torch.where(is_a, t.val_a[p], t.val_r[p]))
    rev = torch.where(src < 0, fb[1],
                      torch.where(is_a, t.rev_a[p], t.rev_r[p]).to(_I32))
    return val, rev


def _compact_emits(ei, el, es, cnt, scal, t: ScanTables, sel_cap: int,
                   fb):
    """Flatten the per-block emit rows into sel_cap slots and gather the
    payload (value, strand) of each selected boundary and of the tail.

    fb = [value, rev] is the payload of super-k-mers opened before this
    walk (source < 0): the window-0 election for a sequence's first
    tile, the carried payload for later tiles. Returns (pos, last, val,
    rev, n_sel, n_ev, last_pos, tail_val, tail_rev, tail_sel)."""
    n_blocks, bp = ei.shape
    cum = torch.cumsum(cnt.to(_I64), 0)
    n_sel = cum[-1]
    s = torch.arange(sel_cap, dtype=_I64, device=ei.device)
    blk = torch.clamp(torch.searchsorted(cum, s, right=True), 0,
                      n_blocks - 1)
    prev = torch.where(blk > 0, cum[torch.clamp(blk - 1, min=0)], 0)
    row = torch.clamp(s - prev, 0, bp - 1)
    ok = s < n_sel
    flat = blk * bp + row
    pos = torch.where(ok, ei.reshape(-1)[flat], -1)
    last = torch.where(ok, el.reshape(-1)[flat], -1)
    src = torch.where(ok, es.reshape(-1)[flat], -1)
    val, rev = _payload(t, src, fb)
    tail_src = torch.where(scal[1] >= 0, 2 * scal[1] + scal[2], -1)
    tail_val, tail_rev = _payload(t, tail_src.reshape(1), fb)
    return (pos, last, val, rev, n_sel, scal[0], scal[1], tail_val[0],
            tail_rev[0], scal[3])


def pack_compact_outs(outs, scal) -> torch.Tensor:
    """_compact_emits outputs as one int32 fetch array: [n_sel, n_ev,
    last_pos, tail_val, tail_rev, tail_sel, nxt_pos, nxt_typ, pos[cap],
    last[cap], val[cap], rev[cap]]."""
    (pos, last, val, rev, n_sel, n_ev, last_pos, tail_val, tail_rev,
     tail_sel) = outs
    head = torch.stack([a.to(_I32).reshape(()) for a in (
        n_sel, n_ev, last_pos, tail_val, tail_rev, tail_sel, scal[4],
        scal[5])])
    return torch.cat([head, *(a.to(_I32) for a in (pos, last, val, rev))])


def parse_compact_array(arr: np.ndarray, cap: int):
    """Host split of a pack_compact_outs array into the compact 9-tuple
    (sel_pos, sel_last, sel_val, sel_rev, n_ev, last_ev_pos, tail_val,
    tail_rev, tail_sel)."""
    n_sel = int(arr[0])
    body = arr[8 : 8 + 4 * cap]
    sel_pos = body[:n_sel].astype(np.int64)
    sel_last = body[cap : cap + n_sel].astype(np.int64)
    sel_val = body[2 * cap : 2 * cap + n_sel].view(np.uint32)
    sel_rev = body[3 * cap : 3 * cap + n_sel] != 0
    return (sel_pos, sel_last, sel_val, sel_rev, int(arr[1]),
            int(arr[2]), int(np.int64(arr[3]) & 0xFFFFFFFF),
            bool(arr[4]), bool(arr[5]))


def _carry_next(scal, t: ScanTables, fb, own: int):
    """A walk's final state re-based into the NEXT tile's coordinates,
    with the open super-k-mer's payload resolved by value. Returns
    (init5, fb) on the device: chaining tiles never reads the host."""
    cur_pos, cur_typ, cur_sel, npos, ntyp = scal[1:6]
    val, rev = _payload(t, torch.where(cur_pos < 0, -1,
                                       2 * cur_pos + cur_typ), fb)
    init5 = make_init5(torch.where(npos >= 0, npos - own, -1), ntyp,
                       cur_sel, cur_pos - own, cur_typ)
    return init5, torch.stack([val, rev]).to(_I32)


def _sel_cap(n: int) -> int:
    return max(16, _pow2_ge(n))


class DeviceChain:
    """Walk and speculative compaction of one walk region.

    The walk and a compaction at ``sel_cap_guess`` run at construction;
    ``compact`` reads the host once, and compacts again only when the
    guess was too small. ``DeviceChain(t)`` walks a whole single-tile
    sequence from the window-0 election; a tile of a longer sequence
    passes its entering state (init5, fb) and n_pad = the owned size.
    pack=False skips the compaction: the device-dedup path
    (sketch/pipeline.py DedupDeviceChain) takes ``compact_outs``."""

    def __init__(self, t: ScanTables, sel_cap_guess: int = 4096,
                 init5=None, fb=None, n_pad: int | None = None,
                 pack: bool = True):
        if n_pad is None:
            n_pad = -(-t.nxt_pos_a.numel() // _BP) * _BP
        self._t = t
        self._fb = _fb_from_tables(t) if fb is None else fb
        init5 = _init5_from_tables(t) if init5 is None else init5
        (self.ei, self.el, self.es, self.cnt,
         self.scal) = walk_kernel(pack_succ(t, n_pad), init5)
        self._cap = _sel_cap(sel_cap_guess)
        if pack:
            self._arr = self._compacted()
        self.n_sel = None

    def compact_outs(self, sel_cap: int):
        """The _compact_emits outputs at sel_cap slots, on the device."""
        return _compact_emits(self.ei, self.el, self.es, self.cnt,
                              self.scal, self._t, sel_cap, self._fb)

    def _compacted(self) -> torch.Tensor:
        return pack_compact_outs(self.compact_outs(self._cap), self.scal)

    def carry(self, own: int):
        """(init5, fb) of the next tile's walk, on the device."""
        return _carry_next(self.scal, self._t, self._fb, own)

    def compact(self):
        """The compact 9-tuple, positions local to this walk; also sets
        self.n_sel."""
        arr = self._arr.cpu().numpy()
        n_sel = int(arr[0])
        if n_sel > self._cap:
            self._cap = _sel_cap(n_sel)
            self._arr = self._compacted()
            arr = self._arr.cpu().numpy()
        self.n_sel = n_sel
        return parse_compact_array(arr, self._cap)
