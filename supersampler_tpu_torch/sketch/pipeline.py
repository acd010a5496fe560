"""Sketch construction on the sync-field engine, in PyTorch.

Counterpart of supersampler_tpu/sketch/pipeline.py. Records stream from
the FASTA in chunks and take one of three routes, with the JAX
pipeline's thresholds:

* short records (padded size <= _SHORT_MAX) go in per-size batches
  through ``scan_resolve_batch``;
* other records that fit one tile go through ``scan_resolve_single``;
* longer records go through FieldChain, one 4 Mbp tile after another,
  carrying the machine state between tiles with ``field_carry``.

Where the field resolve cannot settle a region (status != 0: a sync
desert such as a kilobase homopolymer, a per-lane list overflow) that
region re-runs through the exact fallback engine: successor tables and
the serial chain walk (ops/walker.py). FieldChain re-runs only the
failing tile and converts the machine state at its edges; a failing
single-tile record goes through a one-tile TiledDeviceChain; a failing
short record goes through the walker on its own, in its place in the
record order. ``scan_engine = "legacy"`` sends every record through the
walker.

Each route fetches one compact array per record, tile or batch; the
native C finisher (supersampler_tpu_torch.native, csrc/spsp_finish.c) dedups,
reconstructs and serializes in record order, so the bytes match the
reference.

Two opt-ins (``TorchSubsampler.device_dedup`` and ``native_finisher``)
send every record of a sketch through ``_launch_scan`` instead, JAX's
per-record routes: a FieldChain, a single walk (DeviceChain, or with
device dedup DedupDeviceChain) or a TiledDeviceChain. With
``device_dedup`` each region's fetch also carries its unique selected
k-mers (ops/dedup.py), merged into the Python k-mer store
(sketch/store.py); with ``native_finisher = False`` the Python store
takes every selected super-k-mer. The bytes are the same.

Every sketch, of one file or of a file of files, runs through
``sketch_fof`` (``_SharedSketchRun``): one reader thread, a
2-worker prep pool (the C clean + pack, which releases the GIL), one
device thread that issues all device work in file-major record order,
and assembly on the calling thread in the same order, with a bounded
number of chunks in flight. Its layers time themselves with
``utils.profiling.phase``: parse, prep, dispatch, device+fetch,
assemble and serialize.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from supersampler_tpu_torch.core.scalar import MASK64, format_double
from supersampler_tpu_torch.io.fasta import stream_fasta_spans
from supersampler_tpu_torch.native import (NativeFinisher,
                                           clean_pack_batch_native,
                                           clean_pack_native)
from supersampler_tpu_torch.ops.dedup import (dedup_chain_packed,
                                              field_dedup_packed,
                                              merge_unique_host,
                                              parse_dedup_array,
                                              parse_field_dedup_array)
from supersampler_tpu_torch.ops.field import (_HEAD, _pow2_ge, field_carry,
                                              field_entry_init,
                                              field_entry_to_walker_init,
                                              parse_batched_heads,
                                              parse_field_array,
                                              resolve_field,
                                              scan_field_2d_packed,
                                              scan_resolve_batch,
                                              scan_resolve_single,
                                              walker_exit_to_field_entry)
from supersampler_tpu_torch.ops.minimizer import (scan_tables_2d_packed,
                                                  succ_tables)
from supersampler_tpu_torch.ops.walker import DeviceChain
from supersampler_tpu_torch.sketch.store import KmerStore, SubsamplerState
from supersampler_tpu_torch.utils.profiling import device_trace, phase

# tile geometry: sequences longer than one tile stream through fixed
# (OWN + EXTRA)-position scans chained by a carried machine state
_TILE_OWN = 1 << 22       # loop positions owned per tile (4 Mbp)
_TILE_EXTRA = 512         # lookahead suffix; >= margin for k <= 63
_PAD_BUCKETS = [1 << b for b in range(10, 23)]


def padded_size(n: int, margin: int = 128) -> int:
    """Power-of-two padding of a single-tile record, with room for the
    lookahead halo."""
    for b in _PAD_BUCKETS:
        if n + margin <= b:
            return b
    raise ValueError(f"not a single-tile sequence: {n}")


def _fetch(arr: torch.Tensor) -> np.ndarray:
    with phase("device+fetch"):
        return arr.cpu().numpy()


def _compact(dc: DeviceChain):
    with phase("device+fetch"):
        return dc.compact()


def _merge_tiles(parts, own: int):
    """Per-tile compact 9-tuples (tile order) as one sequence-level
    9-tuple with global positions; the tail is the last tile's."""
    pos_l, last_l, val_l, rev_l = [], [], [], []
    n_ev = 0
    for t, (sp, sl, sv, sr, ev_t, last_pos_t, tv, tr, ts) in enumerate(
            parts):
        pos_l.append(sp + t * own)
        last_l.append(sl + t * own)
        val_l.append(sv)
        rev_l.append(sr)
        n_ev += ev_t
    return (np.concatenate(pos_l), np.concatenate(last_l),
            np.concatenate(val_l), np.concatenate(rev_l), n_ev,
            last_pos_t + t * own, tv, tr, ts)


class DedupDeviceChain:
    """Walk and on-device k-mer dedup of one region (pipeline.py:83):
    one fetch carries the compact boundaries and the unique k-mers
    (ops/dedup.py dedup_chain_packed).

    packed_ext: the region's 2-bit codes with the 128-position halo on
    the device, P_ext positions; the tables were scanned from the part
    after the halo. length: local sequence length, or -1 for a non-final
    tile (no tail flush here). After ``compact``: n_sel, n_kmers and
    uniques_list (one entry, for merge_unique_host)."""

    def __init__(self, tables, packed_ext: torch.Tensor, P_ext: int, k: int,
                 m: int, length: int, sel_cap_guess: int = 4096,
                 kmer_cap_guess: int = 8192, init5=None, fb=None,
                 n_pad: int | None = None):
        self._dc = DeviceChain(tables, sel_cap_guess, init5=init5, fb=fb,
                               n_pad=n_pad, pack=False)
        self.scal = self._dc.scal
        self._k, self._m = k, m
        self._packed_ext = packed_ext
        self._P_ext = P_ext
        self._len = length
        self._cap = _pow2_ge(sel_cap_guess)
        self._K = _pow2_ge(kmer_cap_guess)
        self._arr = self._dispatch()
        self.n_sel = self.n_kmers = self.uniques_list = None

    def _dispatch(self) -> torch.Tensor:
        return dedup_chain_packed(self._dc.compact_outs(self._cap), self.scal,
                                  self._packed_ext, self._len, self._k,
                                  self._m, self._P_ext, self._K)

    def carry(self, own: int):
        """(init5, fb) of the next tile's walk, on the device."""
        return self._dc.carry(own)

    def compact(self):
        """The compact 9-tuple, positions local to this walk. Retries at
        bigger capacities while the span list or the k-mer rows were
        cut; a cut span list undercounts n_kmers, so K is bounded by the
        spans times a super-k-mer's most k-mers."""
        arr = self._arr.cpu().numpy()
        while True:
            n_sel = int(arr[0])
            n_kmers = int(arr[8 + 4 * self._cap])
            if n_sel <= self._cap and n_kmers <= self._K:
                break
            self._cap = max(self._cap, _pow2_ge(n_sel))
            self._K = max(self._K, _pow2_ge(max(
                n_kmers, (n_sel + 1) * (self._k - self._m + 1))))
            arr = self._dispatch().cpu().numpy()
        comp, self.n_sel, self.n_kmers, uniques = parse_dedup_array(
            arr, self._cap, self._K)
        self.uniques_list = [uniques]
        return comp


class _TileChain:
    """One sequence, tile by tile: tile t owns loop positions
    [t*own, (t+1)*own) and scans own + extra positions; a state carried
    on the device links each tile to the next. slab: the record's 2-bit
    codes with a 128-position leading halo (byte 32 holds position 0),
    n_tiles * own + extra positions. Subclasses give ``_tile``.

    dedup: each tile's fetch also carries its unique selected k-mers
    (ops/dedup.py); ``uniques_list`` holds them in tile order and
    ``n_kmers`` the last tile's k-mer count."""

    def __init__(self, slab: np.ndarray, n_tiles: int, k: int, m: int,
                 length: int, threshold: int, own: int, extra: int,
                 sel_cap_guess: int, select_all: bool, device,
                 dedup: bool = False, kmer_cap_guess: int = 8192):
        self._slab = slab
        self._n_tiles = n_tiles
        self._k, self._m = k, m
        self._L = length
        self._thr = (threshold >> 32, threshold & 0xFFFFFFFF)
        self._own = own
        self._tile_p = own + extra
        self._guess = sel_cap_guess
        self._select_all = select_all
        self._device = device
        self.n_sel = 0
        self.fallback_tiles = []     # tiles that took the exact walker
        self._dedup = dedup
        self._kguess = kmer_cap_guess
        self.uniques_list = [] if dedup else None
        self.n_kmers = None

    def _ext(self, t: int) -> torch.Tensor:
        """Tile t's packed codes with the 128-position halo, on the
        device."""
        b0 = (t * self._own) >> 2
        return torch.from_numpy(
            self._slab[b0 : b0 + ((self._tile_p + 128) >> 2)]).to(
                self._device)

    def _tile(self, t: int, state):
        """(compact 9-tuple of tile t, its n_sel, the next tile's state;
        None after the last tile). state is None for tile 0."""
        raise NotImplementedError

    def _dedup_length(self, t: int) -> int:
        """Tile t's local length for the dedup tail: -1 unless it is the
        last tile, which flushes the tail span."""
        return (self._L - t * self._own) if t == self._n_tiles - 1 else -1

    def _dedup_walk(self, t: int, tables, ext, guess: int, init5, fb):
        """A DedupDeviceChain over tile t's owned positions."""
        return DedupDeviceChain(tables, ext, self._tile_p + 128, self._k,
                                self._m, self._dedup_length(t), guess,
                                self._kguess, init5=init5, fb=fb,
                                n_pad=self._own)

    def _take_uniques(self, uniques, n_kmers: int) -> None:
        self.uniques_list.append(uniques)
        self.n_kmers = n_kmers
        self._kguess = max(8192, 2 * n_kmers)

    def compact(self):
        """Run every tile in order and merge the per-tile compacts into
        one sequence-level 9-tuple with global positions."""
        parts = []
        state = None
        for t in range(self._n_tiles):
            comp, n_sel, state = self._tile(t, state)
            if not self._select_all:
                self._guess = max(4096, 2 * n_sel)
            parts.append(comp)
        self.n_sel = sum(p[0].size for p in parts)
        return _merge_tiles(parts, self._own)


class TiledDeviceChain(_TileChain):
    """The exact engine over one sequence (pipeline.py:141-251): each
    tile's successor tables, scanned with the real remaining length so
    successors may point past the tile, and a walk of its own
    positions; the walk's state (init5, fb) carries to the next tile on
    the device (DeviceChain.carry)."""

    def _tile(self, t: int, carry):
        own = self._own
        with phase("dispatch"):
            ext = self._ext(t)
            tables = scan_tables_2d_packed(
                ext[32:], self._k, self._m, self._tile_p,
                self._L - t * own, *self._thr)
            init5, fb = carry if carry is not None else (None, None)
            guess = own if self._select_all else self._guess
            if self._dedup:
                dc = self._dedup_walk(t, tables, ext, guess, init5, fb)
            else:
                dc = DeviceChain(tables, guess, init5=init5, fb=fb,
                                 n_pad=own)
            nxt = dc.carry(own) if t < self._n_tiles - 1 else None
        comp = _compact(dc)
        if self._dedup:
            self._take_uniques(dc.uniques_list[0], dc.n_kmers)
        return comp, dc.n_sel, nxt


class FieldChain(_TileChain):
    """Field scan + resolve tile by tile, the machine state carried
    between tiles (field_carry). A tile the resolve cannot settle
    re-runs alone through the exact walker, entered from and left to
    the field path by the state converters; its index goes to
    ``fallback_tiles``."""

    def _tile(self, t: int, entry):
        k, m = self._k, self._m
        own, P_t = self._own, self._tile_p
        last = t == self._n_tiles - 1
        # non-final tiles cap last_i at own-1 (the carry handoff point)
        length_t = (self._L - t * own) if last else (own + k)
        with phase("dispatch"):
            ext = self._ext(t)
            ft = scan_field_2d_packed(ext[32:], k, m, P_t, length_t)
            if entry is None:
                entry = field_entry_init(ft, *self._thr)
        cap = _pow2_ge(own if self._select_all else self._guess)
        K = _pow2_ge(own if self._select_all else self._kguess)
        while True:
            with phase("dispatch"):
                arr = resolve_field(ft, k, m, cap, entry, *self._thr)
                if self._dedup:
                    out = field_dedup_packed(arr, cap, ext,
                                             self._dedup_length(t), k, m,
                                             P_t + 128, K)
            a = _fetch(out if self._dedup else arr)
            if int(a[0]) != 0:
                return self._fallback(t, ft, entry, cap, ext)
            n_sel = int(a[1])
            n_kmers = int(a[_HEAD + 4 * cap]) if self._dedup else 0
            if n_sel <= cap and n_kmers <= K:
                if self._dedup:
                    _st, comp, n_sel, n_kmers, uniques = \
                        parse_field_dedup_array(a, cap, K)
                    self._take_uniques(uniques, n_kmers)
                else:
                    _st, comp, n_sel = parse_field_array(a, cap)
                return comp, n_sel, None if last else field_carry(arr, own)
            if self._dedup:      # JAX's bound, as DedupDeviceChain's
                K = max(K, _pow2_ge(max(n_kmers,
                                        (n_sel + 1) * (k - m + 1))))
            cap = max(cap, _pow2_ge(n_sel))

    def _fallback(self, t: int, ft, entry, cap: int, ext):
        """Tile t through the walker (pipeline.py:346-385). The
        successor tables come from the field scan's own tables with the
        real remaining length; no second scan runs."""
        self.fallback_tiles.append(t)
        k, m, own = self._k, self._m, self._own
        with phase("dispatch"):
            tables = succ_tables(ft[:7], (ft.init_val, ft.init_p,
                                          ft.init_h_hi, ft.init_h_lo),
                                 k, m, self._L - t * own, *self._thr)
            init5, fb = field_entry_to_walker_init(ft, entry)
            guess = own if self._select_all else max(cap, 4096)
            if self._dedup:
                dc = self._dedup_walk(t, tables, ext, guess, init5, fb)
            else:
                dc = DeviceChain(tables, guess, init5=init5, fb=fb,
                                 n_pad=own)
            nxt = None
            if t < self._n_tiles - 1:
                nxt = walker_exit_to_field_entry(ft, dc.scal, entry, k, m,
                                                 own, *self._thr)
        comp = _compact(dc)
        if self._dedup:
            self._take_uniques(dc.uniques_list[0], dc.n_kmers)
        return comp, dc.n_sel, nxt


class TorchSubsampler(SubsamplerState, KmerStore):
    """Sketcher whose scan and resolve run on a torch device; intake,
    reconstruction and serialization go to the native C finisher, or
    to the Python k-mer store (KmerStore) when an opt-in below asks."""

    _sel_cap_guess = 4096
    _kmer_cap_guess = 8192
    # short-record batching: records whose padded bucket is at most
    # _SHORT_MAX positions resolve per size bucket in one batch;
    # _batch_sel_rate (selected events per position) sizes the batch's
    # list capacity
    _SHORT_MAX = 1 << 16
    _batch_sel_rate = 0.002
    # tile geometry (class-level so tests can shrink it)
    _tile_own = _TILE_OWN
    _tile_extra = _TILE_EXTRA
    # "field": the sync-field engine, with the exact walker as its
    # fallback; "legacy": every record through successor tables and the
    # walker (pipeline.py:504-508). Both give the same bytes.
    scan_engine = "field"
    # opt-ins, set before the first sketch (pipeline.py:494-547):
    # device_dedup = True expands, sorts and counts the selected k-mers
    # on the device (ops/dedup.py) and merges the unique ones into the
    # Python k-mer store; native_finisher = False feeds the Python store
    # super-k-mer by super-k-mer. Either sends every record through
    # _launch_scan (no short batches). None is JAX's auto rule: dedup
    # only where no native finisher builds, and the port's always builds
    # (or raises), so auto is dedup off and the finisher on.
    device_dedup = None
    native_finisher = None

    def __init__(self, k: int = 31, m: int = 11, s: float = 1000.0,
                 abundance: int = 1, device="cuda"):
        super().__init__(k=k, m=m, s=s, abundance=abundance)
        self.device = torch.device(device)
        self.minimizer_map = {}       # the Python store (KmerStore)
        self._nf_obj = None           # the native finisher, made by _nf
        self._thr = (self.threshold >> 32, self.threshold & 0xFFFFFFFF)
        self._margin = 2 * (2 * k - m + 2) + 128
        # regions re-run through the exact walker, by route: tiles of
        # FieldChain, single-tile records, records of a short batch
        self.fallbacks = {"tile": 0, "single": 0, "batch": 0}

    # ---- intake target ----
    def _uses_store(self) -> bool:
        """Whether intake goes to the Python k-mer store in place of the
        native finisher: with device dedup (which fills the store) or
        with the finisher turned off."""
        if self.device_dedup:
            if self.native_finisher:
                raise ValueError("device_dedup fills the Python k-mer "
                                 "store; native_finisher cannot be True")
            return True
        return self.native_finisher is not None and not self.native_finisher

    def _nf(self):
        """The native finisher, made at first use; None when the Python
        store takes intake."""
        if self._uses_store():
            return None
        if self._nf_obj is None:
            self._nf_obj = NativeFinisher(self.k, self.m, self.abundance)
        return self._nf_obj

    # ---- geometry ----
    def _plan_geometry(self, n_raw: int):
        """(own, n_tiles) for a record whose cleaned length is at most
        n_raw (cleaning only strips bytes)."""
        if n_raw + self._margin <= self._tile_own:
            return max(padded_size(n_raw, self._margin), 2048), 1
        own = self._tile_own
        return own, max(1, -(-(n_raw - self.k) // own))

    def _scan_geometry(self, L: int):
        """(route, own, n_tiles, slab positions after the halo) of
        _launch_scan for a record of length L (pipeline.py:573-619):
        "field" for the field engine past 1,024 padded positions (790 bp
        at k=31, m=11), "walk" for one walk region of padded_size(L)
        positions, "tiled" for longer legacy records. The positions grow
        with L, so a slab planned from a raw length fits its cleaned
        record."""
        if self.scan_engine == "field" and L + self._margin > 1024:
            own, n_tiles = self._plan_geometry(L)
        elif L + self._margin <= self._tile_own:
            P = padded_size(L, self._margin)
            return "walk", P, 1, P
        else:
            own = self._tile_own
            n_tiles = max(1, -(-(L - self.k) // own))
        route = "field" if self.scan_engine == "field" else "tiled"
        return route, own, n_tiles, n_tiles * own + self._tile_extra

    # ---- per chunk (prep pool) ----
    def _prep_chunk(self, data: bytes, spans):
        """Clean + 2-bit pack every record of a chunk: one C call per
        short-record size group, one per longer record. Returns
        (routes, groups) with routes[i] one of ("skip",),
        ("grp", group, slot), (engine, ref, slab, L, own, n_tiles),
        engine "field" or "legacy", or, when the Python store takes
        intake, ("scan", ref, slab, L) (_prep_scan). A span that ends
        before it starts is an empty record."""
        k = self.k
        routes = [None] * len(spans)
        bygroup = {}          # own -> [(rec_idx, start, end)]
        scan = self._uses_store()
        for i, (s, e) in enumerate(spans):
            n_raw = max(e - s, 0)
            if scan:
                routes[i] = self._prep_scan(
                    np.frombuffer(data, np.uint8, n_raw, s))
                continue
            if self.scan_engine == "legacy":
                routes[i] = self._prep_legacy(
                    np.frombuffer(data, np.uint8, n_raw, s))
                continue
            if n_raw + self._margin <= self._SHORT_MAX:
                own = max(1024, padded_size(n_raw, self._margin))
                bygroup.setdefault(own, []).append((i, s, e))
                continue
            own, n_tiles = self._plan_geometry(n_raw)
            raw = np.frombuffer(data, np.uint8, n_raw, s)
            ref, slab, L = clean_pack_native(
                raw, n_tiles * own + self._tile_extra, 128)
            if L < k:
                routes[i] = ("skip",)
                continue
            if n_tiles > 1:
                n2 = max(1, -(-(L - k) // own))
                if n2 < n_tiles:
                    slab = slab[: (128 + n2 * own + self._tile_extra) >> 2]
                    n_tiles = n2
            routes[i] = ("field", ref, slab, L, own, n_tiles)

        groups = []
        for own, members in bygroup.items():
            R = len(members)
            R_pad = _pow2_ge(max(R, 8))
            starts = np.fromiter((s for _, s, _ in members), np.int64, R)
            ends = np.maximum(
                np.fromiter((e for _, _, e in members), np.int64, R), starts)
            ref_offs = np.zeros(R + 1, np.int64)
            np.cumsum(ends - starts, out=ref_offs[1:])
            ref_pool = np.empty(max(int(ref_offs[-1]), 1), np.uint8)
            pack = np.zeros((R_pad, own >> 2), np.uint8)
            lens = clean_pack_batch_native(
                np.frombuffer(data, np.uint8), starts, ends, ref_pool,
                ref_offs[:R], pack, np.arange(R, dtype=np.int64) * (own >> 2),
                np.full(R, own, np.int64))
            lengths = np.zeros(R_pad, np.int32)
            lengths[:R] = np.where(lens >= k, lens, 0)
            g = {"own": own, "pack": pack, "lengths": lengths,
                 "ref_pool": ref_pool, "ref_offs": ref_offs,
                 "ref_lens": lens}
            for slot, (i, _s, _e) in enumerate(members):
                routes[i] = (("skip",) if lengths[slot] == 0
                             else ("grp", g, slot))
            groups.append(g)
        return routes, groups

    def _prep_legacy(self, raw: np.ndarray):
        """Clean + pack one record for the exact engine (pipeline.py:
        588-618): one tile of padded_size(L, margin) positions when it
        fits a tile, else tiles of _tile_own. Returns its route."""
        k, own, extra = self.k, self._tile_own, self._tile_extra
        n_raw = raw.size
        if n_raw + self._margin <= own:
            padded = padded_size(n_raw, self._margin)
        else:
            padded = -(-(n_raw - k) // own) * own + extra
        ref, slab, L = clean_pack_native(raw, padded, 128)
        if L < k:
            return ("skip",)
        if L + self._margin <= own:
            return ("legacy", ref, slab, L, padded_size(L, self._margin), 1)
        n_tiles = max(1, -(-(L - k) // own))
        return ("legacy", ref, slab[: (128 + n_tiles * own + extra) >> 2],
                L, own, n_tiles)

    def _prep_scan(self, raw: np.ndarray):
        """Clean + pack one record for _launch_scan, its slab planned
        from the raw length. Returns its route."""
        ref, slab, L = clean_pack_native(
            raw, self._scan_geometry(raw.size)[3], 128)
        if L < self.k:
            return ("skip",)
        return ("scan", ref, slab, L)

    # ---- the per-record path (JAX TpuSubsampler.scan_sequence) ----
    def _launch_scan(self, ref: np.ndarray, slab: np.ndarray | None = None):
        """The chain of one cleaned record (uint8 array) on its route
        (_scan_geometry): a FieldChain, a DeviceChain (with device dedup a
        DedupDeviceChain) or a TiledDeviceChain, whose ``compact()``
        issues the rest and fetches. slab: the record's 2-bit codes with
        the 128-position halo (_prep_scan); packed here when None."""
        k, m = self.k, self.m
        L = ref.size
        route, own, n_tiles, positions = self._scan_geometry(L)
        if slab is None:
            _ref, slab, _L = clean_pack_native(ref, positions, 128)
        slab = slab[: (128 + positions) >> 2]
        dedup = bool(self.device_dedup)
        select_all = self.s <= 1
        sel_guess = own if select_all else self._sel_cap_guess
        kmer_guess = own if select_all else self._kmer_cap_guess
        if route == "walk":
            with phase("dispatch"):
                ext = torch.from_numpy(slab).to(self.device)
                tables = scan_tables_2d_packed(ext[32:], k, m, own, L,
                                               *self._thr)
                if not dedup:
                    return DeviceChain(tables, sel_guess)
                return DedupDeviceChain(tables, ext, own + 128, k, m, L,
                                        sel_guess, kmer_guess)
        cls = FieldChain if route == "field" else TiledDeviceChain
        return cls(slab, n_tiles, k, m, L, self.threshold, own,
                   self._tile_extra, sel_guess, select_all, self.device,
                   dedup=dedup, kmer_cap_guess=kmer_guess)

    def _fetch_scan(self, dc):
        """(compact 9-tuple, uniques list or None) of a _launch_scan
        chain. Adapts the capacity guesses to it (pipeline.py:559-571)
        and counts its fallback tiles under "tile"."""
        comp = dc.compact() if isinstance(dc, _TileChain) else _compact(dc)
        self._sel_cap_guess = max(4096, 2 * dc.n_sel)
        n_kmers = getattr(dc, "n_kmers", None)
        if n_kmers is not None:
            self._kmer_cap_guess = max(8192, 2 * n_kmers)
        self.fallbacks["tile"] += len(getattr(dc, "fallback_tiles", ()))
        return comp, getattr(dc, "uniques_list", None)

    def scan_sequence(self, ref) -> None:
        """Sketch one cleaned record (str, bytes or uint8 array of
        uppercase ACGT) into this sketcher's store or finisher through
        _launch_scan (pipeline.py:634). A record shorter than k adds
        nothing, as in the reference."""
        if isinstance(ref, str):
            ref = ref.encode()
        if isinstance(ref, bytes):
            ref = np.frombuffer(ref, np.uint8)
        if ref.size < self.k:
            return
        comp, uniques = self._fetch_scan(self._launch_scan(ref))
        self._assemble_compact(ref, *comp, uniques_list=uniques)

    # ---- host assembly of a short batch (calling thread) ----
    def _ingest_run(self, g, a: int, b: int) -> None:
        """Assemble group g's slots [a, b) in record order: a record the
        batch resolve left unresolved takes its walker result (the
        device thread's, in g["fb"]) in its place (pipeline.py:
        1359-1375); the records between go in resolved runs."""
        for j in (a + np.flatnonzero(g["heads"][a:b, 0])).tolist():
            if j > a:
                self._ingest_resolved(g, a, j)
            self._ingest_fallback(g, j)
            a = j + 1
        if a < b:
            self._ingest_resolved(g, a, b)

    def _ingest_fallback(self, g, j: int) -> None:
        """Group g's slot j from its walk at the group's padded size."""
        L = int(g["ref_lens"][j])
        o = int(g["ref_offs"][j])
        self.read_kmer += L - self.k + 1
        self._assemble_compact(g["ref_pool"][o : o + L], *g["fb"][j])

    def _ingest_resolved(self, g, a: int, b: int) -> None:
        """Assemble resolved slots [a, b) of group g: one vectorized
        counter pass and one C ingest for the whole run."""
        heads = g["heads"][a:b]
        k = self.k
        live = g["lengths"][a:b] > 0
        lens = g["ref_lens"][a:b]
        o = g["span_offs"]
        s0, s1 = int(o[a]), int(o[b])
        self.read_kmer += int(np.sum(lens[live] - k + 1))
        self._span_counters_run(lens, heads, g["pos"][s0:s1],
                                g["last"][s0:s1], o[a : b + 1] - s0)
        tail_last = np.where(
            heads[:, 6] != 0,
            np.where(heads[:, 2] > 0, heads[:, 3] + 1, 0),
            -1).astype(np.int64)
        self._nf().add_spans_batch(
            g["ref_pool"], g["ref_offs"][a:b], lens, g["pos"][s0:s1],
            g["last"][s0:s1], g["val"][s0:s1], g["rev"][s0:s1],
            o[a : b + 1] - s0, tail_last, heads[:, 4].view(np.uint32),
            heads[:, 5].astype(np.uint8))

    def sketch_file(self, input_path: str):
        """Sketch one FASTA file: a one-member ``sketch_fof``. Returns
        the uncompressed sketch bytes, or None (with the reference's
        messages) for an unreadable input."""
        return sketch_fof([(self, input_path)])[0]

    # ---- host assembly (reference SubSampler.cpp:401-454) ----
    def _assemble_compact(self, ref, sel_pos, sel_last, sel_val, sel_rev,
                          n_ev, last_ev_pos, tail_val, tail_rev,
                          tail_sel, uniques_list=None):
        """Replay the boundary loop from the compacted selected
        boundaries into the native finisher or the Python store. The
        aggregate counters telescope: a sequence has exactly L-k+1
        k-mers and n_ev+1 super-k-mers. With uniques_list (device dedup)
        the intake was done on the device: the uniques merge into the
        store. ref: the cleaned record as a uint8 array."""
        k = self.k
        L = len(ref)
        self.total_kmer_number += L - k + 1
        self.total_superkmer_number += n_ev + 1
        nf = self._nf()
        if nf is None and uniques_list is None:
            self._store_spans(ref.tobytes(), sel_pos, sel_last, sel_val,
                              sel_rev, n_ev, last_ev_pos, tail_val,
                              tail_rev, tail_sel)
            return
        self._span_counters(L, sel_pos, sel_last, n_ev, last_ev_pos,
                            tail_sel)
        if uniques_list is not None:
            for uniques in uniques_list:
                merge_unique_host(self, uniques)
            return
        pos = np.asarray(sel_pos, np.int64)
        last = np.asarray(sel_last, np.int64)
        val = np.asarray(sel_val, np.uint32)
        rev = np.asarray(sel_rev, np.uint8)
        if tail_sel:
            pos = np.append(pos, L - k)
            last = np.append(last, last_ev_pos + 1 if n_ev else 0)
            val = np.append(val, np.uint32(tail_val))
            rev = np.append(rev, np.uint8(tail_rev))
        nf.add_spans(ref, pos, last, val, rev)

    def _store_spans(self, ref: bytes, sel_pos, sel_last, sel_val, sel_rev,
                     n_ev, last_ev_pos, tail_val, tail_rev,
                     tail_sel) -> None:
        """The reference's boundary loop (SubSampler.cpp:401-454) over
        the selected boundaries into the Python store, one
        handle_superkmer per super-k-mer (pipeline.py:836-857)."""
        k, m = self.k, self.m
        pos_end = 0
        for j in range(len(sel_pos)):
            i = int(sel_pos[j])
            last_position = int(sel_last[j])
            if last_position + m - 2 > pos_end:
                if pos_end > 0:
                    self.nb_mmer_selected -= m - 1
                self.nb_mmer_selected += i + k - last_position
                self.nb_mmer_selected -= k - m
            else:
                self.nb_mmer_selected += i + k - (pos_end + 1)
            self.handle_superkmer(ref[last_position : i + k],
                                  int(sel_val[j]), bool(sel_rev[j]))
            pos_end = i + k - 1
        # the tail flush (SubSampler.cpp:441-454)
        if tail_sel:
            self.nb_mmer_selected -= m - 1
            self.handle_superkmer(ref[last_ev_pos + 1 if n_ev else 0 :],
                                  int(tail_val), bool(tail_rev))

    def _span_counters(self, L, sel_pos, sel_last, n_ev, last_ev_pos,
                       tail_sel):
        """Vectorized counter bookkeeping of the scalar assembly loop
        and handle_superkmer's own stats."""
        k, m = self.k, self.m
        n = len(sel_pos)
        if n:
            i_arr = np.asarray(sel_pos)
            last_arr = np.asarray(sel_last)
            pos_end_prev = np.concatenate([[0], i_arr[:-1] + k - 1])
            c1 = last_arr + m - 2 > pos_end_prev
            contrib = np.where(
                c1,
                np.where(pos_end_prev > 0, -(m - 1), 0)
                + (i_arr + k - last_arr) - (k - m),
                i_arr + k - (pos_end_prev + 1))
            self.nb_mmer_selected += int(contrib.sum())
            lens = i_arr + k - last_arr
            self.selected_superkmer_number += n
            self.selected_kmer_number += int((lens - k + 1).sum())
            self.count_maximal_skmer += int((lens == 2 * k - m).sum())
        if tail_sel:
            self.nb_mmer_selected -= m - 1
            tlen = L - (last_ev_pos + 1 if n_ev else 0)
            self.selected_superkmer_number += 1
            self.selected_kmer_number += tlen - k + 1
            if tlen == 2 * k - m:
                self.count_maximal_skmer += 1

    def _span_counters_run(self, lens, heads, pos, last, offs):
        """_span_counters for a run of batched records, across the
        run's record-major event arrays."""
        k, m = self.k, self.m
        n_ev_r = heads[:, 2].astype(np.int64)
        live = lens >= k
        self.total_kmer_number += int(np.sum(lens[live] - k + 1))
        self.total_superkmer_number += int(np.sum(n_ev_r[live] + 1))
        n = pos.size
        if n:
            counts = (offs[1:] - offs[:-1]).astype(np.int64)
            is_first = np.zeros(n, bool)
            is_first[offs[:-1][counts > 0]] = True
            prev_pos = np.empty(n, np.int64)
            prev_pos[0] = 0
            prev_pos[1:] = pos[:-1]
            pos_end_prev = np.where(is_first, 0, prev_pos + k - 1)
            c1 = last + m - 2 > pos_end_prev
            contrib = np.where(
                c1,
                np.where(pos_end_prev > 0, -(m - 1), 0)
                + (pos + k - last) - (k - m),
                pos + k - (pos_end_prev + 1))
            self.nb_mmer_selected += int(contrib.sum())
            slens = pos + k - last
            self.selected_superkmer_number += n
            self.selected_kmer_number += int((slens - k + 1).sum())
            self.count_maximal_skmer += int((slens == 2 * k - m).sum())
        tail_sel = heads[:, 6] != 0
        if tail_sel.any():
            t_last = np.where(heads[:, 2] > 0, heads[:, 3] + 1, 0)
            tlen = (lens - t_last)[tail_sel]
            cnt = int(tail_sel.sum())
            self.nb_mmer_selected -= (m - 1) * cnt
            self.selected_superkmer_number += cnt
            self.selected_kmer_number += int((tlen - k + 1).sum())
            self.count_maximal_skmer += int((tlen == 2 * k - m).sum())

    def serialize(self) -> bytes:
        nf = self._nf()
        if nf is None:
            return super().serialize()
        header = "{} {} {} {}\n".format(
            self.k - 1 + self.max_superkmer_size, self.m,
            self.selected_kmer_number, format_double(self.s)).encode()
        payload, c = nf.serialize()
        self.seen_kmers_at_reconstruction += int(c[0])
        self.seen_superkmers_at_reconstruction += int(c[1])
        self.seen_max_superkmers_at_reconstruction += int(c[2])
        self.seen_unique_kmers_at_reconstruction += int(c[3])
        self.total_kmer_number_at_reconstruction += int(c[4])
        self.actual_minimizer_number = int(c[5])
        return header + payload


def _enter_device(device: torch.device) -> None:
    """Make ``device`` current on the calling thread: a CUDA thread's
    current card is its own, and the device thread issues every launch
    of a run."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


class _SharedSketchRun:
    """One sketch pipeline shared by the files of a fof (JAX
    _SharedSketchRun, supersampler_tpu/sketch/pipeline.py:978-1562).

    Stages: one reader thread streams chunks of whole records, file
    after file, so it reads ahead across file boundaries
    (``_prefetch_iter``, depth 2); a 2-worker prep pool cleans and
    packs each chunk (``TorchSubsampler._prep_chunk``, C calls that
    release the GIL); one device thread, with the run's card current,
    issues the chunk's device work in file-major record order (short
    batches first, then the other records; a run whose members use the
    Python store sends each record through ``_launch_scan``) and
    fetches each result; the calling thread assembles in the same order
    into each file's own finisher or store, so bucket first-insertion
    order follows record order per file. At most ``_IN_FLIGHT`` chunks
    are between read and assembly, so host memory stays O(window +
    largest record) per chunk. A file serializes as soon as its last
    chunk has drained, in fof order.

    Invariants:
      * every member has the same sketch parameters and device
        (sketch_fof groups items by _shared_params_key);
      * records of one file assemble in record order into that file's
        finisher; files finalize in fof order;
      * the adaptive capacities (selection and k-mer guesses, batch
        selection rate)
        live on the run and are written back to every member at the
        end; they size device buffers only, never the bytes.
    """

    _CHUNK_BYTES = 4 << 20
    _CHUNK_RECS = 4096
    _IN_FLIGHT = 4

    def __init__(self, items, on_result=None):
        self.items = list(items)            # [(ss, path)], same params
        self.on_result = on_result          # callback(member_idx, raw)
        ss0 = self.items[0][0]
        self.k, self.m = ss0.k, ss0.m
        self.threshold = ss0.threshold
        self.thr = ss0._thr
        self.extra = ss0._tile_extra
        self.select_all = ss0.s <= 1
        # the device thread's current card starts as card 0: name the
        # caller's current card where the members say only "cuda"
        self.device = ss0.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.sel_guess = ss0._sel_cap_guess
        self.kmer_guess = ss0._kmer_cap_guess
        self.rate = ss0._batch_sel_rate

    @staticmethod
    def _prep(ss, data, spans):
        """One chunk's clean + pack (prep pool)."""
        with phase("prep"):
            return ss._prep_chunk(data, spans)

    # ---- device work (device thread) ----
    def _short_cap(self, positions: int) -> int:
        if self.select_all:
            return _pow2_ge(positions)
        return _pow2_ge(max(4096, int(self.rate * positions * 2)))

    def _resolve_group(self, ss, g) -> None:
        """Scan + resolve one short-record batch (re-dispatched with a
        bigger capacity while its lists are truncated) into heads and
        record-major event arrays; each record the resolve leaves
        unresolved walks on its own into g["fb"][slot]."""
        own = g["own"]
        B_n = g["lengths"].size
        positions = B_n * own
        with phase("dispatch"):
            packed = torch.from_numpy(g["pack"]).to(self.device)
            lengths = torch.from_numpy(g["lengths"]).to(self.device)
        cap = self._short_cap(positions)
        while True:
            with phase("dispatch"):
                arr = scan_resolve_batch(packed, self.k, self.m, own, cap,
                                         lengths, *self.thr)
            gst, n_total, heads, pos, last, val, rev = \
                parse_batched_heads(_fetch(arr), cap, B_n)
            if pos is not None:
                break
            cap = _pow2_ge(n_total)
        g.update(heads=heads, pos=pos, last=last, val=val, rev=rev)
        g["span_offs"] = np.zeros(B_n + 1, np.int64)
        np.cumsum(heads[:, 1], out=g["span_offs"][1:])
        if not self.select_all:
            self.rate = max(n_total / positions, 1e-6)
        g["fb"] = {}
        for j in np.flatnonzero(heads[:, 0]).tolist():
            ss.fallbacks["batch"] += 1
            comp, n_sel = self._walk_single(g["pack"][j], own,
                                            int(g["ref_lens"][j]))
            self.sel_guess = max(4096, 2 * n_sel)
            g["fb"][j] = comp

    def _single(self, ss, slab: np.ndarray, L: int, own: int):
        """Compact 9-tuple and n_sel of a single-tile record; an
        unresolved one goes through a one-tile TiledDeviceChain
        (pipeline.py:1404-1411)."""
        cap = _pow2_ge(max(own if self.select_all else self.sel_guess,
                           4096))
        with phase("dispatch"):
            dev_slab = torch.from_numpy(slab).to(self.device)
        while True:
            with phase("dispatch"):
                arr = scan_resolve_single(
                    dev_slab, self.k, self.m, own + self.extra, cap, L,
                    *self.thr)
            a = _fetch(arr)
            if int(a[0]) != 0:
                ss.fallbacks["single"] += 1
                return self._chain(ss, TiledDeviceChain, slab, 1, L, own,
                                   max(4096, cap))
            if int(a[1]) <= cap:
                _st, comp, n_sel = parse_field_array(a, cap)
                return comp, n_sel
            cap = _pow2_ge(int(a[1]))

    def _chain(self, ss, cls, slab, n_tiles: int, L: int, own: int,
               guess: int | None = None):
        """Compact 9-tuple and n_sel of a FieldChain or TiledDeviceChain
        over the record's slab."""
        chain = cls(slab, n_tiles, self.k, self.m, L, self.threshold, own,
                    self.extra, guess or self.sel_guess, self.select_all,
                    self.device)
        comp = chain.compact()
        ss.fallbacks["tile"] += len(chain.fallback_tiles)
        return comp, chain.n_sel

    def _walk_single(self, packed: np.ndarray, P: int, L: int):
        """Compact 9-tuple and n_sel of a record through the exact engine
        as one walk over P positions (_scan_chain_packed,
        pipeline.py:59-70). packed: P / 4 bytes, no halo."""
        with phase("dispatch"):
            t = scan_tables_2d_packed(
                torch.from_numpy(packed).to(self.device), self.k, self.m,
                P, L, *self.thr)
            dc = DeviceChain(t, P if self.select_all else self.sel_guess)
        return _compact(dc), dc.n_sel

    def _scan(self, ss, ref: np.ndarray, slab: np.ndarray):
        """(compact 9-tuple, uniques list or None) of a "scan" route's
        record through ss._launch_scan, with the run's capacity
        guesses."""
        ss._sel_cap_guess, ss._kmer_cap_guess = self.sel_guess, self.kmer_guess
        out = ss._fetch_scan(ss._launch_scan(ref, slab))
        self.sel_guess, self.kmer_guess = ss._sel_cap_guess, ss._kmer_cap_guess
        return out

    def _device_chunk(self, ss, prep):
        """Every device result of one chunk, in record order: the short
        batches, then one compact 9-tuple per other record (None for
        "skip" and "grp" routes; for "scan" routes with its uniques
        list). Returns (routes, groups, comps)."""
        routes, groups = prep.result()
        for g in groups:
            self._resolve_group(ss, g)
        comps = [None] * len(routes)
        for i, p in enumerate(routes):
            if p[0] in ("skip", "grp"):
                continue
            if p[0] == "scan":
                comps[i] = self._scan(ss, p[1], p[2])
                continue
            engine, _ref, slab, L, own, n_tiles = p
            if engine == "legacy" and n_tiles == 1:
                comp, n_sel = self._walk_single(
                    slab[32 : 32 + (own >> 2)], own, L)
            elif engine == "legacy":
                comp, n_sel = self._chain(ss, TiledDeviceChain, slab,
                                          n_tiles, L, own)
            elif n_tiles > 1:
                comp, n_sel = self._chain(ss, FieldChain, slab, n_tiles, L,
                                          own)
            else:
                comp, n_sel = self._single(ss, slab, L, own)
            self.sel_guess = max(4096, 2 * n_sel)
            comps[i] = comp
        return routes, groups, comps

    # ---- assembly (calling thread) ----
    def _assemble(self, ss, routes, groups, comps) -> None:
        """Assemble one chunk in record order into ss's finisher: runs of
        consecutive slots of one short batch in one C ingest each, every
        other record from its compact."""
        k = self.k
        with phase("assemble"):
            run = None            # (group, slot_a, slot_b)
            for i, p in enumerate(routes):
                if p[0] == "grp":
                    g, slot = p[1], p[2]
                    if run is not None and run[0] is g and run[2] == slot:
                        run = (g, run[1], slot + 1)
                        continue
                    if run is not None:
                        ss._ingest_run(*run)
                    run = (g, slot, slot + 1)
                    continue
                if run is not None:
                    ss._ingest_run(*run)
                    run = None
                if p[0] == "skip":
                    continue
                ref, L = p[1], p[3]
                ss.read_kmer += L - k + 1
                if p[0] == "scan":
                    comp, uniques = comps[i]
                    ss._assemble_compact(ref, *comp, uniques_list=uniques)
                else:
                    ss._assemble_compact(ref, *comps[i])
            if run is not None:
                ss._ingest_run(*run)

    def _finalize(self, fi: int, results: list) -> None:
        ss = self.items[fi][0]
        ss.nb_mmer_selected = (ss.nb_mmer_selected - (self.m - 1)) & MASK64
        with phase("serialize"):
            results[fi] = ss.serialize()
        if self.on_result is not None:
            self.on_result(fi, results[fi])

    def _blocks(self):
        """(file index, data, spans) of every chunk, file after file in
        fof order; (file index, None, None) after each file's last."""
        for fi, (_ss, path) in enumerate(self.items):
            for data, spans in stream_fasta_spans(path, self._CHUNK_BYTES,
                                                  self._CHUNK_RECS):
                yield fi, data, spans
            yield fi, None, None

    def run(self) -> list:
        """Sketch every member; returns their sketch bytes in order. An
        error in any stage raises here."""
        n = len(self.items)
        results = [None] * n
        pending = collections.deque()     # (fi, device future), in order
        left = [0] * n                    # chunks not yet assembled
        read = [False] * n
        next_final = 0

        def try_finalize():
            nonlocal next_final
            while next_final < n and read[next_final] \
                    and left[next_final] == 0:
                self._finalize(next_final, results)
                next_final += 1

        def drain_one():
            fi, dfut = pending.popleft()
            self._assemble(self.items[fi][0], *dfut.result())
            left[fi] -= 1
            try_finalize()

        preppers = ThreadPoolExecutor(2, thread_name_prefix="spsp-prep")
        devq = ThreadPoolExecutor(1, thread_name_prefix="spsp-device",
                                  initializer=_enter_device,
                                  initargs=(self.device,))
        try:
            with device_trace("sketch_fof"), \
                    contextlib.closing(_prefetch_iter(self._blocks())) \
                    as blocks:
                for fi, data, spans in blocks:
                    if data is None:          # the file's last chunk
                        read[fi] = True
                        try_finalize()
                        continue
                    ss = self.items[fi][0]
                    pf = preppers.submit(self._prep, ss, data, spans)
                    pending.append((fi, devq.submit(self._device_chunk, ss,
                                                    pf)))
                    left[fi] += 1
                    if len(pending) >= self._IN_FLIGHT:
                        drain_one()
                while pending:
                    drain_one()
        finally:
            preppers.shutdown(cancel_futures=True)
            devq.shutdown(cancel_futures=True)
        for ss, _path in self.items:
            ss._sel_cap_guess = self.sel_guess
            ss._kmer_cap_guess = self.kmer_guess
            ss._batch_sel_rate = self.rate
        return results


def _prefetch_iter(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue, so
    file reading overlaps prep and device work without unbounded
    buffering. An exception in the generator raises in the consumer;
    closing the consumer stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
            put(end)
        except BaseException as e:      # handed to the consumer
            put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, name="spsp-reader", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _shared_params_key(ss):
    return (ss.k, ss.m, ss.threshold, ss.s, ss.abundance, ss.scan_engine,
            ss._tile_own, ss._tile_extra, ss._SHORT_MAX, str(ss.device),
            bool(ss.device_dedup), ss._uses_store())


def sketch_fof(items, on_result=None):
    """Sketch many (subsampler, fasta_path) pairs through one shared
    pipeline per parameter set (see _SharedSketchRun). Returns the
    sketch bytes per item, aligned with the input: None for a file that
    cannot be opened, which prints the reference's two messages to its
    subsampler's log. Each item needs a subsampler of its own. Items
    with device dedup on or the native finisher off run (in runs of
    their own) every record through _launch_scan.

    on_result(idx, raw): called as each item's sketch is serialized (a
    file finalizes as soon as its last chunk drains, in input order),
    so output writing can overlap the remaining device work."""
    if len({id(ss) for ss, _path in items}) < len(items):
        raise ValueError("sketch_fof: two items share a subsampler")
    results = [None] * len(items)
    shared: dict = {}               # params key -> [(idx, ss, path)]
    for idx, (ss, path) in enumerate(items):
        if not os.path.exists(path):
            log = ss.log or sys.stdout
            print("Problem with file opening", file=log)
            print(f"Can't open file: {path}", file=log)
            continue
        shared.setdefault(_shared_params_key(ss), []).append(
            (idx, ss, path))
    for members in shared.values():
        gidx = [idx for idx, _, _ in members]
        cb = (None if on_result is None
              else lambda mi, raw: on_result(gidx[mi], raw))
        outs = _SharedSketchRun([(ss, path) for _, ss, path in members],
                                on_result=cb).run()
        for idx, out in zip(gidx, outs):
            results[idx] = out
    return results
