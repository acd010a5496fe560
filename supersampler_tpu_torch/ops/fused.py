"""The opt-in v2 path: scan straight into the sweep's column layout.

Counterpart of supersampler_tpu/ops/fused.py. The v2 scan kernel
(``scan2_kernel``, csrc/scan.cu ``spsp_scan2``; the TPU's
``_scan2_kernel``) writes the seven field tables in the column layout
the sweep reads coalesced, entry [r, l] of a (256, n_lanes) table at
position l*256 + r, and with them each lane's first sync column and
each record's window-0 election. ``fused_single`` / ``fused_batch``
then run the v1 resolve on those outputs with the sweep in its "col"
layout: no P-sized pass over the sync flags, and the prefix passes 2..4
only where pass 1 left a lane pending. They return the same int32 fetch
arrays as ``resolve_field`` / ``resolve_field_batched``.

The TPU kernel's half-major lane order inside each 128-lane tile and the
padding of rows to a multiple of 1,024 are Mosaic artifacts with no
counterpart here. ``ops.field._use_fused`` selects this path (CUDA and
``SPSP_FUSED=1`` only); v1 is the default, as in the JAX package.
"""

from __future__ import annotations

import torch

from supersampler_tpu_torch.ops import _build
from supersampler_tpu_torch.ops.field import (_B, BatchedFieldTables,
                                              FieldTables, _first_sync,
                                              _resolve_field,
                                              _resolve_field_batched,
                                              field_entry_init, sweep_kernel)
from supersampler_tpu_torch.ops.scan_kernel import _check_args, scan_plain

_I32 = torch.int32


def _check_scan2_args(packed, k: int, m: int, P_rec: int):
    if P_rec % _B:
        raise ValueError(f"P_rec={P_rec} must be a multiple of {_B}")
    return _check_args(packed, k, m, P_rec)


def scan2_plain(packed: torch.Tensor, k: int, m: int, P_rec: int):
    """Plain v2 scan (the kernel's executable spec): ``scan_plain``'s
    tables in the (256, n_lanes) column layout, each lane's first sync
    column fs (n_lanes,) int32 (256 = none) with sync masked only by the
    record's first 2W positions (fused.py:204, not by last_i: callers
    drop a first sync past it), and init (4, n_rec) as scan_plain's.
    Returns (h_hi, h_lo, cv, em, ep, eh_hi, eh_lo, fs, init)."""
    P, n_rec = _check_scan2_args(packed, k, m, P_rec)
    n = P // _B
    no_bound = torch.full((n_rec,), P_rec - 1, dtype=_I32,
                          device=packed.device)
    *tabs, sync, init = scan_plain(packed, k, m, P_rec, no_bound)
    cols = [a.view(n, _B).t().contiguous() for a in tabs]
    return (*cols, _first_sync(sync, n), init)


def scan2_kernel(packed: torch.Tensor, k: int, m: int, P_rec: int):
    """v2 scan: the CUDA kernel for a CUDA tensor, scan2_plain for a CPU
    tensor. ``scan2_kernel.launches`` counts kernel launches."""
    if packed.device.type == "cpu":
        return scan2_plain(packed, k, m, P_rec)
    P, n_rec = _check_scan2_args(packed, k, m, P_rec)
    if packed.device.type != "cuda":
        raise ValueError(f"no scan2 kernel for device {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("scan2_kernel needs a contiguous input")
    dev = packed.device
    n = P // _B
    cols = [torch.empty((_B, n), dtype=_I32, device=dev) for _ in range(7)]
    fs = torch.empty(n, dtype=_I32, device=dev)
    init = torch.empty((4, n_rec), dtype=_I32, device=dev)
    _build.launch("spsp_scan2", dev, packed.data_ptr(), P, P_rec, k, m,
                  *(c.data_ptr() for c in cols), fs.data_ptr(),
                  init.data_ptr())
    scan2_kernel.launches += 1
    return (*cols, fs, init)


scan2_kernel.launches = 0


def fused_single(slab: torch.Tensor, k: int, m: int, P: int, sel_cap: int,
                 length: int, thr_hi: int, thr_lo: int,
                 sweep=sweep_kernel) -> torch.Tensor:
    """scan_resolve_single through the v2 scan (fused.py:476): slab is
    the record's packed bytes with a 128-position (32-byte) leading
    halo. Returns resolve_field's fetch array."""
    dev = slab.device
    *cols, fs, init = scan2_kernel(slab[32:], k, m, P)
    last_i = torch.tensor(int(length) - k - 1, dtype=_I32, device=dev)
    # boundary fix-up: a first sync past last_i is no sync at all
    lane_base = torch.arange(fs.numel(), dtype=_I32, device=dev) * _B
    fs = torch.where(lane_base + fs <= last_i, fs, _B)
    t = FieldTables(*cols, sync=None, last_i=last_i, init_val=init[0, 0],
                    init_p=init[1, 0], init_h_hi=init[2, 0],
                    init_h_lo=init[3, 0],
                    eflag=torch.zeros((), dtype=torch.bool, device=dev))
    entry = field_entry_init(t, thr_hi, thr_lo)
    return _resolve_field(t, fs, k, m, sel_cap, entry, thr_hi, thr_lo,
                          sweep, "col", True)


def fused_batch(packed: torch.Tensor, k: int, m: int, P_rec: int,
                sel_cap: int, lengths: torch.Tensor, thr_hi: int,
                thr_lo: int, sweep=sweep_kernel) -> torch.Tensor:
    """scan_resolve_batch through the v2 scan (fused.py:568): packed
    (B, P_rec/4) record slabs, lengths (B,) cleaned lengths. Returns
    resolve_field_batched's fetch array."""
    B_n = packed.shape[0]
    if packed.shape[1] * 4 != P_rec:
        raise ValueError(f"P_rec={P_rec} must match packed rows of "
                         f"{packed.shape[1]}")
    dev = packed.device
    *cols, fs, init = scan2_kernel(packed.reshape(-1), k, m, P_rec)
    last_i = (lengths.to(_I32) - (k + 1)).contiguous()
    lpr = P_rec // _B
    lanes = torch.arange(fs.numel(), dtype=torch.int64, device=dev)
    fs = torch.where((lanes % lpr) * _B + fs <= last_i[lanes // lpr], fs,
                     _B)
    t = BatchedFieldTables(*cols, sync=None, last_i=last_i,
                           init_val=init[0], init_p=init[1],
                           init_h_hi=init[2], init_h_lo=init[3],
                           eflag=torch.zeros(B_n, dtype=torch.bool,
                                             device=dev))
    return _resolve_field_batched(t, fs, k, m, sel_cap, P_rec, thr_hi,
                                  thr_lo, sweep, "col", True)
