"""Field scan: packed 2-bit codes -> per-position field tables.

Counterpart of supersampler_tpu/ops/scan_kernel.py (the Pallas
``_scan_block_kernel``) plus the XLA sync chain
(supersampler_tpu/ops/field.py ``_sync_from_h0``) and the position
masking of ``scan_field_2d`` / ``scan_field_batched``, which the CUDA
kernel (csrc/scan.cu) folds in.

Both versions take a flat batch of records laid back to back (record r
owns positions [r*P_rec, (r+1)*P_rec); a single sequence is a batch of
one) and return, as int32 bit patterns of P entries each,
``(h_hi, h_lo, cv, em, ep, eh_hi, eh_lo, sync, init)``: the entering
hash and value|rev<<30 at j, the election of window j+1 (value|rev<<30,
in-window position, hash), the masked sync flags (bool), and ``init``
(4, n_rec) = each record's window-0 election (value|rev<<30, position,
hash hi, hash lo). Lookahead past the last position wraps to position
0, as the TPU row layout's halo does (field.py:104-107).
"""

from __future__ import annotations

import torch

from supersampler_tpu_torch.ops import _build
from supersampler_tpu_torch.ops import u64 as U
from supersampler_tpu_torch.ops.minimizer import (mmer_build, mmer_elect,
                                                  unpack_2bit)

_I32 = torch.int32


def _check_args(packed, k: int, m: int, P_rec: int, last_i=None):
    """(P, n_rec) of a valid scan call; last_i, where given, must be the
    records' int32 bounds on packed's device."""
    W = k - m + 1
    if not (1 <= m <= 15 and m <= k <= 63):
        raise ValueError(f"unsupported (k, m) = ({k}, {m})")
    P = packed.numel() * 4
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError("packed must be a flat uint8 tensor")
    if P_rec <= k + W or P % P_rec:
        raise ValueError(f"P_rec={P_rec} must divide P={P} and exceed k+W")
    n_rec = P // P_rec
    if last_i is not None and (last_i.dtype != _I32
                               or last_i.shape != (n_rec,)
                               or last_i.device != packed.device):
        raise ValueError("last_i must be int32 (n_rec,) on packed's device")
    return P, n_rec


def scan_plain(packed: torch.Tensor, k: int, m: int, P_rec: int,
               last_i: torch.Tensor):
    """Plain PyTorch field scan (the kernel's executable spec)."""
    P, n_rec = _check_args(packed, k, m, P_rec, last_i)
    W = k - m + 1
    dev = packed.device
    codes = unpack_2bit(packed, P).to(torch.int64)
    # m-mers at [0, P + W) and windows at [0, P] need codes [0, P + k)
    ext = torch.cat([codes, codes[:k]])
    canon, rev, hh = mmer_build(ext, m, P + W)
    em, ep, er, eh = mmer_elect(canon, rev, hh, k, m, P + 1)

    h0 = hh[W : W + P]
    cv = canon[W : W + P] | (rev[W : W + P].to(torch.int64) << 30)
    em_r = em[1:] | (er[1:].to(torch.int64) << 30)

    # sync: strict minimum against the previous 2W entering hashes
    hk = U.key(h0)
    pad = torch.full((2 * W,), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=dev)
    prev_min = torch.cat([pad, hk[:-1]]).unfold(0, 2 * W, 1).amin(1)
    jloc = torch.arange(P, device=dev) % P_rec
    li = last_i.to(torch.int64).repeat_interleave(P_rec)
    sync = (hk < prev_min) & (jloc >= 2 * W) & (jloc <= li)

    r0 = torch.arange(n_rec, device=dev) * P_rec
    init = torch.stack([
        (em[r0] | (er[r0].to(torch.int64) << 30)).to(_I32),
        ep[r0].to(_I32), *U.split(eh[r0])])
    return (*U.split(h0), cv.to(_I32), em_r.to(_I32), ep[1:].to(_I32),
            *U.split(eh[1:]), sync, init)


def scan_kernel(packed: torch.Tensor, k: int, m: int, P_rec: int,
                last_i: torch.Tensor):
    """Field scan: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. ``scan_kernel.launches`` counts kernel launches."""
    if packed.device.type == "cpu":
        return scan_plain(packed, k, m, P_rec, last_i)
    P, n_rec = _check_args(packed, k, m, P_rec, last_i)
    if packed.device.type != "cuda":
        raise ValueError(f"no scan kernel for device {packed.device}")
    if not (packed.is_contiguous() and last_i.is_contiguous()):
        raise ValueError("scan_kernel needs contiguous inputs")
    dev = packed.device
    tabs = [torch.empty(P, dtype=_I32, device=dev) for _ in range(7)]
    sync = torch.empty(P, dtype=torch.bool, device=dev)
    init = torch.empty((4, n_rec), dtype=_I32, device=dev)
    _build.launch(
        "spsp_scan", dev, packed.data_ptr(), P, P_rec, k, m,
        last_i.data_ptr(), *(t.data_ptr() for t in tabs), sync.data_ptr(),
        init.data_ptr())
    scan_kernel.launches += 1
    return (*tabs, sync, init)


scan_kernel.launches = 0
