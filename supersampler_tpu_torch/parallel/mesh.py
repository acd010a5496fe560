"""Device-mesh sharding for the sketch engine.

Counterpart of supersampler_tpu/parallel/mesh.py. Sketching is
embarrassingly parallel over records (the reference's only parallelism
is the file-level OpenMP fan-out, SubSampler.cpp:771-798), so a mesh
here is a list of devices, one shard each: the record batch is cut into
``mesh.size`` contiguous shards, each shard is copied to its device and
run there, and nothing crosses between devices but the results. The
shards are issued in turn from one process, each one's work queued
before any result is read; a device may be listed more than once, so a
mesh of ``["cuda:0"] * 4`` runs the split and the merge on one card.
Each kernel launches with its shard's device made current
(ops/_build.launch), whatever device the caller has current.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from supersampler_tpu_torch import DEVICE_ENV
from supersampler_tpu_torch.ops.field import scan_resolve_batch
from supersampler_tpu_torch.ops.minimizer import (ScanTables, pack_2bit,
                                                  scan_tables_2d_packed)


@dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis mesh, one shard per entry (an entry
    may repeat)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (names or torch.device), by default every
    visible CUDA device. Without a CUDA device the default raises: the
    CPU is taken only when the caller lists CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes every CUDA device, but "
                "torch.cuda.is_available() is false; list CPU devices "
                f"(as {DEVICE_ENV}=cpu does for one device) to run the "
                "plain path on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def _shards(mesh: Mesh, B: int):
    """[(device, start, end)] of a B-record batch cut into mesh.size
    contiguous shards."""
    if B % mesh.size:
        raise ValueError(f"batch of {B} records is not a multiple of the "
                         f"mesh size {mesh.size}")
    b = B // mesh.size
    return [(dev, d * b, (d + 1) * b) for d, dev in enumerate(mesh.devices)]


def batched_scan_fn(k: int, m: int, padded_len: int):
    """Scan over a batch of sequences: (B, P) uint8 codes, (B,) lengths
    and the threshold's two 32-bit halves -> ScanTables with a leading
    batch axis, on the codes' device. Each record goes through
    ``pack_2bit`` and ``scan_tables_2d_packed`` (one scan kernel launch
    on CUDA)."""

    def fn(codes: torch.Tensor, lengths, thr_hi: int,
           thr_lo: int) -> ScanTables:
        rows = [scan_tables_2d_packed(pack_2bit(c), k, m, padded_len,
                                      int(n), thr_hi, thr_lo)
                for c, n in zip(codes, torch.as_tensor(lengths).tolist())]
        return ScanTables(*(torch.stack(f) for f in zip(*rows)))

    return fn


def sharded_scan_fn(mesh: Mesh, k: int, m: int, padded_len: int):
    """batched_scan_fn with the batch sharded over the mesh: B must be a
    multiple of mesh.size; each device scans B / mesh.size sequences.
    The tables are gathered on the mesh's first device."""
    one = batched_scan_fn(k, m, padded_len)

    def fn(codes: torch.Tensor, lengths, thr_hi: int,
           thr_lo: int) -> ScanTables:
        codes = torch.as_tensor(codes)
        lengths = torch.as_tensor(lengths)
        parts = [one(codes[s:e].to(dev), lengths[s:e], thr_hi, thr_lo)
                 for dev, s, e in _shards(mesh, codes.shape[0])]
        home = mesh.devices[0]
        return ScanTables(*(torch.cat([x.to(home) for x in f])
                            for f in zip(*parts)))

    return fn


def sharded_field_resolve_fn(mesh: Mesh, k: int, m: int, P_rec: int,
                             sel_cap: int):
    """The batched field scan and resolve (``scan_resolve_batch``, the
    program TorchSubsampler runs on a short-record batch) with the
    record batch sharded over the mesh.

    Returns a function of (packed (B, P_rec/4) uint8, lengths (B,)
    int32, thr_hi, thr_lo) giving the (mesh.size, arr_len) int32 numpy
    stack of the shards' fetch arrays; parse row d with
    ``parse_batched_array(row, sel_cap, B // mesh.size)``. Each shard
    runs the scan and sweep kernels on CUDA (the v2 scan and the col
    sweep under SPSP_FUSED=1); every shard is issued before any is
    fetched."""

    def fn(packed: torch.Tensor, lengths, thr_hi: int,
           thr_lo: int) -> np.ndarray:
        packed = torch.as_tensor(packed)
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        arrs = [scan_resolve_batch(packed[s:e].to(dev), k, m, P_rec,
                                   sel_cap, lengths[s:e].to(dev), thr_hi,
                                   thr_lo)
                for dev, s, e in _shards(mesh, packed.shape[0])]
        return np.stack([a.cpu().numpy() for a in arrs])

    return fn
