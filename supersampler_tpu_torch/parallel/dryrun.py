"""A multi-device dry run of the product pipeline on small shapes.

Counterpart of ``dryrun_multichip`` in the repo root's
``__graft_entry__.py`` (:44-143), which drives the JAX package.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from supersampler_tpu_torch.compare.merge import TorchComparator
from supersampler_tpu_torch.core.scalar import compute_threshold
from supersampler_tpu_torch.ops.field import (parse_batched_array,
                                              scan_resolve_batch)
from supersampler_tpu_torch.ops.minimizer import pack_2bit
from supersampler_tpu_torch.parallel.mesh import (make_mesh,
                                                  sharded_field_resolve_fn)
from supersampler_tpu_torch.sketch import TorchSubsampler, subsample_file


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """Run the product pipeline once over an n_devices mesh, asserting
    its outputs:

      1. the mesh-sharded field scan and resolve, 2 records a device,
         record-for-record equal to one device's scan_resolve_batch of
         the whole batch (both parsed with parse_batched_array);
      2. a small genome family sketched through TorchSubsampler;
      3. its comparison with the device engine over the mesh, whose
         containment and jaccard CSVs must equal the numpy engine's.

    ``devices`` (names or torch.device, repeats allowed) overrides the
    first n_devices of make_mesh(); fewer than n_devices raises."""
    if devices is None:
        devices = make_mesh().devices
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    mesh = make_mesh(list(devices)[:n_devices])
    home = mesh.devices[0]

    # --- 1. the sharded field engine, 2 records a device ---
    k, m, P_rec, cap = 31, 11, 1024, 2048
    B = 2 * n_devices
    thr = compute_threshold(k, m, 50.0)
    thr = (thr >> 32, thr & 0xFFFFFFFF)
    rng = np.random.default_rng(1)
    lengths = rng.integers(200, 900, size=B).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, P_rec), dtype=np.uint8)
    codes[np.arange(P_rec) >= lengths[:, None]] = 0
    packed = pack_2bit(torch.from_numpy(codes)).reshape(B, P_rec // 4)
    lengths = torch.from_numpy(lengths)
    rows = sharded_field_resolve_fn(mesh, k, m, P_rec, cap)(
        packed, lengths, *thr)
    got = []
    for row in rows:
        g, _n, comps, _st = parse_batched_array(row, cap, B // n_devices)
        if g != 0 or comps is None:
            raise AssertionError(f"a shard did not resolve (status {g})")
        got.extend(comps)
    whole = scan_resolve_batch(packed.to(home), k, m, P_rec, cap,
                               lengths.to(home), *thr).cpu().numpy()
    g, _n, want, _st = parse_batched_array(whole, cap, B)
    if g != 0 or want is None:
        raise AssertionError(f"the whole batch did not resolve (status {g})")
    for b in range(B):
        for i, (x, y) in enumerate(zip(got[b], want[b], strict=True)):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"sharded field engine diverges at "
                                     f"record {b}, field {i}")

    # --- 2 and 3: sketch a family, compare it over the mesh ---
    base = rng.integers(0, 4, 4000, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        sketches = []
        for i, mut in enumerate((0.0, 0.02, 0.1, 0.5)):
            seq = base.copy()
            hit = rng.random(seq.size) < mut
            seq[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.uint8)
            fa = os.path.join(d, f"g{i}.fa")
            with open(fa, "wb") as f:
                f.write(b">g%d\n" % i + np.frombuffer(
                    b"ACGT", np.uint8)[seq].tobytes() + b"\n")
            ss = TorchSubsampler(k=k, m=m, s=5.0, device=home)
            sketches.append(subsample_file(ss, fa, os.path.join(d, "dry_")))
        csvs = {}
        for engine, msh in (("numpy", None), ("device", mesh)):
            comp = TorchComparator(engine=engine, mesh=msh)
            comp.files_names = list(sketches)
            comp.compare_sketches(len(sketches))
            csvs[engine] = (comp.containment_csv(), comp.jaccard_csv())
        if csvs["numpy"] != csvs["device"]:
            raise AssertionError("mesh comparator CSVs diverge from the "
                                 "numpy engine's")
    print(f"dryrun_multichip({n_devices}): sharded field engine "
          f"record-equal to one device, sketch -> compare over a "
          f"{n_devices}-entry mesh {[str(x) for x in mesh.devices]}, CSVs "
          f"match the numpy engine")

