#!/usr/bin/env python3
"""Where the time of one sketch goes, per layer, on the port.

    python3 chip_profile.py [--seed N] [--runs 3] [--device cuda] [--fused]

Sketches the two bench cells of chip_smoke.py (8 x 4,194,000 bp genome
records and 10,000 x 1 kb reads, k=31, m=11, s=1000, random sequence
from --seed) with ``TorchSubsampler.sketch_file``: one warm-up run, then
--runs runs with a wall timer around each layer (parse, prep, device,
assemble, serialize), then one run under ``torch.profiler`` that lists
the device events by summed time and the device's busy share of the
profiled wall. The device layer's timer includes the fetch, which waits
for the device. --fused sets SPSP_FUSED=1, so the single and batch
routes take the v2 path (ops/fused.py; CUDA only). Smaller corpora
(--n-rec, --glen, --n-reads) and --device cpu check the script itself
without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from chip_smoke import K, M, S, TILE_L, gpu_line, write_fasta

# layer -> the methods whose wall time it sums
_LAYERS = {
    "prep": [("TorchSubsampler", "_prep_chunk")],
    "device": [("TorchSubsampler", "_resolve_group"),
               ("TorchSubsampler", "_single"), ("FieldChain", "compact")],
    "assemble": [("TorchSubsampler", "_ingest_run"),
                 ("TorchSubsampler", "_assemble_compact")],
    "serialize": [("TorchSubsampler", "serialize")],
}


def instrument(pipeline, acc):
    """Wrap the pipeline's layer methods and its FASTA stream with wall
    timers that add into acc[layer]."""
    def timed(fn, layer):
        def wrap(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[layer] += time.perf_counter() - t0
        return wrap

    for layer, targets in _LAYERS.items():
        for cls, name in targets:
            c = getattr(pipeline, cls)
            setattr(c, name, timed(getattr(c, name), layer))
    stream = pipeline.stream_fasta_spans

    def timed_stream(*a, **kw):
        it = stream(*a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                acc["parse"] += time.perf_counter() - t0
            yield item

    pipeline.stream_fasta_spans = timed_stream


def device_events(prof):
    """(rows sorted by summed microseconds, busy microseconds): device
    events grouped by name, and the union of their intervals."""
    from torch.autograd import DeviceType

    rows = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        r = rows[e.name]
        r[0] += e.time_range.elapsed_us()
        r[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return sorted(rows.items(), key=lambda kv: -kv[1][0]), busy


def profile_cell(path, bases, device, runs, acc):
    from supersampler_tpu_torch.sketch import TorchSubsampler

    def once():
        t0 = time.perf_counter()
        TorchSubsampler(k=K, m=M, s=S, device=device).sketch_file(path)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    name = os.path.basename(path)
    once()
    for r in range(runs):
        acc.clear()
        wall = once()
        layers = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in acc.items())
        print(f"{name} run {r}: wall {wall:.4f} s, "
              f"{bases / 1e6 / wall:.1f} Mbases/s; {layers}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        wall = once()
    rows, busy = device_events(prof)
    print(f"{name} profiled: wall {wall:.4f} s, device events "
          f"{sum(r[0] for _, r in rows) / 1e3:.3f} ms, busy "
          f"{busy / 1e3:.3f} ms ({busy / 1e6 / wall:.3f} of the wall)")
    for ev, (us, n) in rows[:15]:
        print(f"  {us / 1e3:8.3f} ms x {n:4d}  {ev[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rec", type=int, default=8)
    ap.add_argument("--glen", type=int, default=TILE_L)
    ap.add_argument("--n-reads", type=int, default=10_000)
    ap.add_argument("--fused", action="store_true",
                    help="profile the v2 path (SPSP_FUSED=1)")
    args = ap.parse_args(argv)
    if args.fused:
        os.environ["SPSP_FUSED"] = "1"
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("chip_profile: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 2
        print(f"{gpu_line()}; path {'v2' if args.fused else 'v1'}",
              flush=True)
    from supersampler_tpu_torch.sketch import pipeline

    acc = defaultdict(float)
    instrument(pipeline, acc)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        cells = []
        for name, rows, n in (("genome.fa", args.n_rec, args.glen),
                              ("reads.fa", args.n_reads, 1000)):
            path = os.path.join(tmp, name)
            bases = write_fasta(
                path, rng.integers(0, 4, (rows, n), dtype=np.uint8), b"r")
            cells.append((path, bases))
        for path, bases in cells:
            profile_cell(path, bases, device, args.runs, acc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
