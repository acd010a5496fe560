#!/usr/bin/env python3
"""Where the time of one sketch goes, per layer, on the port.

    python3 chip_profile.py [--seed N] [--runs 3] [--device cuda] [--fused]

Three cells at k=31, m=11, s=1000, random sequence from --seed: the two
bench cells of chip_smoke.py (one file of 8 x 4,194,000 bp genome
records, one of 10,000 x 1 kb reads), each through
``TorchSubsampler.sketch_file``, and a fof cell, the 8 genome records
as 8 files through ``sketch_fof`` (the sub_sampler -f path). Each cell
has one warm-up run, then --runs runs that print the wall and the
pipeline's own phase timers (``supersampler_tpu_torch.utils.profiling.
timers``: parse, prep, dispatch, device+fetch, assemble, serialize),
then one run under ``torch.profiler`` that lists the device events by
summed time and the device's busy share of the profiled wall. The
stages run on their own threads (reader, prep pool, device thread,
caller) and overlap, so the phases may sum to more than the wall;
device+fetch is the device thread's wait for results, which includes
the device's work. --fused sets SPSP_FUSED=1, so the single and batch
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

_PHASES = ("parse", "prep", "dispatch", "device+fetch", "assemble",
           "serialize")


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


def profile_cell(name, paths, bases, device, runs):
    """One cell: sketch_file of paths[0], or sketch_fof of every path
    when there are several."""
    from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof
    from supersampler_tpu_torch.utils.profiling import timers

    def once():
        sss = [TorchSubsampler(k=K, m=M, s=S, device=device) for _ in paths]
        t0 = time.perf_counter()
        if len(paths) == 1:
            sss[0].sketch_file(paths[0])
        else:
            sketch_fof(list(zip(sss, paths)))
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    once()
    for r in range(runs):
        timers.reset()
        wall = once()
        layers = ", ".join(
            f"{p} {timers.totals.get(p, 0.0) * 1e3:.1f} ms" for p in _PHASES)
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
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[2].replace("\n", " "))
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
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        genome_rows = rng.integers(0, 4, (args.n_rec, args.glen),
                                   dtype=np.uint8)
        genome = os.path.join(tmp, "genome.fa")
        g_bases = write_fasta(genome, genome_rows, b"r")
        reads = os.path.join(tmp, "reads.fa")
        r_bases = write_fasta(reads, rng.integers(
            0, 4, (args.n_reads, 1000), dtype=np.uint8), b"r")
        fof = []
        for i, row in enumerate(genome_rows):
            fof.append(os.path.join(tmp, f"genome{i}.fa"))
            write_fasta(fof[-1], [row], b"r")
        for name, paths, bases in (("genome.fa", [genome], g_bases),
                                   ("reads.fa", [reads], r_bases),
                                   (f"fof of {len(fof)} genome files", fof,
                                    g_bases)):
            profile_cell(name, paths, bases, device, args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
