#!/usr/bin/env python3
"""Where the walk kernel's time goes, on one CUDA card.

    python3 chip_walk_probe.py [--seed N] [--against OTHER_walk.cu]

Builds supersampler_tpu_torch/csrc/walk.cu with its own nvcc into
build/walk_probe/ and prints ptxas's registers, spills and shared memory
for each kernel. With --against (another walk.cu with the same C
interface, such as a parent commit's; one without spsp_walk_work_bytes
is taken as the one-CTA kernel, whose rows the caller fills with -1
first) that file is built too, in parallel, must give the kernel's
outputs bit for bit, and is timed in turns with it (other, kernel,
kernel, other, twice), each as walk_kernel calls it (allocation and
fills included). Inputs, at k=31, m=11: the successor words of
chip_smoke.py's 4 Mbp tile (4,194,304 positions, 2,048 blocks) at
s = 1000 and s = 1, and the 1-block walk of a 1,000-base record padded
to 2,048 positions (the batch route's per-record fallback). The kernel
is also timed per pass: the maps alone, maps and compose, the emit pass
alone (which only reads what the first two left). Last, the walks of
two cells are recorded as the pipeline makes them and replayed through
each library in turns, their device times summed: the desert corpus of
chip_smoke.py on the field engine (every fallback route) and the bench
genome (8 x 4,194,000 bp) on the legacy engine. Times are CUDA events
over 20 launches (5 for the cells) with the queue filled first
(chip_smoke.cuda_ms). Needs nvcc and one card; no network.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as CS
from supersampler_tpu_torch.ops import _build
from supersampler_tpu_torch.ops import walker as TW
from supersampler_tpu_torch.ops.minimizer import (pack_2bit,
                                                  scan_tables_2d_packed)
from supersampler_tpu_torch.sketch import TorchSubsampler

SRC = os.path.join(CS.ROOT, "supersampler_tpu_torch", "csrc", "walk.cu")
OUT = os.path.join(CS.ROOT, "build", "walk_probe")
_V, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def ptxas_report(log: str) -> list[str]:
    """One line per kernel: its name, then ptxas's use and spill lines."""
    out = []
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            out.append(next((k for k in ("walk_maps", "walk_compose",
                                         "walk_emit", "walk_kernel")
                             if k in name), name) + ":")
        elif out and ("Used" in line or "spill" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip()
    return out


def build(sources: dict) -> dict:
    """{name: .cu path} -> {name: ctypes library}, one nvcc each."""
    os.makedirs(OUT, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-shared", "-o",
         os.path.join(OUT, name + ".so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in ptxas_report(log):
            print(f"  ptxas {name}, {line}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.new = hasattr(lib, "spsp_walk_work_bytes")
        if lib.new:
            lib.spsp_walk.argtypes = [_V, _I] + [_V] * 8
            lib.spsp_walk_pass.argtypes = [_I, _V, _I] + [_V] * 8
            lib.spsp_walk_work_bytes.restype = _I64
            lib.spsp_walk_work_bytes.argtypes = [_I]
        else:
            lib.spsp_walk.argtypes = [_V, _I] + [_V] * 7
        libs[name] = lib
    return libs


class Walk:
    """One library's walk over fixed words: outputs and scratch made as
    walk_kernel makes them (the one-CTA kernel's rows filled with -1)."""

    def __init__(self, lib, words, init5):
        self.lib, self.words, self.init5 = lib, words, init5
        self.nb = words.numel() // TW._BP
        n = lib.spsp_walk_work_bytes(self.nb) if lib.new else 0
        self.work = torch.empty(max(n, 16), dtype=torch.uint8, device="cuda")

    def _outs(self):
        make = torch.empty if self.lib.new else (
            lambda *a, **k: torch.full(*a, -1, **k))
        outs = [make((self.nb, TW._BP), dtype=torch.int32, device="cuda")
                for _ in range(3)]
        return outs + [torch.empty(self.nb, dtype=torch.int32, device="cuda"),
                       torch.empty(6, dtype=torch.int32, device="cuda")]

    def _args(self, outs):
        return (self.words.data_ptr(), self.nb, self.init5.data_ptr(),
                *(o.data_ptr() for o in outs))

    def __call__(self):
        outs = self._outs()
        work = (self.work.data_ptr(),) if self.lib.new else ()
        _build.check(self.lib.spsp_walk(
            *self._args(outs), *work,
            torch.cuda.current_stream().cuda_stream), "spsp_walk")
        return outs

    def passes(self, which, outs):
        """Run the given passes of the three-launch walk into outs."""
        for p in which:
            _build.check(self.lib.spsp_walk_pass(
                p, *self._args(outs), self.work.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "spsp_walk_pass")


def inputs(rng) -> dict:
    """{name: (words, init5)} on the card: the tile at s = 1000 and s = 1
    and the 1-block walk."""
    own = CS.TILE_P - 512
    codes = torch.from_numpy(rng.integers(0, 4, CS.TILE_P, dtype=np.uint8))
    read = np.zeros(2048, np.uint8)
    read[:1000] = rng.integers(0, 4, 1000, dtype=np.uint8)
    out = {}
    for s, name in ((CS.S, "tile s=1000"), (1.0, "tile s=1"),
                    (CS.S, "1 block")):
        thr = TorchSubsampler(k=CS.K, m=CS.M, s=s, device="cuda").threshold
        thr_w = (thr >> 32, thr & 0xFFFFFFFF)
        if name == "1 block":
            t = scan_tables_2d_packed(CS.pack_codes(read, "cuda"), CS.K, CS.M,
                                      2048, 1000, *thr_w)
            words = TW.pack_succ(t, 2048)
        else:
            t = scan_tables_2d_packed(pack_2bit(codes).to("cuda"), CS.K,
                                      CS.M, CS.TILE_P, 2 * own, *thr_w)
            words = TW.pack_succ(t, own)
        out[name] = (words, TW._init5_from_tables(t))
    return out


def record_walks(run) -> list:
    """(words, init5) of every walk_kernel call made by run()."""
    calls = []
    kernel = TW.walk_kernel

    def recording(words, init5):
        calls.append((words.clone(), init5.clone()))
        return kernel(words, init5)

    recording.launches = 0
    TW.walk_kernel = recording
    try:
        run()
    finally:
        TW.walk_kernel = kernel
    return calls


def cell_walks(rng) -> dict:
    """{cell: recorded walks} of the desert corpus (field engine) and
    the bench genome (legacy engine), sketched on the card."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        desert, _ = CS.desert_corpus(rng, tmp)
        genome = os.path.join(tmp, "genome.fa")
        CS.write_fasta(genome, rng.integers(0, 4, (8, CS.TILE_L),
                                            dtype=np.uint8), b"chr")
        for cell, path, engine in (("desert corpus", desert, "field"),
                                   ("legacy genome", genome, "legacy")):
            ss = TorchSubsampler(k=CS.K, m=CS.M, s=CS.S, device="cuda")
            ss.scan_engine = engine
            out[cell] = record_walks(lambda: ss.sketch_file(path))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", help="another walk.cu to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_walk_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    gpu = CS.gpu_line()
    print(gpu, flush=True)
    sources = {"kernel": SRC}
    if args.against:
        sources["other"] = args.against
    libs = build(sources)
    cells = inputs(np.random.default_rng(args.seed))
    for name, (words, init5) in cells.items():
        got = Walk(libs["kernel"], words, init5)()
        if name == "1 block":
            err = CS.max_abs_err(got, TW.walk_plain(words, init5))
            if err:
                raise AssertionError(f"kernel != walk_plain on the {name}")
        if args.against:
            err = CS.max_abs_err(Walk(libs["other"], words, init5)(), got)
            if err:
                raise AssertionError(f"other != kernel on the {name}")
        print(f"  {name}: {int(got[4][0])} events, {int(got[3].sum())} "
              f"emits{', other == kernel' if args.against else ''}",
              flush=True)
    order = (["other", "kernel", "kernel", "other"] * 2 if args.against
             else ["kernel"])
    for name in order:
        times = [f"{cell} {CS.cuda_ms(Walk(libs[name], *wi), 20):.4f}"
                 for cell, wi in cells.items()]
        print(f"  {name:6s} ms: {', '.join(times)} [{gpu}]", flush=True)
    for cell, wi in cells.items():
        w = Walk(libs["kernel"], *wi)
        if w.nb == 1:
            continue
        outs = w()
        t = {key: CS.cuda_ms(lambda p=p: w.passes(p, outs), 20)
             for key, p in (("maps", (0,)), ("maps+compose", (0, 1)),
                            ("emit", (2,)), ("all", (0, 1, 2)))}
        w.passes((0, 1, 2), outs)
        if CS.max_abs_err(outs, w()):
            raise AssertionError(f"the passes one by one != spsp_walk on "
                                 f"the {cell}")
        print(f"  kernel passes at the {cell}: maps {t['maps']:.4f} ms, "
              f"compose {t['maps+compose'] - t['maps']:.4f} ms (maps+compose "
              f"{t['maps+compose']:.4f}), emit {t['emit']:.4f} ms, all three "
              f"{t['all']:.4f} ms [{gpu}]", flush=True)
    walks = cell_walks(np.random.default_rng(args.seed + 1))
    for cell, calls in walks.items():
        sizes = sorted({w.numel() // TW._BP for w, _ in calls})
        print(f"  {cell}: {len(calls)} walks of {sizes} blocks", flush=True)
        if args.against:
            for words, init5 in calls:
                if CS.max_abs_err(Walk(libs["other"], words, init5)(),
                                  Walk(libs["kernel"], words, init5)()):
                    raise AssertionError(f"other != kernel in the {cell}")
    for name in order:
        times = [f"{cell} {sum(CS.cuda_ms(Walk(libs[name], *wi), 5)
                               for wi in calls):.4f}"
                 for cell, calls in walks.items()]
        print(f"  {name:6s} walk device ms per cell: {', '.join(times)} "
              f"[{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
