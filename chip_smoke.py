#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (supersampler_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its result; any failure exits non-zero:
  0. device: the card's name and power limit (nvidia-smi);
  1. build: nvcc builds the scan (v1 and v2), sweep and walk kernels
     from csrc/, one process per source, all started together;
  2. kernels against their plain PyTorch versions on the card, bit-equal
     (integer outputs, tolerance 0): the scan and the v2 scan on a full
     4 Mbp tile at (k, m) = (31, 11), (63, 15), (15, 5), on the same
     tile made of tandems and homopolymers (timed beside the random
     tile), on a 1,024 x 1 kb read batch and on every kind of
     tests/scan_cases.py at its four (k, m), single record and batch;
     every sweep ("lane" layout) of that tile's
     and that batch's v1 resolves, each again with its tables in the
     "col" layout (col kernel == lane kernel); the sweep on the
     adversarial inputs of tests/sweep_cases.py (and one at the tile's
     width) in both layouts; every "col" sweep of the v2 resolves
     (fused_single / fused_batch), whose fetch arrays must equal v1's
     there, on the tile with a 3 kb homopolymer (prefix passes 2..4) and
     at s = 1; the walk over a full tile's successor words at s = 1000
     and s = 1, over the next tile entered from its carry, over every
     kind of tests/walk_cases.py at 1, 3 and 64 blocks, and as the
     1-block walk of a 1 kb record (timed beside the tile). Kernel
     and plain times come from CUDA events, with the queue filled first
     so that launches run back to back (the sweep 1 also at the host's
     pace); every sweep of the tile and batch resolves is timed in both
     layouts, as is the successor-table pass at the tile;
  3. goldens: the 10 tests/golden sketches, the CLI's compressed
     output and stdout, and the CLI's -f outputs (gfam_fam0-3.gz), from
     sketches made on the card, on v1 and again on v2 (SPSP_FUSED=1);
     the 10 through the exact engine
     (scan_engine = "legacy");
  4. real size: a 5 Mbp genome (two tiles) and 2,000 x 1 kb reads give
     the same bytes on the card and on the CPU; a desert corpus (a
     12 Mbp record with a 3 kb poly-T in tile 1, a 100 kb record with a
     3 kb poly-A, 2,000 x 1 kb reads among 20 desert records) falls back
     to the walker on every route and gives the same bytes on the card,
     on the CPU and through the legacy engine on the card; the bench
     corpus (8 x 4,194,000 bp, 10,000 x 1 kb reads, k=31, m=11, s=1000)
     runs through the CLI on the card, and its genome again through the
     legacy engine, whose sketch must hash the same. The desert corpus
     and the bench corpus run again on v2 (SPSP_FUSED=1): same bytes,
     fallbacks on the single and batch routes, v1 and v2 walls side by
     side. Each of these paths runs with the launch counters reset
     before and read after;
  5. comparator: the comparator CLI on the family goldens
     (gfam_fam0-3.gz), all-vs-all and in query mode, on the device and
     the numpy engine, in RAM and at --chunk-bytes 16384: CSVs
     byte-equal to tests/golden/allvsall_* and query_*, torch._int_mm
     launched on the device engine only; then 64 genomes of 2 Mbp (8
     families of 8, 0.5-5 % point substitutions) sketched by the
     sub_sampler CLI (-f, s = 100) and compared all-vs-all and 8-vs-64
     on both engines, chunked at 1 MiB, through score_matrix_device at
     4,096 groups a step (card == CPU) and through the comparator CLI:
     every score_A, nb_kmer_seen_infile and CSV agrees; sort_csv and
     kmer_dump on that corpus; the comparators' walls, and the
     presence product's time (CUDA events) beside its bound (block
     bytes over the HBM rate against int8 operations over the dense
     int8 tensor-core rate). The product is a library call
     (cuBLASLt), not a kernel of the table;
  6. multi-device (parallel/mesh.py, dist.py, dryrun.py): a 4,096 x
     2,048-position read batch through sharded_field_resolve_fn over
     every card and over cuda:0 listed four times, on v1 and v2, record
     for record equal to one scan_resolve_batch, with the scan (v2 scan)
     and sweep launched on every shard; sharded_scan_fn over four
     entries equal to batched_scan_fn; phase 5's 64 sketches compared
     over a four-entry mesh (CSVs equal the numpy engine's, the score
     matrix one device's at the default step and at 4,096 groups a
     step); two gloo processes on the card (tests/torch_dist_worker.py)
     comparing those sketches (CSVs byte-equal to the CLI's) and
     sketching 8 of the genomes (bytes equal to phase 5's); the dry run
     over every card and over cuda:0 listed four times;
  7. sketch_fof (the sub_sampler -f path) over a fof of 8 genomes of
     4,194,000 bp, 2 read sets of 10,000 x 1 kb, 200 viral-size files
     of 30 kb, a file of the prep faults' input (empty records next to
     headers ahead of short and long records, N/R/Y runs, lowercase,
     CB/TU/GF/A@ pairs) and a missing entry in the middle, at k=31,
     m=11, s=1000: every sketch equals its file's own sketch_file and
     the -f CLI's output (out-fof in fof order, the missing entry
     reported and skipped); the fault file and 8 viral files also equal
     the CPU path's, v2's and the legacy engine's. Prints the first
     pass's wall and launches, then warm walls of the fof and of the
     per-file sketch_file calls in turns, the phase timers' report
     (utils/profiling.py) of the last fof pass and each run's launches.
  8. device dedup and the Python store (ops/dedup.py, sketch/store.py):
     dedup_spans on the card == on the CPU for the spans of a 4 Mbp tile
     at s = 1000 and s = 64 and of a 100 kb record at s = 1 (card and CPU
     times printed); sketches with device_dedup = True on the card, each
     byte-equal to the default path's on the card: the 5 Mbp genome at
     s = 1000 and s = 64, the desert corpus's 12 Mbp and 100 kb records
     (tile fallbacks), the bench genome set, 2,000 reads of which 200
     are 300-790 bp (the walk route) and the genome through the legacy
     engine; native_finisher = False on the genome; the 10 goldens with
     each opt-in. Each run's walls beside the default path's, its
     launches (the scan and sweep, or the walk, of its routes must
     launch) and its phase timers' report.
  9. the card against the port's scalar oracle (supersampler_tpu_torch/
     oracle, pure Python, sharing with the card path only the k-mer
     store, the counters and the threshold): 40 fuzz files of
     tests/oracle_cases.py's shapes (empty records, N/R/Y runs,
     lowercase, CB/TU/GF/A@ pairs, CRLF, blank lines, odd widths,
     records shorter than k and at the 1,024-position route boundary,
     3 kb homopolymers and tandems) at the 10 (k, m, s, a) of
     oracle_cases.CONFIGS, and a random and a repeat-rich 1 Mbp record
     at s = 64 and 1000: each card sketch (v1 per file, sketch_fof on
     v1, v2 and the legacy engine, device_dedup at the golden
     configurations) byte-equal to OracleSubsampler's, with equal
     print_stat counters; then OracleComparator, the device engine and
     the numpy engine on 12 of those sketches and 8 of phase 5's, all-vs-
     all and in query mode: byte-equal CSVs, and zero eval.norms between
     the device's and the oracle's. Prints the launches, the oracle's CPU
     seconds and the card path's seconds.
After the phases no supersampler_tpu module may have been imported.
The line before the last is the kernel table, each kernel with its
time, its plain version's time and its bound (the larger of the bytes
it must move over the HBM rate and its 32-bit ALU operations over the
card's scalar peak), the scans also with the batch's time and bound and
their time on the tile of repeats, the launches of one sharded call
of phase 6's batch over four entries (mesh_launches), the launches in
phase 7's runs (fof_launches), in phase 8's device-dedup sketches
(dedup_launches) and in phase 9's card sketches (oracle_launches), the
sweeps (sweep 1 of the tile resolve) also with the sum over the
resolve's five sweeps and their bounds and the batch's times; the last
line is
{"ok": true, "device": {...}}.
Needs one CUDA card; no network.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext, redirect_stdout

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TILE_P = (1 << 22) + 512          # one 4 Mbp tile: own + extra positions
TILE_L = 4_194_000                # the bench corpus's record length
K, M, S = 31, 11, 1000.0
_ACGT = np.frombuffer(b"ACGT", np.uint8)

# bounds (H100 SXM datasheet): HBM at 3.35 TB/s; the kernels' work is
# 32-bit integer ALU, for which the datasheet gives no rate of its own,
# so the float32 rate outside the tensor cores (67 T/s)
# stands in: a ceiling, so the bound stays a floor
HBM_BPS = 3.35e12
ALU_OPS = 67e12
# dense int8 tensor-core peak (datasheet), the comparator product's rate
INT8_OPS = 1979e12
# 32-bit operations per unit of work, counted low from csrc/
OPS_HASH = 40        # one XXHash64 of an m-mer (five 64-bit multiplies)
OPS_FOLD = 8         # one step of the election fold or a window minimum
OPS_STEP = 10        # one sweep column step, one sweep event, one walk event


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, paced: bool = False) -> float:
    """Mean milliseconds per call of fn on the current stream. The queue
    is first filled with a sleep kernel, so that the launches run back
    to back on the card and the host's launch cost stays out of the
    time; paced=True leaves it out, so a kernel shorter than its launch
    cost is timed at the host's pace."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if not paced:
        torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def max_abs_err(got, want) -> int:
    """Largest |difference| over paired integer/bool tensors; raises
    unless every pair has the same shape and dtype."""
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return err


class SweepCheck:
    """A sweep for resolve_field that runs the kernel and the plain
    version on the same inputs, requires bit-equality, records every
    call (inputs and the kernel's exit state) and returns the kernel's
    result."""

    def __init__(self):
        self.calls = []
        self.max_abs_err = 0

    @property
    def n(self) -> int:
        return len(self.calls)

    def __call__(self, tabs, se, st0, *rest):
        from supersampler_tpu_torch.ops.field import sweep_kernel, sweep_plain

        got = sweep_kernel(tabs, se, st0, *rest)
        err = max_abs_err(got, sweep_plain(tabs, se, st0, *rest))
        if err:
            raise AssertionError(f"sweep {self.n}: kernel != plain "
                                 f"(max_abs_err {err})")
        self.max_abs_err = max(self.max_abs_err, err)
        self.calls.append((tabs, se.clone(), st0.clone(), rest, got[0]))
        return got


def load_tests_module(name: str):
    """tests/<name>.py by file path: an installed package named "tests"
    would shadow ours."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_col(tabs, n: int):
    """Lane-layout tables in the (256, n) column layout."""
    return [a.view(n, 256).t().contiguous() for a in tabs]


def time_sweeps(calls, timing: bool) -> dict:
    """Every recorded sweep of a resolve again, in the lane layout and
    with its tables transposed to the col layout: the col kernel must
    equal the lane kernel; returns {layout: {ms, all_ms, plain_ms,
    paced_ms}} (sweep 1's times and the sum over the calls) plus each
    sweep's bound in "bounds"."""
    from supersampler_tpu_torch.ops.field import sweep_kernel, sweep_plain

    out = {"lane": {"each_ms": []}, "col": {"each_ms": []}, "bounds": []}
    for i, (tabs, se, st0, rest, xs) in enumerate(calls):
        n = se.shape[1]
        cols = to_col(tabs, n)
        rest_c = (*rest[:-1], "col")
        err = max_abs_err(sweep_kernel(cols, se, st0, *rest_c),
                          sweep_kernel(tabs, se, st0, *rest))
        if err:
            raise AssertionError(f"sweep {i}: col kernel != lane kernel "
                                 f"(max_abs_err {err})")
        out["bounds"].append(sweep_bound(se, st0, xs, rest[3]))
        if not timing:
            continue
        for lay, tb, rs in (("lane", tabs, rest), ("col", cols, rest_c)):
            r = out[lay]
            r["each_ms"].append(cuda_ms(
                lambda: sweep_kernel(tb, se, st0, *rs), 20))
            if i == 0:
                r["paced_ms"] = cuda_ms(
                    lambda: sweep_kernel(tb, se, st0, *rs), 20, paced=True)
                r["plain_ms"] = cuda_ms(
                    lambda: sweep_plain(tb, se, st0, *rs), 3)
    if timing:
        for r in (out["lane"], out["col"]):
            r["ms"], r["all_ms"] = r["each_ms"][0], sum(r["each_ms"])
    out["all_bound_ms"] = sum(b["bound_ms"] for b in out["bounds"])
    return out


def phase_sweep_edges(device, tile_lanes=16386) -> int:
    """Phase 2, sweep: the kernel against sweep_plain on the adversarial
    inputs of tests/sweep_cases.py and on one such case at the tile's
    width, in both layouts. Returns the largest error."""
    from supersampler_tpu_torch.ops.field import sweep_kernel, sweep_plain

    sc = load_tests_module("sweep_cases")
    cases = [(cid, sc.case(cid)) for cid, *_ in sc.CASES]
    cases.append((f"n{tile_lanes}_ties4_entry",
                  sc.sweep_case(1, tile_lanes, 16, True, 4)))
    worst = 0
    for cid, d in cases:
        n = d["se"].shape[1]
        tabs = [torch.from_numpy(a).to(device) for a in d["tabs"]]
        se = torch.from_numpy(d["se"]).to(device)
        st0 = torch.from_numpy(d["st0"]).to(device)
        rest = (*d["thr"], d["W"], d["capl"], d["force_entry"])
        for layout, tb in (("lane", tabs), ("col", to_col(tabs, n))):
            err = max_abs_err(sweep_kernel(tb, se, st0, *rest, layout),
                              sweep_plain(tb, se, st0, *rest, layout))
            if err:
                raise AssertionError(f"sweep kernel != plain on edge case "
                                     f"{cid} ({layout}): max_abs_err {err}")
            worst = max(worst, err)
    log(f"  sweep kernel == plain on {len(cases)} edge cases "
        f"({', '.join(c for c, _ in cases)}), lane and col layouts: "
        f"bit-equal (max_abs_err {worst})")
    return worst


def check_scan(packed, k, m, P_rec, last_i) -> int:
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel, scan_plain

    err = max_abs_err(scan_kernel(packed, k, m, P_rec, last_i),
                      scan_plain(packed, k, m, P_rec, last_i))
    if err:
        raise AssertionError(f"scan kernel != plain at (k, m) = ({k}, {m}),"
                             f" P_rec={P_rec}: max_abs_err {err}")
    return err


def check_scan2(packed, k, m, P_rec) -> int:
    from supersampler_tpu_torch.ops import fused as FU

    err = max_abs_err(FU.scan2_kernel(packed, k, m, P_rec),
                      FU.scan2_plain(packed, k, m, P_rec))
    if err:
        raise AssertionError(f"scan2 kernel != plain at (k, m) = ({k}, {m})"
                             f", P_rec={P_rec}: max_abs_err {err}")
    return err


def phase_scan_cases(device, v2=False) -> int:
    """Phase 2, scan (v2: the v2 scan): the kernel against its plain
    version on every kind of tests/scan_cases.py at its four (k, m),
    single record and batch. Returns the largest error."""
    sc = load_tests_module("scan_cases")
    worst = 0
    for kind in sc.KINDS:
        for k, m in sc.KM:
            for codes, P_rec, lengths in sc.flat_inputs(
                    sc.scan_case(kind, k, m)):
                packed = pack_codes(codes, device)
                if v2:
                    err = check_scan2(packed, k, m, P_rec)
                else:
                    li = torch.from_numpy(lengths - (k + 1)).to(device)
                    err = check_scan(packed, k, m, P_rec, li)
                worst = max(worst, err)
    log(f"  {'scan2' if v2 else 'scan'} kernel == plain on "
        f"tests/scan_cases.py's "
        f"{len(sc.KINDS)} kinds ({', '.join(sc.KINDS)}) at (k, m) = "
        f"{', '.join(map(str, sc.KM))}, single record and batch: "
        f"bit-equal (max_abs_err {worst})")
    return worst


def pack_codes(codes: np.ndarray, device):
    from supersampler_tpu_torch.ops.minimizer import pack_2bit

    return pack_2bit(torch.from_numpy(codes)).to(device)


def time_pair(kernel_fn, plain_fn, iters=(20, 3)):
    return cuda_ms(kernel_fn, iters[0]), cuda_ms(plain_fn, iters[1])


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the ALU rate."""
    tb, to = nbytes / HBM_BPS, ops / ALU_OPS
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations"}


def scan_bound(P: int, n_rec: int, v2: bool) -> dict:
    """Read the packed codes (and v1's bounds), write seven int32 tables,
    v1's sync bytes or v2's first-sync words, and the records' init;
    per position one hash, five window-minimum steps (a prefix, a suffix
    and three window joins) and one sync compare. Both scans compute the
    same tables, so they count the same operations. At (31, 11) both are
    bound by their bytes, so the count leaves their bounds as they were
    when the v2 scan's count grew with W."""
    out = 28 * P + (4 * (P // 256) if v2 else P) + 16 * n_rec
    nbytes = P // 4 + (0 if v2 else 4 * n_rec) + out
    return bound(nbytes, P * (OPS_HASH + OPS_FOLD * 5 + 3))


def sweep_bound(se, st0, xs, capl: int) -> dict:
    """Read the columns each active lane steps through (hash hi/lo) and
    one word per event, the lane vectors, and write the exit state and
    the lists; a step per column and per event."""
    start, end, active, j0, lastiv = se.to(torch.int64)
    stop = torch.minimum(end.clamp(max=256), lastiv - j0 + 1)
    cols = int(((stop - start.clamp(min=0)).clamp(min=0)
                * (active != 0)).sum())
    events = int((xs[5] - st0[5]).to(torch.int64).sum())
    n = se.shape[1]
    nbytes = 8 * cols + 4 * events + 4 * (11 + 7) * n + 12 * capl * n
    return bound(nbytes, OPS_STEP * (cols + events))


def walk_bound(got) -> dict:
    """Read one successor word per event and write three words per emit,
    the block counts and the scalars; a step per event."""
    _ei, _el, _es, cnt, scal = got
    events, emits = int(scal[0]), int(cnt.sum())
    return bound(4 * events + 12 * emits + 4 * cnt.numel() + 4 * 11,
                 OPS_STEP * events)


def phase_kernels(rng, device, tile_p=TILE_P, tile_l=TILE_L,
                  n_reads=1024, timing=True):
    """Phase 2. Returns {kernel: {max_abs_err, ms, plain_ms}} at the
    tile and at the read batch; max_abs_err is the largest error the
    comparisons measured."""
    from supersampler_tpu_torch.ops import field as F
    from supersampler_tpu_torch.ops.minimizer import pack_2bit
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel, scan_plain
    from supersampler_tpu_torch.sketch import TorchSubsampler

    thr = TorchSubsampler(k=K, m=M, s=S, device=device).threshold
    thr_w = (thr >> 32, thr & 0xFFFFFFFF)
    res = {"scan": {}}

    codes = torch.zeros(tile_p, dtype=torch.uint8)
    codes[:tile_l] = torch.from_numpy(
        rng.integers(0, 4, tile_l, dtype=np.uint8))
    packed = pack_2bit(codes).to(device)
    scan_err = 0
    for k, m in ((31, 11), (63, 15), (15, 5)):
        last_i = torch.tensor([tile_l - k - 1], dtype=torch.int32,
                              device=device)
        err = check_scan(packed, k, m, tile_p, last_i)
        scan_err = max(scan_err, err)
        log(f"  scan kernel == plain on the {tile_p}-position tile at "
            f"(k, m) = ({k}, {m}): bit-equal (max_abs_err {err})")
    last_i = torch.tensor([tile_l - K - 1], dtype=torch.int32,
                          device=device)
    res["scan"].update(scan_bound(tile_p, 1, False))
    if timing:
        res["scan"]["ms"], res["scan"]["plain_ms"] = time_pair(
            lambda: scan_kernel(packed, K, M, tile_p, last_i),
            lambda: scan_plain(packed, K, M, tile_p, last_i))

    # the same tile made of tandems and homopolymers: every window's
    # minimum repeats, so every election takes the tie path
    rep = np.zeros(tile_p, np.uint8)
    rep[:tile_l] = load_tests_module("scan_cases").tile_codes(
        int(rng.integers(1 << 31)), tile_l)
    rpacked = pack_codes(rep, device)
    for k, m in ((31, 11), (63, 15), (15, 5)):
        li = torch.tensor([tile_l - k - 1], dtype=torch.int32,
                          device=device)
        scan_err = max(scan_err, check_scan(rpacked, k, m, tile_p, li))
    log(f"  scan kernel == plain on the {tile_p}-position tile of tandems "
        f"and homopolymers at (k, m) = (31, 11), (63, 15), (15, 5): "
        f"bit-equal")
    if timing:
        res["scan"]["repeats_ms"] = cuda_ms(
            lambda: scan_kernel(rpacked, K, M, tile_p, last_i), 20)

    t = F.scan_field_2d_packed(packed, K, M, tile_p, tile_l)
    entry = F.field_entry_init(t, *thr_w)
    chk = SweepCheck()
    got = F.resolve_field(t, K, M, 4096, entry, *thr_w, sweep=chk)
    want = F.resolve_field(t, K, M, 4096, entry, *thr_w,
                           sweep=F.sweep_plain)
    if chk.n != 5 or not torch.equal(got, want):
        raise AssertionError("tile resolve differs between sweeps")
    log(f"  sweep kernel == plain on all {chk.n} sweeps of the tile's "
        f"resolve (status {int(got[0])}, n_sel {int(got[1])}): bit-equal "
        f"(max_abs_err {chk.max_abs_err})")

    # the reads batch: 1 kb records padded to 2,048 positions
    P_rec = 2048
    lens = rng.integers(900, 1001, n_reads).astype(np.int32)
    rc = np.zeros((n_reads, P_rec), np.uint8)
    for i, L in enumerate(lens):
        rc[i, :L] = rng.integers(0, 4, L, dtype=np.uint8)
    bpacked = pack_2bit(torch.from_numpy(rc.reshape(-1))).to(device)
    lengths = torch.from_numpy(lens).to(device)
    err = check_scan(bpacked, K, M, P_rec, lengths - (K + 1))
    res["scan"]["max_abs_err"] = max(scan_err, err)
    bt = F.scan_field_batched(bpacked.view(n_reads, -1), K, M, P_rec,
                              lengths)
    bchk = SweepCheck()
    got = F.resolve_field_batched(bt, K, M, 1 << 14, P_rec, *thr_w,
                                  sweep=bchk)
    want = F.resolve_field_batched(bt, K, M, 1 << 14, P_rec, *thr_w,
                                   sweep=F.sweep_plain)
    if bchk.n != 5 or not torch.equal(got, want):
        raise AssertionError("batch resolve differs between sweeps")
    sweep_err = max(chk.max_abs_err, bchk.max_abs_err)
    log(f"  scan and all {bchk.n} sweeps on the {n_reads} x 1 kb batch: "
        f"kernel == plain, bit-equal (status {int(got[0])}, "
        f"n_sel {int(got[1])}; max_abs_err scan {err}, sweep "
        f"{bchk.max_abs_err})")
    tile_sw = res["sweeps_tile"] = time_sweeps(chk.calls, timing)
    reads_sw = res["sweeps_reads"] = time_sweeps(bchk.calls, timing)
    log(f"  the {chk.n} tile sweeps and the {bchk.n} batch sweeps again "
        "with their tables in the col layout: col kernel == lane kernel")
    res["scan"]["batch_bound_ms"] = scan_bound(
        n_reads * P_rec, n_reads, False)["bound_ms"]
    if timing:
        li = lengths - (K + 1)
        res["scan"]["batch_ms"], res["scan"]["batch_plain_ms"] = time_pair(
            lambda: scan_kernel(bpacked, K, M, P_rec, li),
            lambda: scan_plain(bpacked, K, M, P_rec, li))
    # the kernel entries: sweep 1 of the tile resolve, in each layout,
    # with the sums over its five sweeps
    for name, lay in (("sweep", "lane"), ("sweep_col", "col")):
        res[name] = {"max_abs_err": sweep_err, **tile_sw["bounds"][0],
                     "all_sweeps_bound_ms": tile_sw["all_bound_ms"]}
        if timing:
            res[name].update(
                ms=tile_sw[lay]["ms"], plain_ms=tile_sw[lay]["plain_ms"],
                all_sweeps_ms=tile_sw[lay]["all_ms"],
                batch_ms=reads_sw[lay]["ms"],
                batch_all_sweeps_ms=reads_sw[lay]["all_ms"])
    return res


def check_walk(words, init5, what: str) -> tuple:
    """The walk kernel against walk_plain; returns the kernel's result."""
    from supersampler_tpu_torch.ops import walker as TW

    got = TW.walk_kernel(words, init5)
    err = max_abs_err(got, TW.walk_plain(words, init5))
    if err:
        raise AssertionError(f"walk kernel != plain on {what}: max_abs_err "
                             f"{err}")
    return got


def phase_walk_cases(device) -> None:
    """Phase 2, walk: the kernel against walk_plain on every kind of
    tests/walk_cases.py at each of its block counts."""
    from supersampler_tpu_torch.ops import walker as TW
    from supersampler_tpu_torch.ops.minimizer import scan_tables_2d_packed
    from supersampler_tpu_torch.sketch import TorchSubsampler

    def scan_words(codes, s, n_pad):
        thr = TorchSubsampler(k=K, m=M, s=s, device=device).threshold
        t = scan_tables_2d_packed(pack_codes(codes, device), K, M,
                                  codes.size, codes.size + 1000, thr >> 32,
                                  thr & 0xFFFFFFFF)
        return (TW.pack_succ(t, n_pad).cpu().numpy(),
                TW._init5_from_tables(t).cpu().numpy())

    wc = load_tests_module("walk_cases")
    for kind in wc.KINDS:
        for nb in wc.N_BLOCKS:
            words, init5 = wc.walk_case(kind, nb, scan_words=scan_words)
            check_walk(torch.from_numpy(words).to(device),
                       torch.from_numpy(init5).to(device),
                       f"walk case {kind} at {nb} blocks")
    log(f"  walk kernel == plain on tests/walk_cases.py's {len(wc.KINDS)} "
        f"kinds ({', '.join(wc.KINDS)}) at {wc.N_BLOCKS} blocks: bit-equal "
        f"(max_abs_err 0)")


def phase_walk(rng, device, tile_p=TILE_P, timing=True):
    """Phase 2, walk: the kernel against walk_plain over the successor
    words of a full tile and of the next tile (entered from the first's
    carry), at s = 1000 and s = 1, on tests/walk_cases.py, and as the
    1-block walk of a 1 kb record. Returns {max_abs_err, ms, plain_ms,
    ms_s1, plain_ms_s1, one_block_ms, one_block_plain_ms, succ_ms}
    (times at the first tile)."""
    from supersampler_tpu_torch.ops import walker as TW
    from supersampler_tpu_torch.ops.minimizer import (pack_2bit,
                                                      scan_tables_2d_packed,
                                                      succ_tables)
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel
    from supersampler_tpu_torch.sketch import TorchSubsampler

    own = tile_p - 512
    length = 2 * own + 100_000          # both tiles are non-final
    codes = torch.from_numpy(rng.integers(0, 4, own + tile_p,
                                          dtype=np.uint8))
    res = {"max_abs_err": 0}
    for s, key in ((S, ""), (1.0, "_s1")):
        thr = TorchSubsampler(k=K, m=M, s=s, device=device).threshold
        thr_w = (thr >> 32, thr & 0xFFFFFFFF)
        init5 = fb = None
        for t in range(2):
            L_t = length - t * own
            packed = pack_2bit(codes[t * own : t * own + tile_p]).to(device)
            last_i = torch.tensor([L_t - K - 1], dtype=torch.int32,
                                  device=device)
            *tabs, _sync, init = scan_kernel(packed, K, M, tile_p, last_i)
            tab = succ_tables(tabs, init[:, 0], K, M, L_t, *thr_w)
            words = TW.pack_succ(tab, own)
            if init5 is None:
                init5 = TW._init5_from_tables(tab)
                fb = TW._fb_from_tables(tab)
            got = check_walk(words, init5, f"tile {t} at s={s:g}")
            log(f"  walk kernel == plain at s={s:g}, tile {t} "
                f"({'entered from the carry' if t else 'window-0 entry'}): "
                f"{int(got[4][0])} events, {int(got[3].sum())} emits, "
                f"bit-equal (max_abs_err 0)")
            if t == 0 and not key:
                res.update(walk_bound(got))
            if t == 0 and timing:
                res["ms" + key], res["plain_ms" + key] = time_pair(
                    lambda: TW.walk_kernel(words, init5),
                    lambda: TW.walk_plain(words, init5), (20, 1))
                if not key:
                    res["succ_ms"] = cuda_ms(
                        lambda: succ_tables(tabs, init[:, 0], K, M, L_t,
                                            *thr_w), 5)
            init5, fb = TW._carry_next(got[4], tab, fb, own)
    phase_walk_cases(device)
    # the 1-block walk: a 1 kb record padded to 2,048 positions, as the
    # batch route's per-record fallback walks it
    read = np.zeros(2048, np.uint8)
    read[:1000] = rng.integers(0, 4, 1000, dtype=np.uint8)
    thr = TorchSubsampler(k=K, m=M, s=S, device=device).threshold
    t1 = scan_tables_2d_packed(pack_codes(read, device), K, M, 2048, 1000,
                               thr >> 32, thr & 0xFFFFFFFF)
    words, init5 = TW.pack_succ(t1, 2048), TW._init5_from_tables(t1)
    got = check_walk(words, init5, "the 1-block walk")
    log(f"  walk kernel == plain on the 1-block walk of a 1 kb record: "
        f"{int(got[4][0])} events, bit-equal (max_abs_err 0)")
    if timing:
        res["one_block_ms"], res["one_block_plain_ms"] = time_pair(
            lambda: TW.walk_kernel(words, init5),
            lambda: TW.walk_plain(words, init5))
    return res


def phase_fused(rng, device, tile_p=TILE_P, tile_l=TILE_L, n_reads=1024,
                timing=True):
    """Phase 2, v2: the v2 scan against scan2_plain at the tile and at
    the tile of tandems and homopolymers (three (k, m) each, both timed)
    and on the read batch; every "col" sweep of fused_single /
    fused_batch against sweep_plain; the v2 fetch arrays against v1's at
    the tile, on the tile with a 3 kb homopolymer (passes 2..4 run), at
    s = 1 and on the batch. Returns {"scan2": {max_abs_err, bound, times},
    "sweep_col_v2": {max_abs_err}} (phase_kernels times the col sweep)."""
    from supersampler_tpu_torch.ops import field as F
    from supersampler_tpu_torch.ops import fused as FU
    from supersampler_tpu_torch.ops.minimizer import pack_2bit
    from supersampler_tpu_torch.sketch import TorchSubsampler

    res = {"scan2": {"max_abs_err": 0}, "sweep_col_v2": {"max_abs_err": 0}}

    def check(packed, k, m, P_rec, what):
        err = check_scan2(packed, k, m, P_rec)
        log(f"  scan2 kernel == plain on {what} at (k, m) = ({k}, {m}): "
            f"bit-equal (max_abs_err {err})")

    def resolve_both(name, v2, v1):
        """v2 with its sweeps checked against sweep_plain == v1."""
        chk = SweepCheck()
        got = v2(chk)
        want = v1()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: v2 fetch array != v1's")
        res["sweep_col_v2"]["max_abs_err"] = max(
            res["sweep_col_v2"]["max_abs_err"], chk.max_abs_err)
        log(f"  {name}: v2 fetch array == v1's (status {int(got[0])}, "
            f"n_sel {int(got[1])}); all {chk.n} col sweeps kernel == "
            f"plain (max_abs_err {chk.max_abs_err})")
        return chk

    codes = torch.zeros(tile_p, dtype=torch.uint8)
    codes[:tile_l] = torch.from_numpy(
        rng.integers(0, 4, tile_l, dtype=np.uint8))
    packed = pack_2bit(codes).to(device)
    rep = np.zeros(tile_p, np.uint8)
    rep[:tile_l] = load_tests_module("scan_cases").tile_codes(
        int(rng.integers(1 << 31)), tile_l)
    rpacked = pack_codes(rep, device)
    for k, m in ((31, 11), (63, 15), (15, 5)):
        check(packed, k, m, tile_p, f"the {tile_p}-position tile")
        check(rpacked, k, m, tile_p, f"the {tile_p}-position tile of "
              "tandems and homopolymers")
    res["scan2"].update(scan_bound(tile_p, 1, True))
    if timing:
        res["scan2"]["ms"], res["scan2"]["plain_ms"] = time_pair(
            lambda: FU.scan2_kernel(packed, K, M, tile_p),
            lambda: FU.scan2_plain(packed, K, M, tile_p))
        res["scan2"]["repeats_ms"] = cuda_ms(
            lambda: FU.scan2_kernel(rpacked, K, M, tile_p), 20)

    halo = torch.zeros(32, dtype=torch.uint8, device=device)
    for s, cap, what, mut in (
            (S, 4096, "tile", None),
            (S, 4096, "tile with a 3 kb homopolymer",
             (tile_l // 4, tile_l // 4 + 3000)),
            (1.0, 1 << 20, "tile at s = 1", None)):
        thr = TorchSubsampler(k=K, m=M, s=s, device=device).threshold
        thr_w = (thr >> 32, thr & 0xFFFFFFFF)
        c = codes.clone()
        if mut:
            c[mut[0] : mut[1]] = 0
        pk = pack_2bit(c).to(device)
        slab = torch.cat([halo, pk])

        def v1():
            t = F.scan_field_2d_packed(pk, K, M, tile_p, tile_l)
            return F.resolve_field(t, K, M, cap, F.field_entry_init(t, *thr_w),
                                   *thr_w)

        chk = resolve_both(what, lambda sw: FU.fused_single(
            slab, K, M, tile_p, cap, tile_l, *thr_w, sweep=sw), v1)
        if mut and chk.n != 5:
            raise AssertionError(f"{what}: passes 2..4 did not run "
                                 f"({chk.n} sweeps)")

    thr = TorchSubsampler(k=K, m=M, s=S, device=device).threshold
    thr_w = (thr >> 32, thr & 0xFFFFFFFF)
    P_rec = 2048
    lens = rng.integers(900, 1001, n_reads).astype(np.int32)
    rc = np.zeros((n_reads, P_rec), np.uint8)
    for i, L in enumerate(lens):
        rc[i, :L] = rng.integers(0, 4, L, dtype=np.uint8)
    bpacked = pack_2bit(torch.from_numpy(rc.reshape(-1))).to(device)
    lengths = torch.from_numpy(lens).to(device)
    for k, m in ((31, 11), (63, 15), (15, 5)):
        check(bpacked, k, m, P_rec, f"the {n_reads} x 1 kb batch")
    bpk = bpacked.view(n_reads, -1)
    resolve_both(f"{n_reads} x 1 kb batch", lambda sw: FU.fused_batch(
        bpk, K, M, P_rec, 1 << 14, lengths, *thr_w, sweep=sw),
        lambda: F.resolve_field_batched(F.scan_field_batched(
            bpk, K, M, P_rec, lengths), K, M, 1 << 14, P_rec, *thr_w))
    res["scan2"]["batch_bound_ms"] = scan_bound(
        n_reads * P_rec, n_reads, True)["bound_ms"]
    if timing:
        res["scan2"]["batch_ms"], res["scan2"]["batch_plain_ms"] = time_pair(
            lambda: FU.scan2_kernel(bpacked, K, M, P_rec),
            lambda: FU.scan2_plain(bpacked, K, M, P_rec))
    return res


@contextmanager
def env_vars(**values):
    """The environment variables ``values`` set inside the block."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def fused_env():
    """SPSP_FUSED=1 (the v2 path) inside the block."""
    return env_vars(SPSP_FUSED="1")


def phase_goldens(device, workdir, engine="field", v2=False) -> None:
    """Phase 3: the golden sketches, and for the field engine the CLI,
    sketched on device; v2: under SPSP_FUSED=1, which must launch the
    v2 scan."""
    from supersampler_tpu_torch.cli import sub_sampler as cli
    from supersampler_tpu_torch.sketch import TorchSubsampler

    make_data = load_tests_module("make_data")
    gold = os.path.join(ROOT, "tests", "golden")
    data = make_data.make_all(os.path.join(workdir, "data"))
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    label = f"{engine} engine{', v2' if v2 else ''}"
    reset_launches()
    for cfg in meta["sketches"]:
        with gzip.open(os.path.join(gold, cfg["file"]), "rb") as f:
            want = f.read()
        ss = TorchSubsampler(k=cfg["k"], m=cfg["m"],
                             s=float(np.float32(cfg["s"])),
                             abundance=cfg["a"], device=device)
        ss.scan_engine = engine
        if ss.sketch_file(data[cfg["dataset"]]) != want:
            raise AssertionError(f"golden {cfg['file']} differs ({label})")
    counts = read_launches()
    log(f"  all {len(meta['sketches'])} golden sketches equal ({label}); "
        f"launches {counts}")
    if v2 and counts["scan2"] <= 0:
        raise AssertionError("the v2 scan never launched under SPSP_FUSED=1")
    if engine != "field":
        return
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(["-i", data["simple"], "-s", "10", "-p", "cli_"])
        with open("cli_simple.gz", "rb") as f:
            mine = f.read()
    finally:
        os.chdir(cwd)
    with open(os.path.join(gold, "cli_simple.gz"), "rb") as f:
        want_gz = f.read()
    with open(os.path.join(gold, "cli_sub_sampler_stdout.txt")) as f:
        want_out = f.read()
    if rc != 0 or mine != want_gz or buf.getvalue() != want_out:
        raise AssertionError("CLI output differs from cli_simple.gz / "
                             "cli_sub_sampler_stdout.txt")
    log(f"  CLI -i simple -s 10: cli_simple.gz bytes and stdout equal "
        f"({label})")

    # -f: the four family genomes through the CLI's fof route
    fof = os.path.join(workdir, "fam_fof.txt")
    with open(fof, "w") as f:
        f.writelines(data[f"fam{i}"] + "\n" for i in range(4))
    reset_launches()
    os.chdir(workdir)
    try:
        with redirect_stdout(io.StringIO()):
            rc = cli.main(["-f", fof, "-s", "15", "-t", "4", "-p", "g_"])
    finally:
        os.chdir(cwd)
    counts = read_launches()
    for i in range(4):
        with open(os.path.join(workdir, f"g_fam{i}.gz"), "rb") as f:
            mine = f.read()
        with open(os.path.join(gold, f"gfam_fam{i}.gz"), "rb") as f:
            if rc != 0 or mine != f.read():
                raise AssertionError(f"CLI -f: g_fam{i}.gz differs from "
                                     f"gfam_fam{i}.gz ({label})")
    if counts["scan2" if v2 else "scan"] <= 0:
        raise AssertionError(f"CLI -f: the scan never launched: {counts}")
    log(f"  CLI -f (4 family genomes) -s 15: gfam_fam0-3.gz bytes equal "
        f"({label}); launches {counts}")


def write_fasta(path, codes_rows, prefix, width=None) -> int:
    """One record per row of uint8 codes; returns total bases."""
    n = 0
    with open(path, "wb") as f:
        for i, row in enumerate(codes_rows):
            seq = _ACGT[row].tobytes()
            f.write(b">%s%d\n" % (prefix, i))
            if width:
                for j in range(0, len(seq), width):
                    f.write(seq[j : j + width] + b"\n")
            else:
                f.write(seq + b"\n")
            n += len(seq)
    return n


def phase_cpu_parity(rng, device, workdir, glen=5_000_000, n_reads=2000):
    """Phase 4a: the card's sketch bytes equal the CPU's."""
    from supersampler_tpu_torch.sketch import TorchSubsampler

    genome = os.path.join(workdir, "g5.fa")
    reads = os.path.join(workdir, "r2k.fa")
    write_fasta(genome, [rng.integers(0, 4, glen, dtype=np.uint8)], b"g",
                width=80)
    write_fasta(reads, rng.integers(0, 4, (n_reads, 1000), dtype=np.uint8),
                b"r")
    for path, what in ((genome, f"{glen} bp genome"),
                       (reads, f"{n_reads} x 1 kb reads")):
        out = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            out[dev] = TorchSubsampler(k=K, m=M, s=S,
                                       device=dev).sketch_file(path)
            out[dev + "_s"] = time.perf_counter() - t0
        if out[device] != out["cpu"]:
            raise AssertionError(f"{what}: {device} bytes != cpu bytes")
        log(f"  {what}: {device} bytes == cpu bytes "
            f"({len(out['cpu'])} B; {device} {out[device + '_s']:.3f} s, "
            f"cpu {out['cpu_s']:.3f} s)")


def _wrappers() -> dict:
    from supersampler_tpu_torch.ops.field import sweep_kernel
    from supersampler_tpu_torch.ops.fused import scan2_kernel
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel
    from supersampler_tpu_torch.ops.walker import walk_kernel
    from supersampler_tpu_torch.parallel.compare_dist import presence_product

    return {"scan": scan_kernel, "scan2": scan2_kernel,
            "sweep": sweep_kernel, "walk": walk_kernel,
            "int_mm": presence_product}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def desert_corpus(rng, workdir, long_len=12_000_000, single_len=100_000,
                  n_reads=2000, n_deserts=20):
    """The desert corpus as a FASTA in workdir: n_reads 1 kb reads with
    n_deserts records of 500 random + 3,000 T + 500 random among them, a
    single_len record with a 3 kb poly-A and a long_len record with a
    3 kb poly-T inside tile 1. Returns (path, bases)."""
    own = TILE_P - 512
    A, T = 0, 3                          # codes of _ACGT
    desert = np.full(3000, T, np.uint8)
    recs = []
    for i in range(n_reads):
        if i % (n_reads // n_deserts) == 0:
            recs.append(np.concatenate([
                rng.integers(0, 4, 500, dtype=np.uint8), desert,
                rng.integers(0, 4, 500, dtype=np.uint8)]))
        recs.append(rng.integers(0, 4, 1000, dtype=np.uint8))
    single = rng.integers(0, 4, single_len, dtype=np.uint8)
    single[single_len // 2 : single_len // 2 + 3000] = A
    long_rec = rng.integers(0, 4, long_len, dtype=np.uint8)
    at = own + (long_len - own) // 2      # inside tile 1
    long_rec[at : at + 3000] = T
    path = os.path.join(workdir, "desert.fa")
    return path, write_fasta(path, recs + [single, long_rec], b"d", width=80)


def phase_desert(rng, device, workdir, **sizes) -> None:
    """Phase 4: records the field resolve cannot settle, on all three
    routes. The field engine on the card must fall back on each route
    and give the bytes of the CPU and of the legacy engine on the card.
    sizes: desert_corpus's."""
    from supersampler_tpu_torch.sketch import TorchSubsampler

    path, bases = desert_corpus(rng, workdir, **sizes)
    out, walls = {}, {}
    for name, dev, engine in (("card", device, "field"),
                              ("cpu", "cpu", "field"),
                              ("card legacy", device, "legacy")):
        ss = TorchSubsampler(k=K, m=M, s=S, device=dev)
        ss.scan_engine = engine
        reset_launches()
        t0 = time.perf_counter()
        out[name] = ss.sketch_file(path)
        walls[name] = time.perf_counter() - t0
        counts = read_launches()
        log(f"  desert corpus ({bases} bases), {name}: "
            f"{walls[name]:.3f} s, fallbacks {ss.fallbacks}, launches "
            f"{counts}")
        if name == "card":
            if min(ss.fallbacks.values()) < 1 or counts["walk"] < 1:
                raise AssertionError("a route did not fall back to the "
                                     f"walker: {ss.fallbacks}, {counts}")
    ss = TorchSubsampler(k=K, m=M, s=S, device=device)
    reset_launches()
    t0 = time.perf_counter()
    with fused_env():
        out["card v2"] = ss.sketch_file(path)
    walls["card v2"] = time.perf_counter() - t0
    counts = read_launches()
    log(f"  desert corpus ({bases} bases), card v2: {walls['card v2']:.3f} "
        f"s, fallbacks {ss.fallbacks}, launches {counts}")
    if (min(ss.fallbacks.values()) < 1 or counts["walk"] < 1
            or counts["scan2"] < 1):
        raise AssertionError("a route did not fall back to the walker on "
                             f"v2: {ss.fallbacks}, {counts}")
    if not (out["card"] == out["cpu"] == out["card legacy"]
            == out["card v2"]):
        raise AssertionError("desert corpus: card, cpu, legacy and v2 "
                             "bytes differ")
    log(f"  desert corpus: card == cpu == card legacy == card v2 bytes "
        f"({len(out['cpu'])} B)")


def check_sketch(raw: bytes, empty_ok: bool = False) -> None:
    """A sketch starts '<2k-m> <m> <selected k-mers> <s>' and has
    buckets after it (empty_ok: a short input may select none)."""
    head, _, body = raw.partition(b"\n")
    f = head.split()
    if (len(f) != 4 or int(f[0]) != 2 * K - M or int(f[1]) != M
            or (not empty_ok and (int(f[2]) <= 0 or not body))):
        raise AssertionError(f"malformed sketch header {head[:80]!r}")


def bench_cli(workdir, cells, prefix: str, label: str):
    """The bench cells through the CLI on the card, the launch counters
    reset just before and read just after each cell. Returns (counts
    summed over the cells, {path: (wall, sha256)})."""
    from supersampler_tpu_torch.cli import sub_sampler as cli

    cwd = os.getcwd()
    os.chdir(workdir)
    walls, per_cell = {}, {}
    try:
        for path, bases in cells:
            reset_launches()
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                rc = cli.main(["-i", path, "-k", str(K), "-m", str(M),
                               "-s", "1000", "-p", prefix])
            walls[path] = (time.perf_counter() - t0, rc)
            per_cell[path] = read_launches()
    finally:
        os.chdir(cwd)
    counts = {name: sum(c[name] for c in per_cell.values())
              for name in read_launches()}
    gpu = gpu_line()
    out = {}
    for path, bases in cells:
        wall, rc = walls[path]
        gz_path = os.path.join(workdir, prefix + os.path.basename(path)
                               .rsplit(".", 1)[0] + ".gz")
        with open(gz_path, "rb") as f:
            gz = f.read()
        if rc != 0:
            raise AssertionError(f"CLI rc {rc} on {path} ({label})")
        check_sketch(gzip.decompress(gz))
        out[path] = (wall, hashlib.sha256(gz).hexdigest())
        log(f"  {os.path.basename(path)} ({label}): {bases} bases, wall "
            f"{wall:.3f} s, {bases / 1e6 / wall:.1f} Mbases/s, sketch "
            f"sha256 {out[path][1]}, launches {per_cell[path]} [{gpu}]")
    log(f"  launches in this run ({label}): {counts} [{gpu}]")
    return counts, out


def phase_bench(rng, workdir, n_rec=8, glen=TILE_L, n_reads=10_000):
    """Phase 4b: the bench corpus through the CLI on the card, in the
    order v1, v2, v2, v1 (every sha256 must agree). Returns (v1 counts,
    v2 counts, genome path, its bases, its sketch sha256); the counts
    are those of each path's first run."""
    genome = os.path.join(workdir, "bench_genome.fa")
    reads = os.path.join(workdir, "bench_reads.fa")
    g_bases = write_fasta(
        genome, rng.integers(0, 4, (n_rec, glen), dtype=np.uint8), b"chr")
    r_bases = write_fasta(
        reads, rng.integers(0, 4, (n_reads, 1000), dtype=np.uint8), b"q")
    cells = ((genome, g_bases), (reads, r_bases))
    counts, walls, shas = {}, {"v1": [], "v2": []}, set()
    for i, path_name in enumerate(("v1", "v2", "v2", "v1")):
        if path_name == "v2":
            with fused_env():
                c, out = bench_cli(workdir, cells, f"v2_{i}_", "v2")
        else:
            c, out = bench_cli(workdir, cells, f"v1_{i}_", "v1")
        counts.setdefault(path_name, c)
        walls[path_name].append(out)
        shas.update((p, h) for p, (_w, h) in out.items())
    c1, c2 = counts["v1"], counts["v2"]
    if min(c1["scan"], c1["sweep"]) <= 0 or c1["scan2"]:
        raise AssertionError(f"v1 run: a kernel of the path never launched"
                             f" or the v2 scan did: {c1}")
    if min(c2["scan2"], c2["sweep"]) <= 0 or c2["scan"]:
        raise AssertionError(f"v2 run: a kernel of the path never launched"
                             f" or the v1 scan did: {c2}")
    if len(shas) != len(cells):
        raise AssertionError(f"bench sketches differ between runs: {shas}")
    for path, bases in cells:
        line = "; ".join(
            f"{p} " + ", ".join(f"{o[path][0]:.3f} s "
                                f"({bases / 1e6 / o[path][0]:.1f} Mbases/s)"
                                for o in walls[p])
            for p in ("v1", "v2"))
        log(f"  {os.path.basename(path)}: {line} [{gpu_line()}]")
    log("  bench corpus: every v1 and v2 sketch hashes the same")
    return c1, c2, genome, g_bases, walls["v1"][0][genome][1]


def phase_bench_legacy(device, workdir, genome, bases, want_sha) -> dict:
    """Phase 4: the bench genome through the legacy engine on the card,
    launch counters reset before and read after; its sketch must hash
    as the field engine's. Returns the launch counts."""
    from supersampler_tpu_torch.sketch import TorchSubsampler, subsample_file

    cwd = os.getcwd()
    os.chdir(workdir)
    reset_launches()
    try:
        t0 = time.perf_counter()
        ss = TorchSubsampler(k=K, m=M, s=S, device=device)
        ss.scan_engine = "legacy"
        out = subsample_file(ss, genome, "legacy_")
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = read_launches()
    with open(os.path.join(workdir, out), "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    log(f"  {os.path.basename(genome)} through the legacy engine: {bases} "
        f"bases, wall {wall:.3f} s, {bases / 1e6 / wall:.1f} Mbases/s, "
        f"sketch sha256 {sha}, launches {counts} [{gpu_line()}]")
    if sha != want_sha:
        raise AssertionError("legacy engine sketch differs from the field "
                             "engine's")
    if counts["walk"] <= 0 or counts["scan"] <= 0:
        raise AssertionError(f"a kernel of the legacy path never launched:"
                             f" {counts}")
    return counts


def _run_cli(cli, argv, workdir) -> str:
    """One in-process CLI call from workdir; returns its stdout."""
    from contextlib import chdir

    buf = io.StringIO()
    with chdir(workdir), redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"{cli.__name__} {argv}: rc {rc}")
    return buf.getvalue()


def _same_bytes(a: str, b: str, what: str) -> None:
    with open(a, "rb") as f, open(b, "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{what}: {a} differs from {b}")


def phase_compare_goldens(device, workdir) -> None:
    """Phase 5a: the comparator CLI on the family goldens, all-vs-all
    and query mode, both engines, in RAM and chunked: CSVs byte-equal
    to tests/golden/allvsall_* and query_*."""
    from supersampler_tpu_torch.cli import comparator as cli

    gold = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(gold, "meta.json")) as f:
        cfg = json.load(f)["compare"]
    d = os.path.join(workdir, "cmp_gold")
    os.makedirs(d)
    for name in cfg["files"]:
        os.symlink(os.path.join(gold, name), os.path.join(d, name))
    for fof, names in (("fof.txt", cfg["files"]),
                       ("qfof.txt", cfg["query_files"]),
                       ("bfof.txt", cfg["bank_files"])):
        with open(os.path.join(d, fof), "w") as f:
            f.write("\n".join(names) + "\n")
    modes = (("allvsall", ["-f", "fof.txt"]),
             ("query", ["-f", "bfof.txt", "-q", "qfof.txt", "-p",
                        str(cfg["query_precision"]), "-m",
                        str(cfg["query_min_threshold"])]))
    for engine in ("device", "numpy"):
        reset_launches()
        t0 = time.perf_counter()
        with env_vars(SPSP_COMPARE_ENGINE=engine, TORCH_DEVICE=str(device)):
            for mode, argv in modes:
                for chunk in ([], ["--chunk-bytes", "16384"]):
                    _run_cli(cli, argv + chunk + ["-o", "r"], d)
                    for kind in ("containment", "jaccard"):
                        _same_bytes(os.path.join(d, f"r_{kind}.csv.gz"),
                                    os.path.join(gold,
                                                 f"{mode}_{kind}.csv.gz"),
                                    f"{engine} engine, {mode} {chunk}")
        wall = time.perf_counter() - t0
        counts = read_launches()
        if (counts["int_mm"] > 0) != (engine == "device"):
            raise AssertionError(f"{engine} engine: int_mm launches "
                                 f"{counts['int_mm']}")
        log(f"  comparator CLI, {engine} engine: allvsall_* and query_* "
            f"bytes equal, in RAM and at --chunk-bytes 16384 (4 runs "
            f"{wall:.3f} s); launches {counts} [{gpu_line()}]")


def family_corpus(rng, workdir, n_fam=8, per_fam=8, glen=2_000_000):
    """n_fam random base genomes of glen bp, each with per_fam members
    carrying 0.5-5 % point substitutions, one FASTA a member. Returns
    the paths, family by family."""
    paths = []
    for fam in range(n_fam):
        base = rng.integers(0, 4, glen, dtype=np.uint8)
        for j in range(per_fam):
            codes = base.copy()
            hit = rng.random(glen) < rng.uniform(0.005, 0.05)
            codes[hit] = (codes[hit] + rng.integers(
                1, 4, int(hit.sum()), dtype=np.uint8)) % 4
            paths.append(os.path.join(workdir, f"fam{fam}_{j}.fa"))
            write_fasta(paths[-1], [codes], b"g")
    return paths


def phase_compare_real(rng, device, workdir, timing=True,
                       **sizes) -> dict:
    """Phase 5b: 64 genomes of 2 Mbp (8 families of 8) sketched by the
    sub_sampler CLI (-f) at k=31, m=11, s=100, then compared all-vs-all
    on both engines, 8-vs-64 in query mode on both, chunked (device
    engine, 1 MiB chunks) and through score_matrix_device at 4,096
    groups a step; every score_A, nb_kmer_seen_infile and CSV must
    agree. Then sort_csv and kmer_dump on this corpus. The launch
    counters are reset before and read after. Returns the counts and
    what phase 6 reuses: the directory, the FASTAs and sketches, the
    numpy engine's comparator, the grouped pairs and the single-device
    score matrix."""
    from supersampler_tpu_torch.cli import comparator as ccli
    from supersampler_tpu_torch.cli import kmer_dump as kcli
    from supersampler_tpu_torch.cli import sort_csv as scli
    from supersampler_tpu_torch.cli import sub_sampler as scli_sketch
    from supersampler_tpu_torch.compare.merge import (TorchComparator,
                                                      pair_scores_numpy)
    from supersampler_tpu_torch.parallel import compare_dist as CD
    from supersampler_tpu_torch.parallel.mesh import make_mesh

    d = os.path.join(workdir, "cmp_real")
    os.makedirs(d)
    fastas = family_corpus(rng, d, **sizes)
    with open(os.path.join(d, "genomes.txt"), "w") as f:
        f.writelines(p + "\n" for p in fastas)
    gpu = gpu_line()
    reset_launches()
    t0 = time.perf_counter()
    with env_vars(TORCH_DEVICE=str(device)):
        _run_cli(scli_sketch, ["-f", "genomes.txt", "-k", "31", "-m", "11",
                               "-s", "100", "-p", "sk_"], d)
    t_sketch = time.perf_counter() - t0
    files = [os.path.join(d, "sk_" + os.path.basename(p)[:-3] + ".gz")
             for p in fastas]
    with open(os.path.join(d, "sketches.txt"), "w") as f:
        f.writelines(p + "\n" for p in files)
    queries = files[:: len(files) // 8]
    with open(os.path.join(d, "queries.txt"), "w") as f:
        f.writelines(p + "\n" for p in queries)

    def compare(engine, query, chunk_bytes=None):
        c = TorchComparator(engine=engine,
                            device=device if engine == "device" else None,
                            **({"precision": 3} if query else {}))
        c.files_names = (queries if query else []) + files
        qs = len(queries) if query else len(files)
        t = time.perf_counter()
        if chunk_bytes:
            c.compare_sketches_chunked(qs, chunk_bytes=chunk_bytes)
        else:
            c.compare_sketches(qs)
        return c, time.perf_counter() - t

    def same(a, b, what):
        if (a.score_A != b.score_A
                or a.nb_kmer_seen_infile != b.nb_kmer_seen_infile
                or a.containment_csv() != b.containment_csv()
                or a.jaccard_csv() != b.jaccard_csv()):
            raise AssertionError(f"{what}: results differ")

    walls = {}
    res = {}
    for engine in ("device", "numpy"):
        for query in (False, True):
            res[engine, query], walls[engine, query] = compare(engine, query)
    same(res["device", False], res["numpy", False], "all-vs-all engines")
    same(res["device", True], res["numpy", True], "query-mode engines")
    ref = res["numpy", False]
    chunked, walls["chunked"] = compare("device", False, 1 << 20)
    same(chunked, ref, "chunked (1 MiB) against in RAM")
    # the in-RAM comparison's layers, each timed on the host's clock:
    # decode, grouping (the native pass), then either engine's scoring
    t = time.perf_counter()
    mins, his, los, fids, nb_seen, _k, _m, _q = CD.decode_files(files)
    walls["decode"] = time.perf_counter() - t
    t = time.perf_counter()
    gids, fids = CD.group_pairs(mins, his, los, fids)
    walls["group"] = time.perf_counter() - t
    n_groups = int(gids[-1]) + 1
    t = time.perf_counter()
    enumerated = pair_scores_numpy(gids, fids, len(files))
    walls["enumerate"] = time.perf_counter() - t
    if enumerated != ref.score_A:
        raise AssertionError("the numpy engine's enumeration differs")
    t = time.perf_counter()
    one = make_mesh([device])
    score = CD.score_matrix_device(gids, fids, n_groups, len(files), one,
                                   chunk_groups=4096)
    walls["steps"] = time.perf_counter() - t
    t = time.perf_counter()
    score_default = CD.score_matrix_device(gids, fids, n_groups,
                                           len(files), one)
    walls["steps_default"] = time.perf_counter() - t
    if not np.array_equal(score, score_default):
        raise AssertionError("score_matrix_device depends on its steps")
    if (CD.scores_to_dict(score, len(files)) != ref.score_A
            or list(np.diag(score)) != ref.nb_kmer_seen_infile
            or nb_seen != ref.nb_kmer_seen_infile):
        raise AssertionError("score_matrix_device at 4,096 groups a step "
                             "differs")
    with env_vars(SPSP_COMPARE_ENGINE="device", TORCH_DEVICE=str(device)):
        t = time.perf_counter()
        _run_cli(ccli, ["-f", "sketches.txt", "-o", "cli"], d)
        walls["cli"] = time.perf_counter() - t
    ref.write_outputs(os.path.join(d, "numpy"))
    for kind in ("containment", "jaccard"):
        _same_bytes(os.path.join(d, f"cli_{kind}.csv.gz"),
                    os.path.join(d, f"numpy_{kind}.csv.gz"),
                    "comparator CLI (device) against the numpy engine")
    counts = read_launches()
    if counts["int_mm"] <= 0 or counts["scan"] <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{counts}")
    steps = -(-n_groups // 4096)
    n, nq = len(files), len(queries)
    log(f"  {n} x {sizes.get('glen', 2_000_000)} bp genomes sketched "
        f"(-f, s=100) in {t_sketch:.3f} s; {sum(nb_seen)} pairs, "
        f"{n_groups} groups; every engine agrees (all-vs-all and "
        f"{nq}-vs-{n}: device == numpy; chunked at 1 MiB; {steps} steps "
        f"of 4,096 groups; CLI bytes); launches {counts} [{gpu}]")
    log(f"  comparator walls (compare_sketches, {n} files): device "
        f"{walls['device', False]:.3f} s, numpy "
        f"{walls['numpy', False]:.3f} s; {nq}-vs-{n}: device "
        f"{walls['device', True]:.3f} s, numpy {walls['numpy', True]:.3f} "
        f"s; chunked device {walls['chunked']:.3f} s; CLI (device) "
        f"{walls['cli']:.3f} s; score_matrix_device {walls['steps']:.3f} "
        f"s at 4,096 groups a step, {walls['steps_default']:.3f} s at "
        f"the default [{gpu}]")
    log(f"  comparator layers (all-vs-all, {n} files, host clock): decode "
        f"{walls['decode']:.6f} s; grouping (filter, native pass) "
        f"{walls['group']:.6f} s; scoring: numpy pair enumeration "
        f"{walls['enumerate']:.6f} s, score_matrix_device "
        f"{walls['steps_default']:.6f} s at the default step [{gpu}]")

    # the card's product against the CPU's, then timed
    cpu_score = CD.score_matrix_device(gids, fids, n_groups, len(files),
                                       make_mesh(["cpu"]), chunk_groups=4096)
    if not np.array_equal(cpu_score, score):
        raise AssertionError("score matrix: card != CPU")
    log(f"  score matrix: card == CPU ({n} x {n}, max_abs_err 0)")
    n_pad = CD.padded_files(len(files))
    default_rows = CD.step_groups(n_groups, len(files))
    for rows in sorted({4096, 32768, default_rows}) if timing else ():
        # the block of the first step of that many groups
        block = torch.zeros((n_pad, rows), dtype=torch.int8, device=device)
        e = int(np.searchsorted(gids, rows))
        block[torch.from_numpy(fids[:e]).to(device),
              torch.from_numpy(gids[:e]).to(device)] = 1
        nbytes = block.numel() + 4 * n_pad * n_pad
        ops = 2 * n_pad * n_pad * rows
        tb, to = nbytes / HBM_BPS, ops / INT8_OPS
        ms = cuda_ms(lambda: CD.presence_product(block), 20)
        log(f"  product torch._int_mm ({n_pad} x {rows} int8 block, "
            f"S = B B^T, int32): {ms:.4f} ms (CUDA events), "
            f"{ms * -(-n_groups // rows):.4f} ms over this corpus's "
            f"{-(-n_groups // rows)} steps; bound "
            f"{max(tb, to) * 1e3:.4f} ms by "
            f"{'bytes' if tb >= to else 'operations'} ({nbytes} B over "
            f"3.35 TB/s: {tb * 1e3:.4f} ms; {ops} int8 operations over "
            f"1,979 TOP/s: {to * 1e3:.4f} ms)"
            f"{' (the default step)' if rows == default_rows else ''} "
            f"[{gpu}]")

    # sort_csv on the all-vs-all jaccard matrix, to the reverse order
    with open(os.path.join(d, "reversed.txt"), "w") as f:
        f.writelines(p + "\n" for p in reversed(files))
    out = _run_cli(scli, ["cli_jaccard.csv.gz", "sorted.csv",
                          "reversed.txt"], d)
    with gzip.open(os.path.join(d, "cli_jaccard.csv.gz"), "rt") as f:
        before = [ln.split(",") for ln in f.read().splitlines()]
    with open(os.path.join(d, "sorted.csv")) as f:
        after = [ln.split(",") for ln in f.read().splitlines()]
    # the matrix is symmetric: row i of the reversed one is row n - 1 - i
    if (out.strip() != "The end" or after[0] != before[0][::-1]
            or any(float(after[1 + i][j]) != float(
                before[n - i][n - 1 - j]) for i in range(n)
                for j in range(n))):
        raise AssertionError("sort_csv: the reversed matrix differs")
    # kmer_dump: one line a distinct pair of the sketch
    _run_cli(kcli, [files[0], "kmers.txt"], d)
    with open(os.path.join(d, "kmers.txt")) as f:
        kmers = f.read().split()
    if (len(kmers) != ref.nb_kmer_seen_infile[0]
            or any(len(x) != 31 for x in kmers)):
        raise AssertionError("kmer_dump: not one 31-mer a pair")
    log(f"  sort_csv ({n} x {n} jaccard, reversed order) and kmer_dump "
        f"({len(kmers)} k-mers == nb_kmer_seen_infile of "
        f"{os.path.basename(files[0])}) agree")
    return {"counts": counts, "dir": d, "fastas": fastas, "files": files,
            "ref": ref, "gids": gids, "fids": fids, "n_groups": n_groups,
            "score": score_default}


@contextmanager
def per_shard_launches(per_shard: list):
    """Inside the block, every shard's scan_resolve_batch call in
    parallel/mesh.py appends the launches it made (the wrappers' own
    counters, read before and after the call) to per_shard."""
    from supersampler_tpu_torch.parallel import mesh as ME

    orig = ME.scan_resolve_batch

    def counted(*args):
        before = read_launches()
        out = orig(*args)
        after = read_launches()
        per_shard.append({key: after[key] - before[key]
                          for key in ("scan", "scan2", "sweep")})
        return out

    ME.scan_resolve_batch = counted
    try:
        yield
    finally:
        ME.scan_resolve_batch = orig


def _meshes(device):
    """(every visible card, the first card listed four times); on the
    CPU, (one CPU entry, four)."""
    from supersampler_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        return make_mesh(), make_mesh(["cuda:0"] * 4)
    return make_mesh([dev]), make_mesh([dev] * 4)


def _same_records(got, want, what: str) -> None:
    for b, (x, y) in enumerate(zip(got, want, strict=True)):
        for i, (a, c) in enumerate(zip(x, y, strict=True)):
            if not np.array_equal(np.asarray(a), np.asarray(c)):
                raise AssertionError(f"{what}: record {b}, field {i} "
                                     f"differs from one device's")


def phase_mesh_resolve(rng, device, n_rec=4096, P_rec=2048,
                       timing=True) -> dict:
    """Phase 6a: a reads-route batch (n_rec random records of P_rec
    positions, lengths 1,000-1,900) through sharded_field_resolve_fn
    over every card and over cuda:0 listed four times, on v1 and on v2
    (SPSP_FUSED=1): every shard's records equal one scan_resolve_batch
    of the whole batch on the card, and every shard launches the scan
    (v2: the v2 scan) and the sweep. Returns the launches of one call
    over the four entries, by path."""
    from supersampler_tpu_torch.ops.field import (parse_batched_array,
                                                  scan_resolve_batch)
    from supersampler_tpu_torch.ops.minimizer import pack_2bit
    from supersampler_tpu_torch.parallel.mesh import sharded_field_resolve_fn
    from supersampler_tpu_torch.sketch import TorchSubsampler
    from supersampler_tpu_torch.sketch.pipeline import _SharedSketchRun

    dev = torch.device(device)
    ss = TorchSubsampler(K, M, S, device=dev)
    # the reads route's list cap at a run's first batch
    cap = _SharedSketchRun([(ss, None)])._short_cap(n_rec * P_rec)
    lengths = rng.integers(1000, 1901, n_rec).astype(np.int32)
    codes = rng.integers(0, 4, (n_rec, P_rec), dtype=np.uint8)
    codes[np.arange(P_rec) >= lengths[:, None]] = 0
    packed = pack_2bit(torch.from_numpy(codes)).reshape(n_rec, -1)
    lengths = torch.from_numpy(lengths)
    gpu = gpu_line()
    out = {}
    for path in ("v1", "v2"):
        scan = "scan2" if path == "v2" else "scan"
        with fused_env() if path == "v2" else env_vars():
            reset_launches()
            t = time.perf_counter()
            whole = scan_resolve_batch(packed.to(dev), K, M, P_rec, cap,
                                       lengths.to(dev), *ss._thr)
            whole = whole.cpu().numpy()
            t_whole = time.perf_counter() - t
            g, n_sel, want, _st = parse_batched_array(whole, cap, n_rec)
            if g != 0 or want is None:
                raise AssertionError(f"{path}: the whole batch did not "
                                     f"resolve (status {g}, {n_sel} > "
                                     f"{cap}?)")
            log(f"  {path}, one scan_resolve_batch of {n_rec} x {P_rec} "
                f"(cap {cap}, {n_sel} selected): {t_whole:.4f} s, "
                f"launches {read_launches()} [{gpu}]")
            for mesh in _meshes(dev):
                fn = sharded_field_resolve_fn(mesh, K, M, P_rec, cap)
                shards = []
                reset_launches()
                with per_shard_launches(shards):
                    t = time.perf_counter()
                    rows = fn(packed, lengths, *ss._thr)
                    walls = [time.perf_counter() - t]
                counts = read_launches()
                if (len(shards) != mesh.size
                        or any(c[scan] <= 0 or c["sweep"] <= 0
                               for c in shards)):
                    raise AssertionError(f"{path}: a shard launched no "
                                         f"{scan} or sweep: {shards}")
                got = []
                for row in rows:
                    g, _n, comps, _st = parse_batched_array(
                        row, cap, n_rec // mesh.size)
                    if g != 0 or comps is None:
                        raise AssertionError(f"{path}: a shard did not "
                                             f"resolve (status {g})")
                    got.extend(comps)
                names = [str(d) for d in mesh.devices]
                _same_records(got, want, f"{path} over {names}")
                for _ in range(2 if timing else 0):
                    t = time.perf_counter()
                    fn(packed, lengths, *ss._thr)
                    walls.append(time.perf_counter() - t)
                each = "; ".join(f"{c[scan]} {scan}, {c['sweep']} sweep"
                                 for c in shards)
                log(f"  {path} over {names}: {n_rec} records equal one "
                    f"device's; launches per shard ({each}); walls of one "
                    f"call {', '.join(f'{w:.4f}' for w in walls)} s (the "
                    f"first counted) [{gpu}]")
                out[path] = counts      # the last mesh: four entries
    return out


def phase_mesh_scan(rng, device, n_rec=8, P=1 << 16) -> None:
    """Phase 6b: sharded_scan_fn over the first device listed four
    times on n_rec records of P positions equals batched_scan_fn on one
    device, field by field; one scan launch a record."""
    from supersampler_tpu_torch.ops.minimizer import ScanTables
    from supersampler_tpu_torch.parallel.mesh import (batched_scan_fn,
                                                      sharded_scan_fn)
    from supersampler_tpu_torch.sketch import TorchSubsampler

    dev = torch.device(device)
    thr = TorchSubsampler(K, M, S, device=dev)._thr
    lengths = rng.integers(P // 2, P - 7, n_rec).astype(np.int32)
    codes = rng.integers(0, 4, (n_rec, P), dtype=np.uint8)
    codes[np.arange(P) >= lengths[:, None]] = 0
    codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = batched_scan_fn(K, M, P)(codes.to(dev), lengths, *thr)
    quad = _meshes(dev)[1]
    reset_launches()
    t = time.perf_counter()
    got = sharded_scan_fn(quad, K, M, P)(codes, lengths, *thr)
    wall = time.perf_counter() - t
    counts = read_launches()
    err = max_abs_err(list(got), list(want))
    if err or counts["scan"] != n_rec:
        raise AssertionError(f"sharded scan: max_abs_err {err}, launches "
                             f"{counts}")
    log(f"  sharded_scan_fn over {[str(d) for d in quad.devices]}, "
        f"{n_rec} x {P}: all {len(ScanTables._fields)} fields equal "
        f"batched_scan_fn's (max_abs_err 0); {counts['scan']} scan "
        f"launches; {wall:.4f} s [{gpu_line()}]")


def phase_mesh_compare(ctx, device) -> None:
    """Phase 6c: phase 5b's sketches compared with the device engine
    over the first device listed four times: score_A, the seen counts
    and the CSVs equal the numpy engine's; score_matrix_device over that
    mesh at the default step and at 4,096 groups a step equals one
    device's matrix."""
    from supersampler_tpu_torch.compare.merge import TorchComparator
    from supersampler_tpu_torch.parallel import compare_dist as CD

    quad = _meshes(device)[1]
    files, ref = ctx["files"], ctx["ref"]
    reset_launches()
    t = time.perf_counter()
    comp = TorchComparator(engine="device", mesh=quad)
    comp.files_names = list(files)
    comp.compare_sketches(len(files))
    wall = time.perf_counter() - t
    if (comp.score_A != ref.score_A
            or comp.nb_kmer_seen_infile != ref.nb_kmer_seen_infile
            or comp.containment_csv() != ref.containment_csv()
            or comp.jaccard_csv() != ref.jaccard_csv()):
        raise AssertionError("mesh comparator differs from the numpy "
                             "engine")
    steps = {}
    for chunk in (1 << 18, 4096):
        t = time.perf_counter()
        score = CD.score_matrix_device(ctx["gids"], ctx["fids"],
                                       ctx["n_groups"], len(files), quad,
                                       chunk_groups=chunk)
        steps[chunk] = time.perf_counter() - t
        if not np.array_equal(score, ctx["score"]):
            raise AssertionError(f"mesh score matrix at {chunk} groups a "
                                 f"step differs from one device's")
    counts = read_launches()
    if counts["int_mm"] <= 0:
        raise AssertionError(f"the product never launched: {counts}")
    log(f"  comparator over {[str(d) for d in quad.devices]}: "
        f"{len(files)} sketches, CSVs equal the numpy engine's, "
        f"compare_sketches {wall:.3f} s; score_matrix_device over the "
        f"mesh == one device at the default step ({steps[1 << 18]:.4f} s)"
        f" and at 4,096 groups a step ({steps[4096]:.4f} s); launches "
        f"{counts} [{gpu_line()}]")


def phase_dist(ctx, device, workdir, n_sketch=8) -> None:
    """Phase 6d: two processes (gloo, file store, both on the device)
    run tests/torch_dist_worker.py: compare_all_vs_all_distributed over
    phase 5b's sketches, whose CSVs must be byte-equal to the
    single-process CLI's, and sketch_fof_distributed over n_sketch of
    its FASTAs at s = 100, whose union must be byte-equal to the
    single-process sketches. Each rank must exit 0 within 300 s."""
    d = os.path.join(workdir, "dist")
    os.makedirs(d)
    fof = os.path.join(d, "sketches.txt")
    with open(fof, "w") as f:
        f.writelines(p + "\n" for p in ctx["files"])
    sfof = os.path.join(d, "genomes.txt")
    with open(sfof, "w") as f:
        f.writelines(p + "\n" for p in ctx["fastas"][:n_sketch])
    worker = os.path.join(ROOT, "tests", "torch_dist_worker.py")
    env = dict(os.environ, TORCH_DEVICE=str(device))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, "--init", f"file://{d}/store", "--rank",
         str(r), "--world", "2", "--out", d, "--fof", fof, "--sketch-fof",
         sfof, "--s", "100"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            _out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}: "
                                     f"{err[-3000:]}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t
    owned = []
    for r in range(2):
        for kind in ("containment", "jaccard"):
            _same_bytes(os.path.join(d, f"rank{r}_{kind}.csv.gz"),
                        os.path.join(ctx["dir"], f"cli_{kind}.csv.gz"),
                        f"rank {r} against the single-process CLI")
        with open(os.path.join(d, f"rank{r}.json")) as f:
            rec = json.load(f)
        with open(os.path.join(d, f"rank{r}_sketches.txt")) as f:
            mine = f.read().split()
        owned += mine
        if torch.device(device).type == "cuda" and (
                rec["launches"]["scan"] <= 0
                or rec["launches"]["int_mm"] <= 0):
            raise AssertionError(f"rank {r}: a kernel never launched: "
                                 f"{rec['launches']}")
        w = rec["walls"]
        log(f"  rank {r} of 2: {len(mine)} sketches; walls: init "
            f"{w['init']:.3f} s, compare {w['compare']:.3f} s, sketch "
            f"{w['sketch']:.3f} s; launches {rec['launches']} "
            f"[{gpu_line()}]")
    names = sorted(os.path.basename(p) for p in owned)
    want = sorted("sk_" + os.path.basename(p)[:-3] + ".gz"
                  for p in ctx["fastas"][:n_sketch])
    if names != want:
        raise AssertionError(f"the ranks' sketches {names} != {want}")
    for p in owned:
        _same_bytes(p, os.path.join(ctx["dir"], os.path.basename(p)),
                    "a rank's sketch against the single-process one")
    log(f"  2 ranks (gloo, both on {device}): CSVs of {len(ctx['files'])} "
        f"sketches byte-equal to the CLI's on both ranks; {len(owned)} "
        f"sketches byte-equal to one process's; {wall:.3f} s from start "
        f"to exit [{gpu_line()}]")


def phase_dryrun(device) -> None:
    """Phase 6e: dryrun_multichip over every card, and over the first
    card listed four times."""
    from supersampler_tpu_torch.parallel.dryrun import dryrun_multichip

    dev = torch.device(device)
    reset_launches()
    t = time.perf_counter()
    if dev.type == "cuda":
        dryrun_multichip(torch.cuda.device_count())
        dryrun_multichip(4, devices=["cuda:0"] * 4)
    else:
        dryrun_multichip(1, devices=[dev])
        dryrun_multichip(4, devices=[dev] * 4)
    wall = time.perf_counter() - t
    counts = read_launches()
    if counts["scan"] <= 0 or counts["sweep"] <= 0 or counts["int_mm"] <= 0:
        raise AssertionError(f"a kernel of the dry run never launched: "
                             f"{counts}")
    log(f"  both dry runs passed in {wall:.3f} s; launches {counts} "
        f"[{gpu_line()}]")


def fault_fasta(rng, path) -> int:
    """The input of the three prep faults: empty records next to
    headers, ahead of short (300 bp) and long (70 kb and 150 kb, over
    the short batch's limit) records; N, R and Y runs; lowercase
    stretches; and CB, TU, GF and A@ pairs among the bases. Returns the
    records' sequence characters."""
    def bases(n):
        b = _ACGT[rng.integers(0, 4, n, dtype=np.uint8)].copy()
        for _ in range(n // 2000 + 1):
            a = int(rng.integers(0, max(n - 60, 1)))
            b[a : a + int(rng.integers(1, 60))] = ord(rng.choice(list("NRY")))
            a = int(rng.integers(0, max(n - 500, 1)))
            b[a : a + 500] |= 0x20
        for pair in (b"CB", b"TU", b"GF", b"A@") * (n // 4000 + 1):
            a = int(rng.integers(0, max(n - 2, 1)))
            b[a : a + 2] = np.frombuffer(pair, np.uint8)
        return b.tobytes()

    def lines(seq, width=61):
        return b"".join(seq[j : j + width] + b"\n"
                        for j in range(0, len(seq), width))

    recs = [bases(n) for n in (300, 70_000, 150_000, 800)]
    text = (b">e0\n>e1\n" + lines(recs[0]) + b">e2\n>e3\n"
            + lines(recs[1]) + b">e4\n>e5\n>e6\n" + lines(recs[2])
            + b">e7\n" + lines(recs[3]) + b">e8\n>e9\n")
    with open(path, "wb") as f:
        f.write(text)
    return sum(len(r) for r in recs)


def fof_corpus(rng, workdir, n_genomes=8, glen=TILE_L, n_readsets=2,
               n_reads=10_000, n_viral=200, vlen=30_000):
    """Phase 7's corpus: n_genomes one-record genomes (one 4 Mbp tile
    each), n_readsets read sets of n_reads x 1 kb (the batch route),
    n_viral one-record files of vlen (one short batch a file), the
    fault file, and a missing entry in the middle. Returns (entries,
    bases, index of the missing entry, index of the fault file)."""
    d = os.path.join(workdir, "fof")
    os.makedirs(d)
    entries, bases = [], 0
    for i in range(n_genomes):
        entries.append(os.path.join(d, f"genome{i}.fa"))
        bases += write_fasta(entries[-1], [rng.integers(
            0, 4, glen, dtype=np.uint8)], b"chr", width=80)
    for i in range(n_readsets):
        entries.append(os.path.join(d, f"reads{i}.fa"))
        bases += write_fasta(entries[-1], rng.integers(
            0, 4, (n_reads, 1000), dtype=np.uint8), b"q")
    for i in range(n_viral):
        entries.append(os.path.join(d, f"viral{i}.fa"))
        bases += write_fasta(entries[-1], [rng.integers(
            0, 4, vlen, dtype=np.uint8)], b"v", width=70)
    fault = len(entries)
    entries.append(os.path.join(d, "faults.fa"))
    bases += fault_fasta(rng, entries[-1])
    missing = len(entries) // 2
    entries.insert(missing, os.path.join(d, "missing.fa"))
    if missing <= fault:
        fault += 1
    return entries, bases, missing, fault


def sketch_entries(entries, device, engine="field"):
    """sketch_fof over entries (one subsampler each, logs kept apart).
    Returns (results, logs, wall s, launches)."""
    from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof

    sss = []
    for _ in entries:
        ss = TorchSubsampler(k=K, m=M, s=S, device=device)
        ss.scan_engine = engine
        ss.log = io.StringIO()
        sss.append(ss)
    reset_launches()
    t0 = time.perf_counter()
    out = sketch_fof(list(zip(sss, entries)))
    wall = time.perf_counter() - t0
    return out, [ss.log.getvalue() for ss in sss], wall, read_launches()


def phase_fof(rng, device, workdir, **sizes) -> dict:
    """Phase 7: sketch_fof on the card over the fof corpus (fof_corpus;
    sizes are its). Every sketch equals the file's own sketch_file on
    the card and the -f CLI's output; the fault file and 8 of the viral
    files also equal the CPU path's, v2's (SPSP_FUSED=1) and the legacy
    engine's. Prints the first pass's wall and launches, then the warm
    walls of the fof and of the per-file sketch_file calls in turns
    (per-file, fof, fof, per-file) and the phase timers' report of the
    last fof pass.
    Returns {"v1": ..., "v2": ..., "legacy": ...} launch counts."""
    from supersampler_tpu_torch.cli import sub_sampler as cli
    from supersampler_tpu_torch.sketch import TorchSubsampler
    from supersampler_tpu_torch.utils.profiling import timers

    entries, bases, missing, fault = fof_corpus(rng, workdir, **sizes)
    gpu = gpu_line()
    got, logs, wall, counts = sketch_entries(entries, device)
    if got[missing] is not None or logs[missing] != (
            f"Problem with file opening\nCan't open file: "
            f"{entries[missing]}\n"):
        raise AssertionError("fof: the missing entry was not reported")
    for i, raw in enumerate(got):
        if i != missing:
            check_sketch(raw, empty_ok="/viral" in entries[i])
    if min(counts["scan"], counts["sweep"]) <= 0 or counts["scan2"]:
        raise AssertionError(f"fof (v1): a kernel of the path never "
                             f"launched, or the v2 scan did: {counts}")
    log(f"  sketch_fof over {len(entries)} entries ({bases} bases), first "
        f"pass: wall {wall:.3f} s; launches {counts} [{gpu}]")

    def per_file():
        out, walls = [], 0.0
        for path in entries:
            ss = TorchSubsampler(k=K, m=M, s=S, device=device)
            ss.log = io.StringIO()
            t0 = time.perf_counter()
            out.append(ss.sketch_file(path))
            walls += time.perf_counter() - t0
        return out, walls

    # warm passes in turns: per-file, fof, fof, per-file
    walls = {"fof": [], "per-file": []}
    for name in ("per-file", "fof", "fof", "per-file"):
        if name == "fof":
            timers.reset()
            out, _logs, w, _c = sketch_entries(entries, device)
            report = timers.report()
        else:
            out, w = per_file()
        if out != got:
            bad = [os.path.basename(entries[i]) for i in range(len(got))
                   if out[i] != got[i]]
            raise AssertionError(f"{name} pass != first pass: {bad[:8]}")
        walls[name].append(w)
    log(f"  every sketch == its file's own sketch_file; warm walls: fof "
        + ", ".join(f"{w:.3f}" for w in walls["fof"])
        + f" s ({bases / 1e6 / min(walls['fof']):.1f} Mbases/s at best); "
        "per-file sum " + ", ".join(f"{w:.3f}" for w in walls["per-file"])
        + f" s [{gpu}]")
    log("  phase timers of the last fof pass (summed over threads):")
    for line in report.splitlines():
        log(f"    {line}")

    fof = os.path.join(workdir, "fof", "corpus.txt")
    with open(fof, "w") as f:
        f.writelines(p + "\n" for p in entries)
    cwd = os.getcwd()
    os.chdir(os.path.join(workdir, "fof"))
    try:
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()), \
                env_vars(TORCH_DEVICE=str(device)):
            rc = cli.main(["-f", fof, "-k", str(K), "-m", str(M), "-s",
                           f"{S:g}", "-p", "f_"])
        cli_wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    names = [os.path.basename(p).split(".")[0] for p in entries]
    with open(os.path.join(workdir, "fof", "f_corpus.txt")) as f:
        if rc != 0 or f.read().split() != [f"f_{n}.gz" for n in names]:
            raise AssertionError("-f: rc or out-fof order differs")
    for i, name in enumerate(names):
        out = os.path.join(workdir, "fof", f"f_{name}.gz")
        if i == missing:
            if os.path.exists(out):
                raise AssertionError("-f wrote a sketch of a missing entry")
            continue
        with open(out, "rb") as f:
            if gzip.decompress(f.read()) != got[i]:
                raise AssertionError(f"-f: f_{name}.gz != sketch_fof's")
    log(f"  -f CLI over the same fof: every sketch == sketch_fof's, out-fof "
        f"in fof order; wall {cli_wall:.3f} s [{gpu}]")

    small = [entries[fault]] + [p for p in entries
                                if "/viral" in p][:8]
    want = [got[entries.index(p)] for p in small]
    runs = {"v1": counts}
    for name, dev, engine, env in (
            ("cpu", "cpu", "field", nullcontext),
            ("v2", device, "field", fused_env),
            ("legacy", device, "legacy", nullcontext)):
        with env():
            out, _logs, w, c = sketch_entries(small, dev, engine)
        if out != want:
            raise AssertionError(f"fault file and 8 viral files: {name} "
                                 f"bytes differ from the card's v1")
        runs[name] = c
        log(f"  fault file and 8 viral files, {name}: bytes == card v1; "
            f"wall {w:.3f} s; launches {c}")
    if runs["v2"]["scan2"] <= 0 or runs["legacy"]["walk"] <= 0:
        raise AssertionError(f"v2 or legacy fof: a kernel never launched: "
                             f"{runs}")
    return runs


def record_spans(ss, codes: np.ndarray):
    """The selected spans of one record (2-bit codes) through ss's
    default path, the tail flush included: (pos, last, val, rev) lists."""
    comp, _ = ss._fetch_scan(ss._launch_scan(_ACGT[codes]))
    pos, last, val, rev, n_ev, last_ev, tv, tr, ts = comp
    spans = [list(pos), list(last), [int(v) for v in val], list(rev)]
    if ts:
        for col, v in zip(spans, (codes.size - K, last_ev + 1 if n_ev else 0,
                                  tv, tr)):
            col.append(v)
    return spans


def phase_dedup_spans(rng, device, tile_l=TILE_L, rec_l=100_000,
                      timing=True) -> None:
    """Phase 8a: ops/dedup.py dedup_spans on the card against the CPU on
    the spans of a 4 Mbp tile like phase 2's (s = 1000 and s = 64) and
    of a 100 kb record at s = 1 (select-all, K = own), in the halo'd
    frame and at the sizes the path gives it: n_kmers, n_unique and the
    rows below n_unique equal. Prints the card's and the CPU's times."""
    from supersampler_tpu_torch.ops.dedup import _HALO_LEFT, dedup_spans
    from supersampler_tpu_torch.ops.field import _pow2_ge
    from supersampler_tpu_torch.sketch import TorchSubsampler

    tile = rng.integers(0, 4, tile_l, dtype=np.uint8)
    rec = rng.integers(0, 4, rec_l, dtype=np.uint8)
    gpu = gpu_line()
    for name, codes, s in ((f"{tile_l} bp tile, s = 1000", tile, 1000.0),
                           (f"{tile_l} bp tile, s = 64", tile, 64.0),
                           (f"{rec_l} bp record, s = 1", rec, 1.0)):
        ss = TorchSubsampler(k=K, m=M, s=s, device=device)
        route, own, n_tiles, positions = ss._scan_geometry(codes.size)
        if (route, n_tiles) != ("field", 1):
            raise AssertionError(f"{name}: not one field tile")
        spans = record_spans(ss, codes)
        n_sel = len(spans[0])
        cap = _pow2_ge(n_sel + 1)
        P = positions + _HALO_LEFT
        Kcap = own if s <= 1 else _pow2_ge((n_sel + 1) * (K - M + 1))
        ext = np.zeros(P, np.uint8)
        ext[_HALO_LEFT : _HALO_LEFT + codes.size] = codes
        cols = [np.full(cap, -1, np.int64) for _ in range(3)]
        cols[2][:] = 0
        for col, vals, shift in zip(cols, spans, (_HALO_LEFT, _HALO_LEFT,
                                                  0)):
            col[:n_sel] = np.asarray(vals, np.int64) + shift
        rev = np.zeros(cap, bool)
        rev[:n_sel] = spans[3]

        def args(dev):
            return (torch.from_numpy(ext).to(dev),
                    (*(torch.from_numpy(c).to(dev) for c in cols),
                     torch.from_numpy(rev).to(dev),
                     torch.tensor(n_sel, device=dev)), K, M, P, Kcap)

        dev_args, cpu_args = args(device), args("cpu")
        got = dedup_spans(*dev_args)
        t0 = time.perf_counter()
        want = dedup_spans(*cpu_args)
        cpu_s = time.perf_counter() - t0
        n_kmers, n_unique = int(want[0]), int(want[1])
        if (int(got[0]), int(got[1])) != (n_kmers, n_unique) or any(
                not torch.equal(g[:n_unique].cpu(), w[:n_unique])
                for g, w in zip(got[2:], want[2:])):
            raise AssertionError(f"dedup_spans, {name}: card != cpu")
        if n_kmers > Kcap or n_unique == 0:
            raise AssertionError(f"dedup_spans, {name}: n_kmers {n_kmers} "
                                 f"K {Kcap} n_unique {n_unique}")
        card = (f"card {cuda_ms(lambda: dedup_spans(*dev_args), 5):.3f} ms"
                if timing else "untimed")
        log(f"  dedup_spans, {name} ({n_sel} spans, P {P}, K {Kcap}): card "
            f"== cpu (n_kmers {n_kmers}, n_unique {n_unique}); {card}, cpu "
            f"{cpu_s * 1e3:.1f} ms [{gpu}]")


def dedup_corpus(rng, workdir, long_len=12_000_000, single_len=100_000,
                 n_reads=2000, n_short=200):
    """Phase 8's own inputs: the desert corpus's two long records (a
    single_len record with a 3 kb poly-A, a long_len one with a 3 kb
    poly-T inside tile 1) and n_reads reads, n_short of them 300-790 bp
    (the walk route), the others 1 kb. Returns (desert path, reads path,
    their bases)."""
    own = TILE_P - 512
    single = rng.integers(0, 4, single_len, dtype=np.uint8)
    single[single_len // 2 : single_len // 2 + 3000] = 0
    long_rec = rng.integers(0, 4, long_len, dtype=np.uint8)
    at = own + (long_len - own) // 2
    long_rec[at : at + 3000] = 3
    desert = os.path.join(workdir, "desert_long.fa")
    d_bases = write_fasta(desert, [single, long_rec], b"d", width=80)
    lens = np.full(n_reads, 1000)
    lens[rng.choice(n_reads, n_short, replace=False)] = rng.integers(
        300, 791, n_short)
    reads = os.path.join(workdir, "reads_dedup.fa")
    r_bases = write_fasta(reads, [rng.integers(0, 4, n, dtype=np.uint8)
                                  for n in lens], b"r")
    return desert, reads, d_bases, r_bases


def sketch_one(path, device, s=S, engine="field", **flags):
    """sketch_file of one fresh subsampler on the card, the launch
    counters and phase timers reset before and read after. Returns
    (bytes, wall s, launches, timers' report on one line, subsampler)."""
    from supersampler_tpu_torch.sketch import TorchSubsampler
    from supersampler_tpu_torch.utils.profiling import timers

    ss = TorchSubsampler(k=K, m=M, s=s, device=device)
    ss.scan_engine = engine
    for name, value in flags.items():
        setattr(ss, name, value)
    reset_launches()
    timers.reset()
    t0 = time.perf_counter()
    raw = ss.sketch_file(path)
    wall = time.perf_counter() - t0
    report = "; ".join(" ".join(line.split())
                       for line in timers.report().splitlines())
    return raw, wall, read_launches(), report, ss


def phase_dedup(rng, device, workdir, genome, bench_genome, **sizes) -> dict:
    """Phase 8b-c: sketches with device_dedup = True on the card, each
    byte-equal to the default path's sketch of the same file on the card:
    phase 4's genome (two tiles) at s = 1000 and s = 64, the desert
    corpus's long records (tile fallbacks), the bench genome set, reads
    with some on the walk route (dedup_corpus; sizes are its), and the
    genome again through the legacy engine; then native_finisher = False
    on the genome and on the 10 goldens (golden bytes), and the goldens
    with device dedup. Each run's launch counters must show the
    kernels of its routes. Returns the dedup runs' launches summed."""
    from supersampler_tpu_torch.sketch import TorchSubsampler

    desert, reads, d_bases, r_bases = dedup_corpus(rng, workdir, **sizes)
    gpu = gpu_line()
    dd = {"device_dedup": True}
    cells = (
        (f"genome, s = {S:g}", genome, S, "field", dd, ("scan", "sweep")),
        ("genome, s = 64", genome, 64.0, "field", dd, ("scan", "sweep")),
        (f"desert long records ({d_bases} bases)", desert, S, "field", dd,
         ("scan", "sweep", "walk")),
        ("bench genome set", bench_genome, S, "field", dd, ("scan", "sweep")),
        (f"reads with 300-790 bp ones ({r_bases} bases)", reads, S, "field",
         dd, ("scan", "sweep", "walk")),
        ("genome, legacy engine", genome, S, "legacy", dd, ("scan", "walk")),
        ("genome, native_finisher = False", genome, S, "field",
         {"native_finisher": False}, ("scan", "sweep")),
    )
    total = {name: 0 for name in read_launches()}
    for name, path, s, engine, flags, need in cells:
        want, w_def, _c, _r, _ss = sketch_one(path, device, s)
        got, wall, counts, report, ss = sketch_one(path, device, s, engine,
                                                   **flags)
        if got != want:
            raise AssertionError(f"{name}: {flags} bytes != default path's")
        check_sketch(got)
        if (min(counts[n] for n in need) <= 0 or counts["scan2"]
                or (engine == "legacy" and counts["sweep"])):
            raise AssertionError(f"{name}: launches {counts}, want {need}")
        if "desert" in name and ss.fallbacks["tile"] < 2:
            raise AssertionError(f"{name}: fallbacks {ss.fallbacks}")
        if "device_dedup" in flags:
            for n in total:
                total[n] += counts[n]
        log(f"  {name}, {flags}: bytes == default path's ({len(got)} B); "
            f"wall {wall:.3f} s against {w_def:.3f} s; launches {counts}; "
            f"fallbacks {ss.fallbacks}; phases: {report} [{gpu}]")

    make_data = load_tests_module("make_data")
    gold = os.path.join(ROOT, "tests", "golden")
    data = make_data.make_all(os.path.join(workdir, "data8"))
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    for flags in ({"native_finisher": False}, dd):
        reset_launches()
        t0 = time.perf_counter()
        for cfg in meta["sketches"]:
            with gzip.open(os.path.join(gold, cfg["file"]), "rb") as f:
                want = f.read()
            ss = TorchSubsampler(k=cfg["k"], m=cfg["m"],
                                 s=float(np.float32(cfg["s"])),
                                 abundance=cfg["a"], device=device)
            for attr, value in flags.items():
                setattr(ss, attr, value)
            if ss.sketch_file(data[cfg["dataset"]]) != want:
                raise AssertionError(f"golden {cfg['file']} differs "
                                     f"({flags})")
        counts = read_launches()
        if min(counts["scan"], counts["sweep"]) <= 0:
            raise AssertionError(f"goldens {flags}: launches {counts}")
        log(f"  all {len(meta['sketches'])} golden sketches equal ({flags}); "
            f"{time.perf_counter() - t0:.3f} s; launches {counts}")
    return total


# the print_stat counters a sketcher is held to, with its bytes
COUNTERS = ("read_kmer", "total_kmer_number", "total_superkmer_number",
            "selected_kmer_number", "selected_superkmer_number",
            "count_maximal_skmer", "nb_mmer_selected",
            "seen_kmers_at_reconstruction",
            "seen_superkmers_at_reconstruction",
            "seen_max_superkmers_at_reconstruction",
            "seen_unique_kmers_at_reconstruction",
            "total_kmer_number_at_reconstruction",
            "actual_minimizer_number")


def oracle_corpus(rng, workdir, n_fuzz=40, big_len=1_000_000):
    """Phase 9's inputs: n_fuzz multi-record files of
    tests/oracle_cases.py's shapes (a 3 kb homopolymer or tandem repeat
    in one file of ten) and two files of one big_len record each,
    random and repeat-rich. Returns (fuzz paths, big paths, bases)."""
    oc = load_tests_module("oracle_cases")
    d = os.path.join(workdir, "oracle")
    os.makedirs(d)
    fuzz, bases = [], 0
    for i in range(n_fuzz):
        fuzz.append(os.path.join(d, f"fuzz{i}.fa"))
        bases += oc.fuzz_fasta(rng, fuzz[-1], heavy=oc.fuzz_heavy(i))
    big = [os.path.join(d, "random.fa"), os.path.join(d, "repeats.fa")]
    for path, seq in zip(big, (_ACGT[rng.integers(0, 4, big_len)].tobytes(),
                               oc.repeat_rich(rng, big_len))):
        with open(path, "wb") as f:
            f.write(b">big\n" + b"\n".join(
                seq[j : j + 80] for j in range(0, len(seq), 80)) + b"\n")
        bases += len(seq)
    return fuzz, big, bases


def phase_oracle(rng, device, workdir, family_sketches, **sizes) -> dict:
    """Phase 9: the card held to the port's scalar oracle
    (supersampler_tpu_torch/oracle), which shares no code with the card
    path but the k-mer store, the counters and the threshold. Inputs
    (oracle_corpus; sizes are its): 40 fuzz files at every configuration
    of tests/oracle_cases.py CONFIGS (the 10 golden (k, m, s, a) and
    (31, 11) at s = 64), and a random and a repeat-rich 1 Mbp record at
    (31, 11) and s = 64 and 1000. OracleSubsampler sketches each file at
    each of its configurations once; every card sketch of it must equal
    that sketch byte for byte, with equal print_stat counters: the
    default v1 engine (sketch_file per file), sketch_fof over the
    configuration's files on v1, on v2 (SPSP_FUSED=1) and on the legacy
    engine, and device_dedup = True (through sketch_fof). Cut: device
    dedup goes record by record (about 17 ms a record on the card), so it
    runs at the golden configurations only. Then OracleComparator,
    TorchComparator's device engine and its numpy engine compare 12 of
    these sketches (8 fuzz files at (31, 11, 10), the two 1 Mbp records
    at s = 64 and 1000) and 8 of phase 5's family sketches, all-vs-all
    and in query mode (-q of 4, precision 3, min_threshold 0.05): the
    CSVs must be byte-equal, and eval.norms of the device CSVs against
    the oracle's must give zero norms. The oracle's seconds are CPU
    seconds of this process. Returns the phase's launches by kernel
    table key."""
    from supersampler_tpu_torch.compare.merge import TorchComparator
    from supersampler_tpu_torch.compare.writers import write_matrix_gz
    from supersampler_tpu_torch.eval import norms
    from supersampler_tpu_torch.io.gzip_exact import write_gzip_exact
    from supersampler_tpu_torch.oracle import (OracleComparator,
                                               OracleSubsampler)
    from supersampler_tpu_torch.sketch import TorchSubsampler, sketch_fof

    oc = load_tests_module("oracle_cases")
    fuzz, big, bases = oracle_corpus(rng, workdir, **sizes)
    gpu = gpu_line()

    def files_of(cfg):
        k, m, s, _a = cfg
        return fuzz + (big if (k, m) == (31, 11) and s in ("64", "1000")
                       else [])

    def fresh(cfg, cls=TorchSubsampler, **attrs):
        k, m, s, a = cfg
        ss = cls(k, m, float(np.float32(s)), a, **(
            {"device": device} if cls is TorchSubsampler else {}))
        ss.log = io.StringIO()
        for name, value in attrs.items():
            setattr(ss, name, value)
        return ss

    def result(ss, raw):
        return raw, tuple(getattr(ss, c) for c in COUNTERS)

    want, t_oracle = {}, {"fuzz": 0.0, "big": 0.0}
    for cfg in oc.CONFIGS:
        k, m = cfg[:2]
        for path in files_of(cfg):
            t = time.process_time()
            ss = fresh(cfg, OracleSubsampler)
            want[path, cfg] = result(ss, ss.sketch_file(path))
            t_oracle["big" if path in big else "fuzz"] += (
                time.process_time() - t)
            if not want[path, cfg][0].startswith(b"%d %d " % (2 * k - m, m)):
                raise AssertionError(f"oracle: malformed sketch of {path}")
        if not any(want[p, cfg][1][3] for p in files_of(cfg)):
            raise AssertionError(f"oracle: nothing selected at {cfg}")

    runs = (("v1", {}, False), ("fof", {}, False), ("v2", {}, True),
            ("legacy", {"scan_engine": "legacy"}, False),
            ("dedup", {"device_dedup": True}, False))
    launches = {name: dict.fromkeys(read_launches(), 0) for name, *_ in runs}
    walls = dict.fromkeys(launches, 0.0)
    card, held = {}, 0
    for name, attrs, v2 in runs:
        for cfg in oc.CONFIGS:
            if name == "dedup" and cfg not in oc.GOLDEN_CONFIGS:
                continue
            paths = files_of(cfg)
            reset_launches()
            t = time.perf_counter()
            with fused_env() if v2 else nullcontext():
                if name == "v1":
                    sss = [fresh(cfg) for _ in paths]
                    got = [ss.sketch_file(p) for ss, p in zip(sss, paths)]
                else:
                    sss = [fresh(cfg, **attrs) for _ in paths]
                    got = sketch_fof(list(zip(sss, paths)))
            walls[name] += time.perf_counter() - t
            for key, n in read_launches().items():
                launches[name][key] += n
            for ss, path, raw in zip(sss, paths, got):
                if result(ss, raw) != want[path, cfg]:
                    what = ("bytes" if raw != want[path, cfg][0]
                            else "counters")
                    raise AssertionError(
                        f"oracle: {name} {what} of {path} at {cfg} differ "
                        f"from OracleSubsampler's")
                held += 1
                if name == "v1":
                    card[path, cfg] = raw
    need = {"v1": ("scan", "sweep"), "fof": ("scan", "sweep"),
            "v2": ("scan2", "sweep"), "legacy": ("scan", "walk"),
            "dedup": ("scan", "sweep", "walk")}
    for name, keys in need.items():
        if (min(launches[name][n] for n in keys) <= 0
                or (name != "v2" and launches[name]["scan2"])
                or (name == "legacy" and launches[name]["sweep"])):
            raise AssertionError(f"oracle: {name} launches "
                                 f"{launches[name]}, want {keys}")
    total = {n: sum(c[n] for c in launches.values()) for n in launches["v1"]}
    counts = {"scan": total["scan"], "scan2": total["scan2"],
              "sweep": total["sweep"] - launches["v2"]["sweep"],
              "sweep_col": launches["v2"]["sweep"], "walk": total["walk"]}
    n_cfg = sum(len(files_of(c)) for c in oc.CONFIGS)
    log(f"  {held} card sketches of {len(fuzz) + len(big)} files "
        f"({bases} bases; {n_cfg} file-configurations over "
        f"{len(oc.CONFIGS)} (k, m, s, a)) == OracleSubsampler, bytes and "
        f"counters: v1, sketch_fof, v2, legacy and device_dedup (golden "
        f"configurations); launches {counts}; oracle "
        f"{t_oracle['fuzz'] + t_oracle['big']:.3f} CPU s (fuzz "
        f"{t_oracle['fuzz']:.3f}, 1 Mbp records {t_oracle['big']:.3f}); "
        f"card path {sum(walls.values()):.3f} s ("
        + ", ".join(f"{n} {w:.3f}" for n, w in walls.items())
        + f") [{gpu}]")

    # the comparators on the card's sketches
    d = os.path.dirname(fuzz[0])
    sketches = []
    for path, cfg in ([(p, oc.CONFIGS[0]) for p in fuzz[:8]]
                      + [(p, c) for p in big for c in oc.CONFIGS
                         if p in files_of(c)]):
        sketches.append(os.path.join(
            d, f"sk_{os.path.basename(path)[:-3]}_s{cfg[2]}.gz"))
        write_gzip_exact(sketches[-1], card[path, cfg], level=9)
    files = sketches + family_sketches[:4] + family_sketches[8:12]
    queries = files[:4]
    t_cmp = {}
    for query in (False, True):
        names = (queries if query else []) + files
        qs = len(queries) if query else len(files)
        opts = ({"precision": 3, "min_threshold": 0.05} if query else {})
        out = {}
        for name, make in (
                ("oracle", lambda: OracleComparator(**opts)),
                ("device", lambda: TorchComparator(engine="device",
                                                   device=device, **opts)),
                ("numpy", lambda: TorchComparator(engine="numpy", **opts))):
            c = make()
            c.files_names = list(names)
            t = (time.process_time() if name == "oracle"
                 else time.perf_counter())
            with redirect_stdout(io.StringIO()):
                c.compare_sketches(qs)
            t_cmp[name, query] = ((time.process_time() if name == "oracle"
                                   else time.perf_counter()) - t)
            out[name] = (c.containment_csv(), c.jaccard_csv(), c.score_A,
                         c.nb_kmer_seen_infile)
        for name in ("device", "numpy"):
            if out[name] != out["oracle"]:
                raise AssertionError(f"oracle: {name} comparator differs "
                                     f"from OracleComparator (query "
                                     f"{query})")
        if not out["oracle"][2]:
            raise AssertionError("oracle: the compared sketches share "
                                 "nothing")
        for i, kind in enumerate(("containment", "jaccard")):
            paths = {}
            for name in ("oracle", "device"):
                paths[name] = os.path.join(d, f"{name}_{kind}_{query}.csv.gz")
                write_matrix_gz(paths[name], out[name][i])
            _same_bytes(paths["device"], paths["oracle"],
                        f"{kind} CSV, device against oracle")
            dist = norms.compare_matrices(norms.load_matrix(paths["device"]),
                                          norms.load_matrix(paths["oracle"]))
            if dist["norm1"] != 0 or dist["norm2"] != 0:
                raise AssertionError(f"oracle: eval.norms of the {kind} "
                                     f"CSVs: {dist}")
    log(f"  comparators on {len(files)} sketches ({len(sketches)} of this "
        f"phase, 8 of phase 5): OracleComparator == device engine == "
        f"numpy engine (CSV bytes, score_A, nb_kmer_seen_infile), "
        f"all-vs-all and {len(queries)}-vs-{len(files)}; eval.norms of "
        f"the device CSVs against the oracle's: norm1 = norm2 = 0; oracle "
        f"{t_cmp['oracle', False]:.3f} + {t_cmp['oracle', True]:.3f} CPU "
        f"s, device {t_cmp['device', False]:.3f} + "
        f"{t_cmp['device', True]:.3f} s, numpy {t_cmp['numpy', False]:.3f}"
        f" + {t_cmp['numpy', True]:.3f} s [{gpu}]")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from supersampler_tpu_torch.ops import _build

    t_start = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[0] device: {gpu} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    _build.lib()
    built = ("up to date" if _build.build_seconds is None
             else f"nvcc {_build.build_seconds:.2f} s")
    log(f"[1] build: {built} (load {time.perf_counter() - t0:.2f} s)")
    # ptxas: "Compiling entry function '<mangled name>'", then its use
    names = (("scan2_kernel", "scan2"), ("scan_kernel", "scan"),
             ("sweep_kernelILb0E", "sweep (lane)"),
             ("sweep_kernelILb1E", "sweep (col)"), ("walk_maps", "walk maps"),
             ("walk_compose", "walk compose"), ("walk_emit", "walk emit"))
    for line in (_build.build_log or "").splitlines():
        if "entry function" in line:
            log("  ptxas, " + next((n for key, n in names if key in line),
                                   line))
        elif "registers" in line or "spill" in line:
            log(f"    {line.split(':', 1)[-1].strip()}")

    log("[2] kernels vs plain on the card")
    kt = phase_kernels(rng, "cuda")
    kt["scan"]["max_abs_err"] = max(kt["scan"]["max_abs_err"],
                                    phase_scan_cases("cuda"))
    edge_err = phase_sweep_edges("cuda")
    kt["walk"] = phase_walk(rng, "cuda")
    kt.update(phase_fused(rng, "cuda"))
    kt["scan2"]["max_abs_err"] = max(kt["scan2"]["max_abs_err"],
                                     phase_scan_cases("cuda", v2=True))
    kt["sweep"]["max_abs_err"] = max(kt["sweep"]["max_abs_err"], edge_err)
    kt["sweep_col"]["max_abs_err"] = max(
        kt["sweep_col"]["max_abs_err"], edge_err,
        kt["sweep_col_v2"]["max_abs_err"])
    with tempfile.TemporaryDirectory() as tmp:
        log("[3] goldens on the card")
        phase_goldens("cuda", tmp)
        with fused_env():
            phase_goldens("cuda", tmp, v2=True)
        phase_goldens("cuda", tmp, engine="legacy")
        log("[4] real size")
        phase_cpu_parity(rng, "cuda", tmp)
        phase_desert(rng, "cuda", tmp)
        c1, c2, *bench_genome = phase_bench(rng, tmp)
        c_legacy = phase_bench_legacy("cuda", tmp, *bench_genome)
        log("[5] comparator on the card")
        phase_compare_goldens("cuda", tmp)
        ctx = phase_compare_real(rng, "cuda", tmp)
        log("[6] multi-device on the card")
        mesh_counts = phase_mesh_resolve(rng, "cuda")
        phase_mesh_scan(rng, "cuda")
        phase_mesh_compare(ctx, "cuda")
        phase_dist(ctx, "cuda", tmp)
        phase_dryrun("cuda")
        log("[7] sketch_fof on the card")
        fof_counts = phase_fof(rng, "cuda", tmp)
        log("[8] device dedup and the Python store on the card")
        phase_dedup_spans(rng, "cuda")
        dedup_counts = phase_dedup(rng, "cuda", tmp,
                                   os.path.join(tmp, "g5.fa"),
                                   bench_genome[0])
        log("[9] the card against the port's scalar oracle")
        oracle_counts = phase_oracle(rng, "cuda", tmp, ctx["files"])
    # one sharded call of the 4,096-record batch over four entries
    for key, path, name in (("scan", "v1", "scan"), ("sweep", "v1", "sweep"),
                            ("scan2", "v2", "scan2"),
                            ("sweep_col", "v2", "sweep")):
        kt[key]["mesh_launches"] = mesh_counts[path][name]
    # launches in phase 7's runs: v1 kernels in the whole fof, v2 and the
    # walk in the fault file and 8 viral files on v2 and the legacy engine
    for key, path, name in (("scan", "v1", "scan"), ("sweep", "v1", "sweep"),
                            ("scan2", "v2", "scan2"),
                            ("sweep_col", "v2", "sweep"),
                            ("walk", "legacy", "walk")):
        kt[key]["fof_launches"] = fof_counts[path][name]
    # launches in phase 8's device-dedup sketches (v1 kernels and the walk)
    for key in ("scan", "sweep", "walk"):
        kt[key]["dedup_launches"] = dedup_counts[key]
    # launches in phase 9's card sketches (every engine, all configurations)
    for key in ("scan", "scan2", "sweep", "sweep_col", "walk"):
        kt[key]["oracle_launches"] = oracle_counts[key]
    for name, pre in (("tile", ""), ("1024 x 1 kb batch", "batch_")):
        s1, s2 = kt["scan"], kt["scan2"]
        log(f"  times at the {name}: scan {s1[pre + 'ms']:.4f} ms (plain "
            f"{s1[pre + 'plain_ms']:.4f} ms, bound "
            f"{s1[pre + 'bound_ms']:.4f} ms), scan2 {s2[pre + 'ms']:.4f} ms "
            f"(plain {s2[pre + 'plain_ms']:.4f} ms, bound "
            f"{s2[pre + 'bound_ms']:.4f} ms) [{gpu}]")
    for name in ("scan", "scan2"):
        log(f"  {name} at the tile of tandems and homopolymers: "
            f"{kt[name]['repeats_ms']:.4f} ms (random tile "
            f"{kt[name]['ms']:.4f} ms) [{gpu}]")
    for name, key in (("tile", "tile"), ("1024 x 1 kb batch", "reads")):
        sw = kt["sweeps_" + key]
        bounds = ", ".join(f"{b['bound_ms']:.4f}" for b in sw["bounds"])
        for lay in ("lane", "col"):
            r = sw[lay]
            each = ", ".join(f"{t:.4f}" for t in r["each_ms"])
            log(f"  {lay} sweeps of the {name} resolve: sweep 1 "
                f"{r['ms']:.4f} ms (host-paced {r['paced_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms); all {len(r['each_ms'])} "
                f"{r['all_ms']:.4f} ms ({each}); bounds {bounds} ms, sum "
                f"{sw['all_bound_ms']:.4f} ms [{gpu}]")
    w = kt["walk"]
    log(f"  walk at the tile: s=1000 {w['ms']:.4f} ms (plain "
        f"{w['plain_ms']:.4f} ms), s=1 {w['ms_s1']:.4f} ms (plain "
        f"{w['plain_ms_s1']:.4f} ms); 1-block walk {w['one_block_ms']:.4f} "
        f"ms (plain {w['one_block_plain_ms']:.4f} ms); successor-table pass "
        f"{w['succ_ms']:.4f} ms [{gpu}]")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "supersampler_tpu"))
    if bad:
        raise AssertionError(f"JAX-package modules were imported: {bad}")
    log("  no module of jax or supersampler_tpu was imported; "
        f"{time.perf_counter() - t_start:.1f} s in all")

    def entry(name, key, source, replaces, launches):
        r = kt[key]
        extra = {k: r[k] for k in ("all_sweeps_ms", "all_sweeps_bound_ms",
                                   "batch_ms", "batch_bound_ms",
                                   "batch_all_sweeps_ms", "repeats_ms",
                                   "ms_s1", "one_block_ms",
                                   "mesh_launches", "fof_launches",
                                   "dedup_launches", "oracle_launches")
                 if k in r}
        return {"name": name, "route": "cuda",
                "source": f"supersampler_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **extra}

    # launches: v1 kernels from the v1 bench run, v2 ones from the v2
    # bench run, the walk from the legacy bench run
    table = {"kernels": [
        entry("scan", "scan", "scan.cu",
              "supersampler_tpu/ops/scan_kernel.py:40", c1["scan"]),
        entry("scan2", "scan2", "scan.cu",
              "supersampler_tpu/ops/fused.py:78", c2["scan2"]),
        entry("sweep", "sweep", "sweep.cu",
              "supersampler_tpu/ops/field.py:444", c1["sweep"]),
        entry("sweep_col", "sweep_col", "sweep.cu",
              "supersampler_tpu/ops/field.py:444", c2["sweep"]),
        entry("walk", "walk", "walk.cu",
              "supersampler_tpu/ops/walker.py:72", c_legacy["walk"]),
    ]}
    print(gpu)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
