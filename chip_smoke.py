#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (supersampler_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing its result; any failure exits non-zero:
  0. device: the card's name and power limit (nvidia-smi);
  1. build: nvcc builds the scan, sweep and walk kernels from csrc/, one
     process per source, all started together;
  2. kernels against their plain PyTorch versions on the card, bit-equal
     (integer outputs, tolerance 0): the scan on a full 4 Mbp tile at
     (k, m) = (31, 11), (63, 15), (15, 5) and on a 1,024 x 1 kb read
     batch; every sweep of that tile's resolve and of the read batch's
     resolve; the walk over a full tile's successor words at s = 1000
     and s = 1, and over the next tile entered from its carry. Kernel
     and plain times come from CUDA events, as does the time of the
     successor-table pass at the tile;
  3. goldens: the 10 tests/golden sketches, and the CLI's compressed
     output and stdout, from sketches made on the card; the 10 again
     through the exact engine (scan_engine = "legacy");
  4. real size: a 5 Mbp genome (two tiles) and 2,000 x 1 kb reads give
     the same bytes on the card and on the CPU; a desert corpus (a
     12 Mbp record with a 3 kb poly-T in tile 1, a 100 kb record with a
     3 kb poly-A, 2,000 x 1 kb reads among 20 desert records) falls back
     to the walker on every route and gives the same bytes on the card,
     on the CPU and through the legacy engine on the card; the bench
     corpus (8 x 4,194,000 bp, 10,000 x 1 kb reads, k=31, m=11, s=1000)
     runs through the CLI on the card, and its genome again through the
     legacy engine, whose sketch must hash the same. Each of these
     paths runs with the launch counters reset before and read after.
The line before the last is the kernel table; the last line is
{"ok": true, "device": {...}}. Needs one CUDA card; no network.
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
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

TILE_P = (1 << 22) + 512          # one 4 Mbp tile: own + extra positions
TILE_L = 4_194_000                # the bench corpus's record length
K, M, S = 31, 11, 1000.0
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn on the current stream."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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
    version on the same inputs, requires bit-equality and returns the
    kernel's result."""

    def __init__(self):
        self.n = 0
        self.first = None
        self.max_abs_err = 0

    def __call__(self, tabs, se, st0, *rest):
        from supersampler_tpu_torch.ops.field import sweep_kernel, sweep_plain

        got = sweep_kernel(tabs, se, st0, *rest)
        err = max_abs_err(got, sweep_plain(tabs, se, st0, *rest))
        if err:
            raise AssertionError(f"sweep {self.n}: kernel != plain "
                                 f"(max_abs_err {err})")
        self.max_abs_err = max(self.max_abs_err, err)
        if self.first is None:
            self.first = (tabs, se.clone(), st0.clone(), rest)
        self.n += 1
        return got


def check_scan(packed, k, m, P_rec, last_i) -> int:
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel, scan_plain

    err = max_abs_err(scan_kernel(packed, k, m, P_rec, last_i),
                      scan_plain(packed, k, m, P_rec, last_i))
    if err:
        raise AssertionError(f"scan kernel != plain at (k, m) = ({k}, {m}),"
                             f" P_rec={P_rec}: max_abs_err {err}")
    return err


def time_pair(kernel_fn, plain_fn, iters=(20, 3)):
    return cuda_ms(kernel_fn, iters[0]), cuda_ms(plain_fn, iters[1])


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
    res = {"scan": {}, "sweep": {}}

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
    if timing:
        res["scan"]["ms"], res["scan"]["plain_ms"] = time_pair(
            lambda: scan_kernel(packed, K, M, tile_p, last_i),
            lambda: scan_plain(packed, K, M, tile_p, last_i))

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
    if timing:
        tabs, se, st0, rest = chk.first
        res["sweep"]["ms"], res["sweep"]["plain_ms"] = time_pair(
            lambda: F.sweep_kernel(tabs, se, st0, *rest),
            lambda: F.sweep_plain(tabs, se, st0, *rest))

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
    res["sweep"]["max_abs_err"] = max(chk.max_abs_err, bchk.max_abs_err)
    log(f"  scan and all {bchk.n} sweeps on the {n_reads} x 1 kb batch: "
        f"kernel == plain, bit-equal (status {int(got[0])}, "
        f"n_sel {int(got[1])}; max_abs_err scan {err}, sweep "
        f"{bchk.max_abs_err})")
    if timing:
        li = lengths - (K + 1)
        tabs, se, st0, rest = bchk.first
        res["scan_reads"] = dict(zip(("ms", "plain_ms"), time_pair(
            lambda: scan_kernel(bpacked, K, M, P_rec, li),
            lambda: scan_plain(bpacked, K, M, P_rec, li))))
        res["sweep_reads"] = dict(zip(("ms", "plain_ms"), time_pair(
            lambda: F.sweep_kernel(tabs, se, st0, *rest),
            lambda: F.sweep_plain(tabs, se, st0, *rest))))
    return res


def phase_walk(rng, device, tile_p=TILE_P, timing=True):
    """Phase 2, walk: the kernel against walk_plain over the successor
    words of a full tile and of the next tile (entered from the first's
    carry), at s = 1000 and s = 1. Returns {max_abs_err, ms, plain_ms,
    ms_s1, plain_ms_s1, succ_ms} (times at the first tile)."""
    from supersampler_tpu_torch.ops import walker as TW
    from supersampler_tpu_torch.ops.minimizer import pack_2bit, succ_tables
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
            got = TW.walk_kernel(words, init5)
            err = max_abs_err(got, TW.walk_plain(words, init5))
            if err:
                raise AssertionError(f"walk kernel != plain at s={s}, tile "
                                     f"{t}: max_abs_err {err}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            log(f"  walk kernel == plain at s={s:g}, tile {t} "
                f"({'entered from the carry' if t else 'window-0 entry'}): "
                f"{int(got[4][0])} events, {int(got[3].sum())} emits, "
                f"bit-equal (max_abs_err {err})")
            if t == 0 and timing:
                res["ms" + key], res["plain_ms" + key] = time_pair(
                    lambda: TW.walk_kernel(words, init5),
                    lambda: TW.walk_plain(words, init5), (20, 1))
                if not key:
                    res["succ_ms"] = cuda_ms(
                        lambda: succ_tables(tabs, init[:, 0], K, M, L_t,
                                            *thr_w), 5)
            init5, fb = TW._carry_next(got[4], tab, fb, own)
    return res


def phase_goldens(device, workdir, engine="field") -> None:
    """Phase 3: the golden sketches, and for the field engine the CLI,
    sketched on device."""
    import importlib.util

    from supersampler_tpu_torch.cli import sub_sampler as cli
    from supersampler_tpu_torch.sketch import TorchSubsampler

    # by path: an installed package named "tests" would shadow ours
    spec = importlib.util.spec_from_file_location(
        "make_data", os.path.join(ROOT, "tests", "make_data.py"))
    make_data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_data)
    gold = os.path.join(ROOT, "tests", "golden")
    data = make_data.make_all(os.path.join(workdir, "data"))
    with open(os.path.join(gold, "meta.json")) as f:
        meta = json.load(f)
    for cfg in meta["sketches"]:
        with gzip.open(os.path.join(gold, cfg["file"]), "rb") as f:
            want = f.read()
        ss = TorchSubsampler(k=cfg["k"], m=cfg["m"],
                             s=float(np.float32(cfg["s"])),
                             abundance=cfg["a"], device=device)
        ss.scan_engine = engine
        if ss.sketch_file(data[cfg["dataset"]]) != want:
            raise AssertionError(f"golden {cfg['file']} differs "
                                 f"({engine} engine)")
    log(f"  all {len(meta['sketches'])} golden sketches equal ({engine} "
        f"engine)")
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
    log("  CLI -i simple -s 10: cli_simple.gz bytes and stdout equal")


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


def reset_launches() -> None:
    from supersampler_tpu_torch.ops.field import sweep_kernel
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel
    from supersampler_tpu_torch.ops.walker import walk_kernel

    scan_kernel.launches = sweep_kernel.launches = walk_kernel.launches = 0


def read_launches() -> dict:
    from supersampler_tpu_torch.ops.field import sweep_kernel
    from supersampler_tpu_torch.ops.scan_kernel import scan_kernel
    from supersampler_tpu_torch.ops.walker import walk_kernel

    return {"scan": scan_kernel.launches, "sweep": sweep_kernel.launches,
            "walk": walk_kernel.launches}


def phase_desert(rng, device, workdir, long_len=12_000_000, single_len=100_000, n_reads=2000,
                 n_deserts=20) -> None:
    """Phase 4: records the field resolve cannot settle, on all three
    routes. The field engine on the card must fall back on each route
    and give the bytes of the CPU and of the legacy engine on the card."""
    from supersampler_tpu_torch.sketch import TorchSubsampler

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
    bases = write_fasta(path, recs + [single, long_rec], b"d", width=80)
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
    if not out["card"] == out["cpu"] == out["card legacy"]:
        raise AssertionError("desert corpus: card, cpu and legacy bytes "
                             "differ")
    log(f"  desert corpus: card == cpu == card legacy bytes "
        f"({len(out['cpu'])} B)")


def check_sketch(raw: bytes) -> None:
    """A sketch starts '<2k-m> <m> <selected k-mers> <s>' and has
    buckets after it."""
    head, _, body = raw.partition(b"\n")
    f = head.split()
    if (len(f) != 4 or int(f[0]) != 2 * K - M or int(f[1]) != M
            or int(f[2]) <= 0 or not body):
        raise AssertionError(f"malformed sketch header {head[:80]!r}")


def phase_bench(rng, workdir, n_rec=8, glen=TILE_L, n_reads=10_000):
    """Phase 4b: the bench corpus through the CLI on the card; the
    kernels' launch counters are reset just before and read after.
    Returns (launch counts, genome path, its bases, its sketch
    sha256)."""
    from supersampler_tpu_torch.cli import sub_sampler as cli

    genome = os.path.join(workdir, "bench_genome.fa")
    reads = os.path.join(workdir, "bench_reads.fa")
    g_bases = write_fasta(
        genome, rng.integers(0, 4, (n_rec, glen), dtype=np.uint8), b"chr")
    r_bases = write_fasta(
        reads, rng.integers(0, 4, (n_reads, 1000), dtype=np.uint8), b"q")
    cwd = os.getcwd()
    os.chdir(workdir)
    reset_launches()
    walls = {}
    try:
        for path, bases in ((genome, g_bases), (reads, r_bases)):
            t0 = time.perf_counter()
            with redirect_stdout(io.StringIO()):
                rc = cli.main(["-i", path, "-k", str(K), "-m", str(M),
                               "-s", "1000", "-p", "out_"])
            walls[path] = (time.perf_counter() - t0, bases, rc)
    finally:
        os.chdir(cwd)
    counts = read_launches()
    gpu = gpu_line()
    shas = {}
    for path, (wall, bases, rc) in walls.items():
        out = os.path.join(workdir, "out_" + os.path.basename(path)
                           .rsplit(".", 1)[0] + ".gz")
        with open(out, "rb") as f:
            gz = f.read()
        if rc != 0:
            raise AssertionError(f"CLI rc {rc} on {path}")
        check_sketch(gzip.decompress(gz))
        shas[path] = hashlib.sha256(gz).hexdigest()
        log(f"  {os.path.basename(path)}: {bases} bases, wall {wall:.3f} s,"
            f" {bases / 1e6 / wall:.1f} Mbases/s, sketch sha256 "
            f"{shas[path]} [{gpu}]")
    log(f"  launches in this run: scan {counts['scan']}, "
        f"sweep {counts['sweep']}, walk {counts['walk']} [{gpu}]")
    if min(counts["scan"], counts["sweep"]) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{counts}")
    return counts, genome, g_bases, shas[genome]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from supersampler_tpu_torch.ops import _build

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

    log("[2] kernels vs plain on the card")
    kt = phase_kernels(rng, "cuda")
    kt["walk"] = phase_walk(rng, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        log("[3] goldens on the card")
        phase_goldens("cuda", tmp)
        phase_goldens("cuda", tmp, engine="legacy")
        log("[4] real size")
        phase_cpu_parity(rng, "cuda", tmp)
        phase_desert(rng, "cuda", tmp)
        counts, *bench_genome = phase_bench(rng, tmp)
        counts["walk"] = phase_bench_legacy("cuda", tmp,
                                            *bench_genome)["walk"]
    for name, key in (("tile", ""), ("1024 x 1 kb batch", "_reads")):
        log(f"  times at the {name}: scan {kt['scan' + key]['ms']:.4f} ms "
            f"(plain {kt['scan' + key]['plain_ms']:.4f} ms), sweep "
            f"{kt['sweep' + key]['ms']:.4f} ms (plain "
            f"{kt['sweep' + key]['plain_ms']:.4f} ms) [{gpu}]")
    w = kt["walk"]
    log(f"  walk at the tile: s=1000 {w['ms']:.4f} ms (plain "
        f"{w['plain_ms']:.4f} ms), s=1 {w['ms_s1']:.4f} ms (plain "
        f"{w['plain_ms_s1']:.4f} ms); successor-table pass "
        f"{w['succ_ms']:.4f} ms [{gpu}]")
    table = {"kernels": [
        {"name": "scan", "route": "cuda",
         "source": "supersampler_tpu_torch/csrc/scan.cu",
         "replaces": "supersampler_tpu/ops/scan_kernel.py:40",
         "launches": counts["scan"],
         "max_abs_err": kt["scan"]["max_abs_err"],
         "ms": kt["scan"]["ms"], "plain_ms": kt["scan"]["plain_ms"]},
        {"name": "sweep", "route": "cuda",
         "source": "supersampler_tpu_torch/csrc/sweep.cu",
         "replaces": "supersampler_tpu/ops/field.py:444",
         "launches": counts["sweep"],
         "max_abs_err": kt["sweep"]["max_abs_err"],
         "ms": kt["sweep"]["ms"], "plain_ms": kt["sweep"]["plain_ms"]},
        {"name": "walk", "route": "cuda",
         "source": "supersampler_tpu_torch/csrc/walk.cu",
         "replaces": "supersampler_tpu/ops/walker.py:72",
         "launches": counts["walk"], "max_abs_err": w["max_abs_err"],
         "ms": w["ms"], "plain_ms": w["plain_ms"]},
    ]}
    print(gpu)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
