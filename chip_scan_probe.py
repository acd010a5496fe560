#!/usr/bin/env python3
"""Where the v1 scan kernel's time goes, on one CUDA card.

    python3 chip_scan_probe.py [--seed N] [--against OTHER_scan.cu]

Builds supersampler_tpu_torch/csrc/scan.cu and three timing-only
variants of it, each with its own nvcc (all started together) into
build/scan_probe/:
  * compute_only: every table value is computed, XORed into one word a
    thread and stored once (the stores of seven tables and the sync
    bytes left out);
  * stage_only: the m-mer staging alone (no window minima: the
    election and the sync lookback read one staged value each);
  * store_only: the stores alone (no staging).
With --against (another scan.cu with the same C interface, such as a
parent commit's) that file is built too, must give the kernel's outputs
bit for bit, and is timed in turns with it (other, kernel, kernel,
other, twice). Inputs: the 4 Mbp tile of chip_smoke.py, random and made
of tandems and homopolymers (tests/scan_cases.py), and the 1,024 x 1 kb
read batch, at k=31, m=11; the v2 scan at the tile as well. Times are
CUDA events over 20 launches with the queue filled first
(chip_smoke.cuda_ms). Needs nvcc and one card; no network.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as CS
from supersampler_tpu_torch.ops import _build

SRC = os.path.join(CS.ROOT, "supersampler_tpu_torch", "csrc", "scan.cu")
OUT = os.path.join(CS.ROOT, "build", "scan_probe")

_STORES = """    h_hi[j] = static_cast<int32_t>(h0 >> 32);
    h_lo[j] = static_cast<int32_t>(h0);
    cv[j] = static_cast<int32_t>(
        st.canon[o + 2 * W] |
        (static_cast<uint32_t>(st.rev[o + 2 * W]) << 30));
    const Election e = elect_min(st, mt, o + W + 1, W);
    em[j] = static_cast<int32_t>(e.mini | (e.rev << 30));
    ep[j] = e.pos;
    eh_hi[j] = static_cast<int32_t>(e.hash >> 32);
    eh_lo[j] = static_cast<int32_t>(e.hash);
"""
_XOR = """    const Election e = elect_min(st, mt, o + W + 1, W);
    acc ^= static_cast<uint32_t>(h0 >> 32) ^ static_cast<uint32_t>(h0) ^
           st.canon[o + 2 * W] ^ (e.mini | (e.rev << 30)) ^ e.pos ^
           static_cast<uint32_t>(e.hash >> 32) ^
           static_cast<uint32_t>(e.hash);
"""
_COMPUTE_ONLY = (
    (_STORES, _XOR),
    ("    sync[j] = jloc >= 2 * W && jloc <= last_i[rec] && h0 < look;",
     "    acc ^= jloc >= 2 * W && jloc <= last_i[rec] && h0 < look;"),
    ("#pragma unroll\n  for (int q = 0; q < kScanT / kT; ++q) {",
     "  uint32_t acc = 0;\n  for (int q = 0; q < kScanT / kT; ++q) {"),
    ("      ++rec;\n    }\n  }\n}",
     "      ++rec;\n    }\n  }\n  if (j0 + t < P) h_hi[j0 + t] = acc;\n}"),
)
_MINIMA = ("  const MinTabs mt =\n      window_minima(smem + "
           "align8(stage_bytes(n_mm, m)), st.hash, n_mm, W);\n")
_STAGE_ONLY = _COMPUTE_ONLY + (
    (_MINIMA, ""),
    ("    const Election e = elect_min(st, mt, o + W + 1, W);",
     "    const Election e = {st.canon[o], 0u, 0, st.hash[o + 1]};"),
    ("""        min_u64(min_u64(mt.suf_h[o], mt.pre_h[o + W - 1]),
                min_u64(mt.suf_h[o + W], mt.pre_h[o + 2 * W - 1]));""",
     "        st.hash[o];"),
    ("    if (jloc == 0) write_init(init, rec, n_rec, "
     "elect_min(st, mt, o + W, W));\n", ""),
)
_STORE_BODY = """  const int t = threadIdx.x;
  for (int q = 0; q < kScanT / kT; ++q) {
    const int64_t j = j0 + t + q * kT;
    if (j >= P) break;
    const int32_t v = static_cast<int32_t>(j);
    h_hi[j] = h_lo[j] = cv[j] = em[j] = ep[j] = eh_hi[j] = eh_lo[j] = v;
    sync[j] = v & 1;
  }
}

"""


def patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"scan.cu no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    return src


def store_only(src: str) -> str:
    a = src.index("  const Stage st = stage_mmers(smem, packed, P, j0 - W")
    b = src.index("// The v2 scan: the same tables")
    return src[:a] + _STORE_BODY + src[b:]


def build(sources: dict) -> dict:
    """{name: source text} -> {name: ctypes library}, one nvcc each."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o",
             os.path.join(OUT, name + ".so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    V, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [x.split("Used", 1)[1].strip() for x in log.splitlines()
                if "Used" in x]
        print(f"  built {name}: ptxas scan2, scan: {regs}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.spsp_scan.argtypes = [V, I64, I64, I, I, V] + [V] * 10
        lib.spsp_scan2.argtypes = [V, I64, I64, I, I] + [V] * 10
        libs[name] = lib
    return libs


def scan(lib, packed, P_rec: int, last_i, k=CS.K, m=CS.M):
    P = packed.numel() * 4
    out = [torch.empty(P, dtype=torch.int32, device="cuda")
           for _ in range(7)]
    out += [torch.empty(P, dtype=torch.bool, device="cuda"),
            torch.empty((4, P // P_rec), dtype=torch.int32, device="cuda")]
    _build.check(lib.spsp_scan(
        packed.data_ptr(), P, P_rec, k, m, last_i.data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream), "spsp_scan")
    return out


def scan2(lib, packed):
    P = packed.numel() * 4
    out = [torch.empty(P, dtype=torch.int32, device="cuda")
           for _ in range(7)]
    out += [torch.empty(P // 256, dtype=torch.int32, device="cuda"),
            torch.empty((4, 1), dtype=torch.int32, device="cuda")]
    _build.check(lib.spsp_scan2(
        packed.data_ptr(), P, P, CS.K, CS.M, *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream), "spsp_scan2")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", help="another scan.cu to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_scan_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    print(CS.gpu_line(), flush=True)
    with open(SRC) as f:
        src = f.read()
    sources = {"kernel": src,
               "compute_only": patch(src, _COMPUTE_ONLY),
               "stage_only": patch(src, _STAGE_ONLY),
               "store_only": store_only(src)}
    if args.against:
        with open(args.against) as f:
            sources["other"] = f.read()
    libs = build(sources)

    rng = np.random.default_rng(args.seed)
    P, L = CS.TILE_P, CS.TILE_L
    tile = np.zeros(P, np.uint8)
    tile[:L] = rng.integers(0, 4, L, dtype=np.uint8)
    rep = np.zeros(P, np.uint8)
    rep[:L] = CS.load_tests_module("scan_cases").tile_codes(args.seed, L)
    P_rec, n = 2048, 1024
    lens = rng.integers(900, 1001, n).astype(np.int32)
    reads = np.zeros((n, P_rec), np.uint8)
    for i, x in enumerate(lens):
        reads[i, :x] = rng.integers(0, 4, x, dtype=np.uint8)
    li = torch.tensor([L - CS.K - 1], dtype=torch.int32, device="cuda")
    cells = {"tile": (CS.pack_codes(tile, "cuda"), P, li),
             "repeats tile": (CS.pack_codes(rep, "cuda"), P, li),
             "batch": (CS.pack_codes(reads.reshape(-1), "cuda"), P_rec,
                       torch.from_numpy(lens - (CS.K + 1)).to("cuda"))}
    if args.against:
        for cell, (pk, pr, lst) in cells.items():
            err = CS.max_abs_err(scan(libs["other"], pk, pr, lst),
                                 scan(libs["kernel"], pk, pr, lst))
            if err:
                raise AssertionError(f"other != kernel on the {cell}")
        if CS.max_abs_err(scan2(libs["other"], cells["tile"][0]),
                          scan2(libs["kernel"], cells["tile"][0])):
            raise AssertionError("other != kernel: v2 scan at the tile")
        print("  other == kernel on every output", flush=True)
    order = (["other", "kernel", "kernel", "other"] * 2 if args.against
             else ["kernel"]) + ["compute_only", "stage_only", "store_only"]
    for name in order:
        lib = libs[name]
        times = [f"{cell} {CS.cuda_ms(lambda: scan(lib, pk, pr, lst), 20):.4f}"
                 for cell, (pk, pr, lst) in cells.items()]
        v2 = CS.cuda_ms(lambda: scan2(lib, cells["tile"][0]), 20)
        print(f"  {name:12s} ms: {', '.join(times)}; v2 scan tile {v2:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
