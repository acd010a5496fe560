#!/usr/bin/env python3
"""Where the two scan kernels' time goes, on one CUDA card.

    python3 chip_scan_probe.py [--seed N] [--against OTHER_scan.cu]

Builds supersampler_tpu_torch/csrc/scan.cu and timing-only variants of
it, each with its own nvcc (all started together) into
build/scan_probe/:
  * compute_only: every table value is computed (the v2 scan's also
    through its output tile), XORed into one word a thread and stored
    once (the table, sync and first-sync stores left out);
  * stage_only: the m-mer staging alone (no window minima: the
    election and the sync lookback read one staged value each);
  * store_only: the stores alone (no staging); store_only_c1 the v2
    scan's with clusters of 1 (every block writes its own lanes' part
    of each sector);
  * v2_cluster1, v2_cluster2, v2_cluster4, v2_cluster16: the v2 scan
    with clusters of 1, 2, 4 and 16 blocks in place of 8 (more or fewer
    sectors written in part at the clusters' ends);
  * v2_plain_stores: the v2 scan with plain stores in place of
    streaming ones;
  * v2_t256: the v2 scan with 256 threads a block (8 positions, 56
    values a thread).
With --against (another scan.cu with the same C interface, such as a
parent commit's) that file is built too, must give the kernel's outputs
bit for bit on every cell, v1 and v2, and is timed in turns with it
(other, kernel, kernel, other, twice). Inputs: the 4 Mbp tile of
chip_smoke.py, random and made of tandems and homopolymers
(tests/scan_cases.py), its first 2^22 positions (16,384 lanes, so that
every row of the v2 scan's tables starts on a 32-byte sector; the tile
has 16,386) and the 1,024 x 1 kb read batch, at k=31, m=11; each
variant times v1 and v2 on all four. ptxas's registers and the
v2 scan's dynamic shared memory are printed per build. Times are CUDA
events over 20 launches with the queue filled first
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
_LOOK = """        min_u64(min_u64(mt.suf_h[o], mt.pre_h[o + W - 1]),
                min_u64(mt.suf_h[o + W], mt.pre_h[o + 2 * W - 1]));"""
_INIT = ("    if (jloc == 0) write_init(init, rec, n_rec, "
         "elect_min(st, mt, o + W, W));\n")
_STAGE_ONLY = _COMPUTE_ONLY + (
    (_MINIMA, ""),
    ("    const Election e = elect_min(st, mt, o + W + 1, W);",
     "    const Election e = {st.canon[o], 0u, 0, st.hash[o + 1]};"),
    (_LOOK, "        st.hash[o];"),
    (_INIT, ""),
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

# the v2 scan's variants (patched after the marker below)
_V2 = "// The v2 scan: the same tables"
_V2_STORE = ("        __stcs(&outs[i][r * n_lanes + l0 + li], "
             "static_cast<int32_t>(x[i]));")
_V2_LEAD = ("      __stcs(&outs[i][r * n_lanes + l0 + c], "
            "static_cast<int32_t>(x[i]));")
_V2_PLAIN_STORES = (
    (_V2_STORE,
     "        outs[i][r * n_lanes + l0 + li] = static_cast<int32_t>(x[i]);"),
    (_V2_LEAD,
     "      outs[i][r * n_lanes + l0 + c] = static_cast<int32_t>(x[i]);"),
)
_V2_COMPUTE_ONLY = (
    (_V2_STORE, "        acc ^= x[i];"),
    (_V2_LEAD + "\n  }\n}",
     "      acc ^= x[i];\n  }\n  if (j0 + t < P) h_hi[j0 + t] = acc;\n}"),
    ("  if (rank > 0) return;",
     "  if (j0 + t < P) h_hi[j0 + t] = acc;\n  if (rank > 0) return;"),
    ("    fs[l0 + t] = f;", "    acc ^= f;"),
    ("  int32_t* const outs[7] = {h_hi, h_lo, cv, em, ep, eh_hi, eh_lo};\n",
     ""),
    ("  const int nl = left < kLanes ? static_cast<int>(left) : kLanes;\n",
     "  const int nl = left < kLanes ? static_cast<int>(left) : kLanes;\n"
     "  uint32_t acc = 0;\n"),
)
_V2_MINIMA = ("  const MinTabs mt =\n      window_minima(work + "
              "align8(stage_bytes(n_mm, m)), st.hash, n_mm, W);\n")
_V2_STAGE_ONLY = _V2_COMPUTE_ONLY + (
    (_V2_MINIMA, ""),
    ("      const Election e = elect_min(st, mt, o + W + 1, W);",
     "      const Election e = {st.canon[o], 0u, 0, st.hash[o + 1]};"),
    ("""          min_u64(min_u64(mt.suf_h[o], mt.pre_h[o + W - 1]),
                  min_u64(mt.suf_h[o + W], mt.pre_h[o + 2 * W - 1]));""",
     "          st.hash[o];"),
    ("        write_init(init, rec, n_rec, elect_min(st, mt, o + W, W));",
     "        ;"),
)
# the kernel's stores (the same sectors, the cluster's ends in part)
_V2_STORE_BODY = """  const int t = threadIdx.x;
  const int64_t left = n_lanes - l0;
  const int nl = left < kLanes ? static_cast<int>(left) : kLanes;
  if (t < nl) fs[l0 + t] = kT;
  int32_t* const outs[7] = {h_hi, h_lo, cv, em, ep, eh_hi, eh_lo};
  const int64_t e0 = static_cast<int64_t>(
                         reinterpret_cast<uintptr_t>(h_hi) / 4) + l0;
  const unsigned rank = cluster.block_rank();
  const bool next = rank + 1 < kCluster;
  for (int q = 0; q < kLanes * kT / kT2; ++q) {
    const int f = q * kT2 + t;
    const int r = f / kLanes, c = f % kLanes;
    const int a = static_cast<int>(-(e0 + r * n_lanes) & (kLanes - 1));
    const int li = a + c;
    if (li < kLanes ? li < nl : next && l0 + li < n_lanes)
      for (int i = 0; i < 7; ++i)
        __stcs(&outs[i][r * n_lanes + l0 + li], f ^ i);
  }
  if (rank > 0) return;
  __syncthreads();
  for (int q = 0; q < kLanes * kT / kT2; ++q) {
    const int f = q * kT2 + t;
    const int r = f / kLanes, c = f % kLanes;
    const int a = static_cast<int>(-(e0 + r * n_lanes) & (kLanes - 1));
    if (c < nl && c < a)
      for (int i = 0; i < 7; ++i)
        __stcs(&outs[i][r * n_lanes + l0 + c], f ^ i);
  }
}

"""


def patch(src: str, pairs, v2: bool = False) -> str:
    """Each (old, new) replaced in the v1 part of scan.cu (before the v2
    scan) or, with v2, in the v2 part; raises if old is not there."""
    cut = src.index(_V2)
    head, tail = src[:cut], src[cut:]
    for old, new in pairs:
        part = tail if v2 else head
        if old not in part:
            raise RuntimeError(f"scan.cu no longer holds {old[:60]!r}")
        part = part.replace(old, new)
        head, tail = (head, part) if v2 else (part, tail)
    return head + tail


def store_only(src: str) -> str:
    a = src.index("  const Stage st = stage_mmers(smem, packed, P, j0 - W")
    b = src.index(_V2)
    src = src[:a] + _STORE_BODY + src[b:]
    a = src.index("  // warp_fs[o / 32]")
    b = src.index("}  // namespace")
    return src[:a] + _V2_STORE_BODY + src[b:]


_ATTR = """  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks"""


def v2_shape(src: str, threads: int = 512, blocks: int = 2,
             cluster: int = 8) -> str:
    """The v2 scan with another number of threads a block (compiled for
    `blocks` resident blocks an SM) or of blocks a cluster (past 8, the
    portable size, with the attribute that allows it)."""
    pairs = [("constexpr int kT2 = 512;", f"constexpr int kT2 = {threads};"),
             ("constexpr int kScan2Blocks = 1024 / kT2;",
              f"constexpr int kScan2Blocks = {blocks};"),
             ("constexpr int kCluster = 8;",
              f"constexpr int kCluster = {cluster};")]
    src = patch(src, pairs)
    if cluster <= 8:
        return src
    return patch(src, ((_ATTR, _ATTR.replace("  const int64_t blocks", (
        "  const cudaError_t e2 = cudaFuncSetAttribute(scan2_kernel, "
        "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
        "  if (e2 != cudaSuccess) return static_cast<int>(e2);\n"
        "  const int64_t blocks"))),), v2=True)


def smem2(k: int = CS.K, m: int = CS.M) -> int:
    """The v2 scan's dynamic shared memory (csrc/scan.cu
    scan2_smem_bytes)."""
    n_mm = 8 * 256 + 2 * (k - m + 1)
    stage = -(-(n_mm * 14 + m) // 8) * 8
    return 256 + max(stage + 24 * n_mm, 256 * 17 * 16)


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


def scan2(lib, packed, P_rec: int, k=CS.K, m=CS.M):
    P = packed.numel() * 4
    out = [torch.empty(P, dtype=torch.int32, device="cuda")
           for _ in range(7)]
    out += [torch.empty(P // 256, dtype=torch.int32, device="cuda"),
            torch.empty((4, P // P_rec), dtype=torch.int32, device="cuda")]
    _build.check(lib.spsp_scan2(
        packed.data_ptr(), P, P_rec, k, m, *(t.data_ptr() for t in out),
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
               "compute_only": patch(patch(src, _COMPUTE_ONLY),
                                     _V2_COMPUTE_ONLY, v2=True),
               "stage_only": patch(patch(src, _STAGE_ONLY),
                                   _V2_STAGE_ONLY, v2=True),
               "store_only": store_only(src),
               "store_only_c1": v2_shape(store_only(src), cluster=1),
               "v2_cluster1": v2_shape(src, cluster=1),
               "v2_cluster2": v2_shape(src, cluster=2),
               "v2_cluster4": v2_shape(src, cluster=4),
               "v2_cluster16": v2_shape(src, cluster=16),
               "v2_plain_stores": patch(src, _V2_PLAIN_STORES, v2=True),
               "v2_t256": v2_shape(src, threads=256)}
    if args.against:
        with open(args.against) as f:
            sources["other"] = f.read()
    libs = build(sources)
    print(f"  v2 scan dynamic shared memory at (k, m) = ({CS.K}, {CS.M}): "
          f"{smem2()} B", flush=True)

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
    P8 = 1 << 22  # 16,384 lanes: every row starts on a 32-byte sector
    li8 = torch.tensor([P8 - CS.K - 1], dtype=torch.int32, device="cuda")
    cells = {"tile": (CS.pack_codes(tile, "cuda"), P, li),
             "tile 2^22": (CS.pack_codes(tile[:P8], "cuda"), P8, li8),
             "repeats tile": (CS.pack_codes(rep, "cuda"), P, li),
             "batch": (CS.pack_codes(reads.reshape(-1), "cuda"), P_rec,
                       torch.from_numpy(lens - (CS.K + 1)).to("cuda"))}
    if args.against:
        for cell, (pk, pr, lst) in cells.items():
            if CS.max_abs_err(scan(libs["other"], pk, pr, lst),
                              scan(libs["kernel"], pk, pr, lst)):
                raise AssertionError(f"other != kernel on the {cell}")
            if CS.max_abs_err(scan2(libs["other"], pk, pr),
                              scan2(libs["kernel"], pk, pr)):
                raise AssertionError(f"other != kernel: v2 scan, {cell}")
        print("  other == kernel on every output of both scans, every cell",
              flush=True)
    shapes = [n for n in libs if n.startswith("v2_")]
    stores = [n for n in libs if n.startswith("store_only")]
    for name in shapes:
        for cell, (pk, pr, _lst) in cells.items():
            if CS.max_abs_err(scan2(libs[name], pk, pr),
                              scan2(libs["kernel"], pk, pr)):
                raise AssertionError(f"{name} != kernel: v2 scan, {cell}")
    print(f"  {', '.join(shapes)} == kernel on every cell", flush=True)
    order = (["other", "kernel", "kernel", "other"] * 2 if args.against
             else ["kernel"]) + ["compute_only", "stage_only", *stores,
                                 *shapes, "kernel"]
    for name in order:
        lib = libs[name]
        t1 = [f"{c} {CS.cuda_ms(lambda: scan(lib, pk, pr, lst), 20):.4f}"
              for c, (pk, pr, lst) in cells.items()]
        t2 = [f"{c} {CS.cuda_ms(lambda: scan2(lib, pk, pr), 20):.4f}"
              for c, (pk, pr, _lst) in cells.items()]
        print(f"  {name:12s} ms: v1 {', '.join(t1)}; v2 {', '.join(t2)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
