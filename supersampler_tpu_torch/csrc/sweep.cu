// Field sweep kernel: the reference streaming machine over 256-position
// lanes, emitting each lane's selected-boundary list.
//
// Replaces the TPU kernel supersampler_tpu/ops/field.py _sweep_kernel
// (launched by _sweep_pallas, dispatched by _run_sweep from
// resolve_field and resolve_field_batched, and by ops/fused.py's
// _sweep_blocks in its tab3d mode). Its plain twin is sweep_plain
// (ops/field.py of this package).
//
// Two table layouts, a template parameter: "lane" (flat, column r of
// lane l at l*256 + r, what spsp_scan writes) and "col" ((256, n), at
// r*n + l, what spsp_scan2 writes: the counterpart of tab3d).
//
// What it computes, per lane l over its columns r in [start, end) while
// j = j0 + r <= lastiv (reference SubSampler.cpp:367-440):
//   * adopt when the entering hash is strictly below the held hash (or
//     at r == start when the entry is forced: the sync theorem's entry);
//   * otherwise rescan when the held minimizer expires (j >= p), taking
//     the window election;
//   * every event records the FHS select bit (hash <= threshold) in bit
//     31 of the held value, and a selected held value that an event
//     closes appends (pos, prev payload, prev last+1) to the lane's list
//     (entry events excluded: the caller synthesizes them). The count
//     runs on past capl so the caller detects overflow.
// Outputs: exit state (7, lanes) = val, h_hi, h_lo, p, last_ev, n_ev,
// cnt; lists pos/pval/plast (capl, lanes), zero past cnt.
//
// What bounds it on the H100: serial latency per lane. A 4 Mbp tile has
// about 16k lanes, so the card is under-occupied (some 120 threads per
// SM), and a lane's 256 columns form one dependent chain of table reads
// and compares. In the lane layout a warp's reads are strided by 256
// positions, which wastes sector bandwidth; in the column layout they
// are contiguous.
//
// What the design does about it: one thread per lane that loops over
// its own columns, skips a column's election reads unless an event
// fires, and stops at the lane's bound, so inactive lanes and the empty
// prefix sweeps cost almost nothing; the first column read of each
// 32-byte sector brings the next seven columns into L1. The TPU's
// VMEM-vector workarounds (a select loop over capl, column-chunk skips)
// have no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 256;        // positions per lane
constexpr int kThreads = 128;  // lanes per block

__host__ __device__ __forceinline__ uint64_t join(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

template <bool kCol>
__global__ void sweep_kernel(
    const uint32_t* __restrict__ hh, const uint32_t* __restrict__ hl,
    const uint32_t* __restrict__ cv, const uint32_t* __restrict__ em,
    const int32_t* __restrict__ ep, const uint32_t* __restrict__ ehh,
    const uint32_t* __restrict__ ehl, const int32_t* __restrict__ se,
    const int32_t* __restrict__ st0, uint64_t thr, int n, int W, int capl,
    int force_entry, int32_t* __restrict__ xs, int32_t* __restrict__ lp,
    int32_t* __restrict__ lv, int32_t* __restrict__ ll) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  for (int c = 0; c < capl; ++c) {
    const size_t o = static_cast<size_t>(c) * n + l;
    lp[o] = 0;
    lv[o] = 0;
    ll[o] = 0;
  }
  const int start = se[l];
  const int end = min(se[n + l], kB);
  const bool active = se[2 * n + l] != 0;
  const int j0 = se[3 * n + l];
  const int lastiv = se[4 * n + l];
  uint32_t val = static_cast<uint32_t>(st0[l]);
  uint64_t h = join(st0[n + l], st0[2 * n + l]);
  int p = st0[3 * n + l];
  int last_ev = st0[4 * n + l];
  int n_ev = st0[5 * n + l];
  int cnt = 0;

  if (active) {
    // column r of lane l sits at base + r * stride
    const size_t base = kCol ? l : static_cast<size_t>(l) * kB;
    const size_t stride = kCol ? n : 1;
    for (int r = max(start, 0); r < end; ++r) {
      const int j = j0 + r;
      if (j > lastiv) break;
      const size_t idx = base + r * stride;
      const uint64_t nh = join(hh[idx], hl[idx]);
      const bool is_entry = force_entry && r == start;
      const bool adopt = nh < h || is_entry;
      if (!adopt && j < p) continue;  // no event at j
      const uint64_t new_h = adopt ? nh : join(ehh[idx], ehl[idx]);
      const uint32_t sel = new_h <= thr;
      const uint32_t new_val = (adopt ? cv[idx] : em[idx]) | (sel << 31);
      const int new_p = adopt ? j + W : ep[idx] + j + 1;
      if ((val >> 31) && !is_entry) {
        if (cnt < capl) {
          const size_t o = static_cast<size_t>(cnt) * n + l;
          lp[o] = j;
          lv[o] = static_cast<int32_t>(val);
          ll[o] = last_ev + 1;
        }
        ++cnt;
      }
      val = new_val;
      h = new_h;
      p = new_p;
      last_ev = j;
      ++n_ev;
    }
  }
  xs[l] = static_cast<int32_t>(val);
  xs[n + l] = static_cast<int32_t>(h >> 32);
  xs[2 * n + l] = static_cast<int32_t>(h);
  xs[3 * n + l] = p;
  xs[4 * n + l] = last_ev;
  xs[5 * n + l] = n_ev;
  xs[6 * n + l] = cnt;
}

}  // namespace

// Tables: n*256 entries each; col == 0: lane l owns [l*256, (l+1)*256),
// col != 0: (256, n) row-major, column r of lane l at r*n + l. se
// (5, n) = start, end, active, j0, lastiv; st0 (6, n) = val, h_hi, h_lo,
// p, last_ev, n_ev. Outputs xs (7, n) and lp/lv/ll (capl, n).
extern "C" int spsp_sweep(const uint32_t* hh, const uint32_t* hl,
                          const uint32_t* cv, const uint32_t* em,
                          const int32_t* ep, const uint32_t* ehh,
                          const uint32_t* ehl, const int32_t* se,
                          const int32_t* st0, uint32_t thr_hi,
                          uint32_t thr_lo, int n, int W, int capl,
                          int force_entry, int col, int32_t* xs,
                          int32_t* lp, int32_t* lv, int32_t* ll,
                          void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (col)
    sweep_kernel<true><<<blocks, kThreads, 0, s>>>(
        hh, hl, cv, em, ep, ehh, ehl, se, st0, join(thr_hi, thr_lo), n, W,
        capl, force_entry, xs, lp, lv, ll);
  else
    sweep_kernel<false><<<blocks, kThreads, 0, s>>>(
        hh, hl, cv, em, ep, ehh, ehl, se, st0, join(thr_hi, thr_lo), n, W,
        capl, force_entry, xs, lp, lv, ll);
  return static_cast<int>(cudaGetLastError());
}
