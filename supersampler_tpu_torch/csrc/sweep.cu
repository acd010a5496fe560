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
// What bounds it on the H100: not bytes (some 10 us of HBM at a 4 Mbp
// tile) but each lane's chain of decisions. Only about one column in
// eight is an event (density ~2/(W+1)), so a lane needs some 24
// decisions, not 256, each dependent on the last (a rescan's new hash
// and expiry come from a global read). A tile has about 16k lanes: one
// thread per lane would leave a few warps per SM to hide that chain.
// With a warp per lane the chain is hidden and what remains is the
// instruction count, since the warp runs its lane's machine as
// warp-uniform code.
//
// What the design does about it: one warp per lane, eight lanes per
// block (some 2k blocks at the tile). The block first stages each live
// column's entering hash (hi/lo) in shared memory with coalesced loads:
// a lane's 1 KB row in the lane layout, 32-byte rows of the block's
// eight lanes in the col layout. Each warp then searches for its lane's
// next event 32 columns at a time: a __ballot_sync of "adopt (nh < h,
// strict unsigned 64-bit, or the forced entry) or expire (j >= p)" and
// __ffs give the first event column; the warp reads only that column's
// election words (cv for an adoption, em/ep/ehh/ehl for a rescan, one
// broadcast load each), updates its state and searches on from the next
// column. A lane costs about events + 8 warp steps; an inactive lane or
// an empty range (prefix passes 2..4, nearly always) costs its state
// copy. The election tables are not staged: 28 bytes per position at
// the tile would cost more HBM time than the events' reads. The lists
// and the exit state go through shared memory so that the block writes
// each (capl, n) row as one 32-byte segment of its eight lanes, zeros
// past cnt included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 256;          // positions per lane
constexpr int kLanes = 8;        // lanes (warps) per block
constexpr int kThreads = 32 * kLanes;
constexpr int kStride = kB + 4;  // staged row stride: conflict-free both ways
constexpr int kMaxCapl = 256;    // lists in shared memory, all under 48 KB
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ uint64_t join(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// shared memory of one block: the staged hashes, then the lists
// (3 x capl x kLanes words, entry (c, w) at c*kLanes + w)
constexpr size_t smem_bytes(int capl) {
  return sizeof(uint32_t) * (2 * kLanes * kStride + 3 * kLanes * capl);
}

template <bool kCol>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const uint32_t* __restrict__ hh, const uint32_t* __restrict__ hl,
    const uint32_t* __restrict__ cv, const uint32_t* __restrict__ em,
    const int32_t* __restrict__ ep, const uint32_t* __restrict__ ehh,
    const uint32_t* __restrict__ ehl, const int32_t* __restrict__ se,
    const int32_t* __restrict__ st0, uint64_t thr, int n, int W, int capl,
    int force_entry, int32_t* __restrict__ xs, int32_t* __restrict__ lp,
    int32_t* __restrict__ lv, int32_t* __restrict__ ll) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_hh = smem;
  uint32_t* s_hl = s_hh + kLanes * kStride;
  int32_t* s_lp = reinterpret_cast<int32_t*>(s_hl + kLanes * kStride);
  int32_t* s_lv = s_lp + kLanes * capl;
  int32_t* s_ll = s_lv + kLanes * capl;
  __shared__ int s_lo[kLanes], s_hi[kLanes];  // live columns [lo, hi)
  __shared__ int32_t s_xs[7][kLanes];

  const int t = threadIdx.x;
  const int w = t >> 5;        // this warp's lane in the block
  const int lane = t & 31;
  const int l0 = blockIdx.x * kLanes;
  const int l = l0 + w;

  // the lane's vectors (warp-uniform broadcast loads)
  int start = 0, j0 = 0, lo = 0, hi = 0;
  uint32_t val = 0;
  uint64_t h = 0;
  int p = 0, last_ev = 0, n_ev = 0;
  if (l < n) {
    start = se[l];
    const int end = se[n + l];
    const bool active = se[2 * n + l] != 0;
    j0 = se[3 * n + l];
    const int64_t lastiv = se[4 * n + l];
    val = static_cast<uint32_t>(st0[l]);
    h = join(st0[n + l], st0[2 * n + l]);
    p = st0[3 * n + l];
    last_ev = st0[4 * n + l];
    n_ev = st0[5 * n + l];
    if (active) {
      lo = max(start, 0);
      hi = static_cast<int>(
          min(static_cast<int64_t>(min(end, kB)), lastiv - j0 + 1));
      if (hi < lo) hi = lo;
    }
  }
  if (lane == 0) {
    s_lo[w] = lo;
    s_hi[w] = hi;
  }
  __syncthreads();

  // stage the live columns' entering hashes: step i fills lane i's 1 KB
  // row (lane layout), or each warp instruction four 32-byte rows of the
  // block's eight lanes (col layout)
#pragma unroll
  for (int i = 0; i < kB * kLanes / kThreads; ++i) {
    const int e = t + i * kThreads;
    const int sl = kCol ? (e & (kLanes - 1)) : (e >> 8);
    const int r = kCol ? (e >> 3) : (e & (kB - 1));
    if (r >= s_lo[sl] && r < s_hi[sl]) {
      const size_t g = kCol ? static_cast<size_t>(r) * n + (l0 + sl)
                            : static_cast<size_t>(l0 + sl) * kB + r;
      s_hh[sl * kStride + r] = __ldg(hh + g);
      s_hl[sl * kStride + r] = __ldg(hl + g);
    }
  }
  __syncthreads();

  // the event search: warp-uniform state, one ballot per step
  int cnt = 0;
  const uint32_t* row_hh = s_hh + w * kStride;
  const uint32_t* row_hl = s_hl + w * kStride;
  int base = -kB;
  uint32_t c_hi = 0, c_lo = 0;  // this thread's column of the chunk
  for (int cur = lo; cur < hi;) {
    if ((cur & ~31) != base) {
      base = cur & ~31;
      const int c = base + lane;
      if (c >= lo && c < hi) {
        c_hi = row_hh[c];
        c_lo = row_hl[c];
      }
    }
    const int c = base + lane;
    const bool adopt = join(c_hi, c_lo) < h || (force_entry && c == start);
    const unsigned evs =
        __ballot_sync(kFull, c >= cur && c < hi && (adopt || j0 + c >= p));
    if (evs == 0) {
      cur = base + 32;
      continue;
    }
    const int src = __ffs(evs) - 1;
    const int r = base + src;
    const int j = j0 + r;
    const bool is_entry = force_entry && r == start;
    const bool ad = __shfl_sync(kFull, static_cast<int>(adopt), src) != 0;
    const size_t g = kCol ? static_cast<size_t>(r) * n + l
                          : static_cast<size_t>(l) * kB + r;
    uint64_t new_h;
    uint32_t new_val;
    int new_p;
    if (ad) {
      new_h = join(__shfl_sync(kFull, c_hi, src),
                   __shfl_sync(kFull, c_lo, src));
      new_val = __ldg(cv + g);
      new_p = j + W;
    } else {
      new_h = join(__ldg(ehh + g), __ldg(ehl + g));
      new_val = __ldg(em + g);
      new_p = __ldg(ep + g) + j + 1;
    }
    if ((val >> 31) && !is_entry) {
      if (cnt < capl && lane == 0) {
        const int o = cnt * kLanes + w;
        s_lp[o] = j;
        s_lv[o] = static_cast<int32_t>(val);
        s_ll[o] = last_ev + 1;
      }
      ++cnt;
    }
    val = new_val | (static_cast<uint32_t>(new_h <= thr) << 31);
    h = new_h;
    p = new_p;
    last_ev = j;
    ++n_ev;
    cur = r + 1;
  }

  if (lane == 0) {
    s_xs[0][w] = static_cast<int32_t>(val);
    s_xs[1][w] = static_cast<int32_t>(h >> 32);
    s_xs[2][w] = static_cast<int32_t>(h);
    s_xs[3][w] = p;
    s_xs[4][w] = last_ev;
    s_xs[5][w] = n_ev;
    s_xs[6][w] = cnt;
  }
  __syncthreads();

  // the block's eight lanes of each output row, one 32-byte segment
  const int ol = l0 + (t & (kLanes - 1));
  if (ol >= n) return;
  for (int e = t; e < 7 * kLanes; e += kThreads)
    xs[static_cast<size_t>(e >> 3) * n + ol] = s_xs[e >> 3][e & 7];
  for (int e = t; e < capl * kLanes; e += kThreads) {
    const int c = e >> 3;
    const bool keep = c < s_xs[6][e & 7];
    const size_t o = static_cast<size_t>(c) * n + ol;
    lp[o] = keep ? s_lp[e] : 0;
    lv[o] = keep ? s_lv[e] : 0;
    ll[o] = keep ? s_ll[e] : 0;
  }
}

template <bool kCol>
int launch(const uint32_t* hh, const uint32_t* hl, const uint32_t* cv,
           const uint32_t* em, const int32_t* ep, const uint32_t* ehh,
           const uint32_t* ehl, const int32_t* se, const int32_t* st0,
           uint64_t thr, int n, int W, int capl, int force_entry,
           int32_t* xs, int32_t* lp, int32_t* lv, int32_t* ll,
           cudaStream_t s) {
  const int blocks = (n + kLanes - 1) / kLanes;
  sweep_kernel<kCol><<<blocks, kThreads, smem_bytes(capl), s>>>(
      hh, hl, cv, em, ep, ehh, ehl, se, st0, thr, n, W, capl, force_entry,
      xs, lp, lv, ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tables: n*256 entries each; col == 0: lane l owns [l*256, (l+1)*256),
// col != 0: (256, n) row-major, column r of lane l at r*n + l. se
// (5, n) = start, end, active, j0, lastiv; st0 (6, n) = val, h_hi, h_lo,
// p, last_ev, n_ev. Outputs xs (7, n) and lp/lv/ll (capl, n), capl in
// [1, 256].
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
  if (capl < 1 || capl > kMaxCapl)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t thr = join(thr_hi, thr_lo);
  return col ? launch<true>(hh, hl, cv, em, ep, ehh, ehl, se, st0, thr, n,
                            W, capl, force_entry, xs, lp, lv, ll, s)
             : launch<false>(hh, hl, cv, em, ep, ehh, ehl, se, st0, thr, n,
                             W, capl, force_entry, xs, lp, lv, ll, s);
}
