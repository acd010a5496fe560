// Field scan kernels: 2-bit packed codes -> per-position field tables.
//
// spsp_scan replaces the TPU kernel supersampler_tpu/ops/scan_kernel.py
// (_scan_block_kernel, launched by _scan_tables_mosaic and wrapped by
// field_core_mosaic) together with the XLA sync chain that followed it
// (supersampler_tpu/ops/field.py _sync_from_h0) and the position masking
// of scan_field_2d / scan_field_batched (field.py:189, :264).
// spsp_scan2 replaces the v2 TPU kernel supersampler_tpu/ops/fused.py
// _scan2_kernel (launched by _scan2): the same tables in the sweep's
// column layout, each lane's first sync column and the records' window-0
// elections. Both share the m-mer staging, the window minima and the
// election from them below (stage_mmers, window_minima, elect_min).
//
// What it computes, per position j of a flat batch of records laid
// back to back (record r owns [r*P_rec, (r+1)*P_rec)):
//   * the canonical m-mer (value, strand) and its XXHash64 (seed 1312);
//   * h0[j] / cv[j]: hash and value|rev<<30 of the m-mer entering at j
//     (m-mer start j+W);
//   * em/ep/eh[j]: the exact right-to-left election fold of window j+1
//     (reference SubSampler.cpp:81-169 tie rules);
//   * sync[j]: h0[j] strictly below every h0 of [j-2W, j-1], masked to
//     2W <= jloc <= last_i[r] (record-local jloc);
//   * per record, the window-0 election (the entry state of the
//     streaming machine).
// Lookahead past the last position wraps to position 0, as the TPU
// layout's row halo does; wrapped values sit past last_i and are never
// consumed.
//
// What bounds spsp_scan on the H100: at least the bytes it writes, 29 a
// position (about 122 MB for a 4 Mbp tile, some 37 us at the HBM rate);
// past that, the latency of its staging and window-minimum phases
// (chip_scan_probe.py times them apart). Both the election of a window
// and the sync lookback are sliding-window minima over the m-mer
// hashes, which a per-position loop would recompute at 3W shared reads
// and compares a position.
//
// What its design does about it: a block of 256 threads covers
// kScanT = 1,024 positions (thread t owns t + 256q, so each warp store
// writes 128 contiguous bytes). The block stages its codes (a left halo
// of W, a right halo of W+m-1 positions) in shared memory and hashes
// each of its kScanT + 2W m-mers once (about 1.04 hashes a position).
// It then builds window minima once (van Herk / Gil-Werman): the staged
// hashes are cut into segments of W, and one thread per segment and
// direction writes the running minimum from the segment's start
// (prefix) or end (suffix), with its leftmost and rightmost argmin. The
// window [s, s+W-1] spans at most two segments, so its minimum is the
// suffix at s joined with the prefix at s+W-1: a few shared reads a
// position. The sync lookback of position o is the minimum of two
// adjacent windows, [o, o+W-1] and [o+W, o+2W-1]. The election takes the
// minimum's m-mer directly where it is unique; where the minimum occurs
// more than once (a repeated m-mer: homopolymers, short tandems), the
// reference fold's outcome follows in closed form from its occurrences
// (elect_min), found by a search bounded by the window.
//
// spsp_scan2 writes the column layout, entry [r, l] at r * n_lanes + l
// (the counterpart of the TPU's (tiles, 256, 128) blocks without their
// half-major lane order), so that a warp of the sweep reads one column
// of 32 lanes as contiguous words. Its blocks of 512 threads cover
// kLanes = 8 lanes (2,048 positions) each, with the stage, the window
// minima, the elections and the sync lookback of spsp_scan: no fold and
// no lookback a position. The 2,048 + 2W m-mers take about 80 KB of
// stage and minima, so two blocks fit an SM (32 warps); each thread keeps
// its 4 positions' 28 values in registers until the minima are read, and
// an output tile (68 KB) is then laid over them. On the H100 a 32-byte
// sector written in part by two blocks costs about as much as two
// written whole (chip_scan_probe.py), and a block's 8 lanes of a row fill
// one sector only where the row starts on one: always where n_lanes is a
// multiple of 8 (the read batches), in one row of four at the 4 Mbp tile
// (16,386 lanes). So the blocks run in clusters of kCluster = 8: for each
// row, a block's tile holds the sector that starts among its lanes, and
// the next block of the cluster stores the lanes it lacks there through
// distributed shared memory, 16 bytes at a time; only the cluster's two
// ends write part of a sector. Each lane's first sync comes from a
// __ballot_sync per warp and a min over the lane's 8 warp-sized runs in
// shared memory: no atomics.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 256;      // threads per block; positions per lane
constexpr int kScanT = 1024; // positions per scan block
constexpr int kLanes = 8;    // lanes per scan2 block
constexpr int kT2 = 512;     // threads per scan2 block
constexpr int kScan2Blocks = 1024 / kT2;  // resident per SM: 64 registers
// scan2's output tile: per row, kLanes entries of 8 words (the 7 table
// values and a pad) as two 16-byte halves, first halves then second
// halves, and one 16-byte pad a row against bank conflicts
constexpr int kRowQ = 2 * kLanes + 1;  // 16-byte words a tile row
constexpr int kFsBytes = kLanes * kT / 32 * 4;  // scan2's warp_fs
constexpr int kCluster = 8;  // scan2 blocks a cluster
static_assert(kLanes * 4 == 32, "a block's row is one 32-byte sector");

constexpr uint64_t kP1 = 11400714785074694791ull;
constexpr uint64_t kP2 = 14029467366897019727ull;
constexpr uint64_t kP3 = 1609587929392839161ull;
constexpr uint64_t kP4 = 9650029242287828579ull;
constexpr uint64_t kP5 = 2870177450012600261ull;
constexpr uint64_t kSeed = 1312ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// XXHash64 of the 8 little-endian bytes of x (x < 2^32 here).
__device__ __forceinline__ uint64_t xxh64_8(uint64_t x) {
  uint64_t h = kSeed + kP5 + 8ull;
  uint64_t single = rotl64(x * kP2, 31) * kP1;
  h = rotl64(h ^ single, 27) * kP1 + kP4;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

struct Election {
  uint32_t mini;
  uint32_t rev;
  int32_t pos;
  uint64_t hash;
};

// m-mers staged in shared memory: the m-mer starting at position x0 + i
// has index i (canonical value, strand, XXHash64).
struct Stage {
  const uint64_t* hash;
  const uint32_t* canon;
  const uint8_t* rev;
};

__host__ __device__ constexpr size_t stage_bytes(int n_mm, int m) {
  return static_cast<size_t>(n_mm) * (8 + 4 + 1) + n_mm + m;
}

// Stages the codes of positions [x0, x0 + n_mm + m - 1) (modulo P: the
// wrap of the TPU layout's row halo) and then every m-mer's canonical
// value, strand and hash, each computed once: a thread rolls the forward
// and reverse-complement values over a run of consecutive m-mers, one
// code a step. The whole block calls it.
__device__ Stage stage_mmers(unsigned char* smem, const uint8_t* packed,
                             int64_t P, int64_t x0, int n_mm, int m) {
  uint64_t* s_hash = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_canon = reinterpret_cast<uint32_t*>(s_hash + n_mm);
  uint8_t* s_rev = reinterpret_cast<uint8_t*>(s_canon + n_mm);
  uint8_t* s_code = s_rev + n_mm;
  const int n_c = n_mm + m - 1;
  for (int i = threadIdx.x; i < n_c; i += blockDim.x) {
    int64_t x = x0 + i;
    if (x < 0 || x >= P) {  // past either end: no 64-bit division else
      x %= P;
      if (x < 0) x += P;
    }
    s_code[i] = (packed[x >> 2] >> (2 * (x & 3))) & 3;
  }
  __syncthreads();
  const int per = (n_mm + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per;
  const int i1 = min(i0 + per, n_mm);
  const uint32_t mask = (1u << (2 * m)) - 1;
  const int top = 2 * (m - 1);
  uint32_t fwd = 0, rc = 0;  // the first code in fwd's top, rc's bottom
  for (int j = 0; j < m - 1 && i0 < i1; ++j) {
    const uint32_t c = s_code[i0 + j];
    fwd = (fwd << 2) | c;
    rc = (rc >> 2) | ((c ^ 2u) << top);
  }
  for (int i = i0; i < i1; ++i) {
    const uint32_t c = s_code[i + m - 1];
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | ((c ^ 2u) << top);
    const uint32_t r = rc < fwd;
    const uint32_t canon = r ? rc : fwd;
    s_canon[i] = canon;
    s_rev[i] = static_cast<uint8_t>(r);
    s_hash[i] = xxh64_8(canon);
  }
  __syncthreads();
  return {s_hash, s_canon, s_rev};
}

// Record rec's window-0 election (the streaming machine's entry state),
// written by the thread of the record's first position.
__device__ __forceinline__ void write_init(int32_t* init, int64_t rec,
                                           int64_t n_rec,
                                           const Election& e0) {
  init[rec] = static_cast<int32_t>(e0.mini | (e0.rev << 30));
  init[n_rec + rec] = e0.pos;
  init[2 * n_rec + rec] = static_cast<int32_t>(e0.hash >> 32);
  init[3 * n_rec + rec] = static_cast<int32_t>(e0.hash);
}

// Window minima of n_mm staged hashes, cut into segments of W: pre[i]
// is the minimum over [start of i's segment, i], suf[i] over [i, end of
// i's segment], each with its leftmost and rightmost argmin as
// l | r << 16 (shared indices, < 2^16).
struct MinTabs {
  const uint64_t* pre_h;
  const uint64_t* suf_h;
  const uint32_t* pre_lr;
  const uint32_t* suf_lr;
};

__host__ __device__ constexpr size_t align8(size_t n) {
  return (n + 7) & ~static_cast<size_t>(7);
}

__host__ __device__ constexpr size_t scan_smem_bytes(int n_mm, int m) {
  return align8(stage_bytes(n_mm, m)) +
         static_cast<size_t>(n_mm) * 2 * (8 + 4);
}

// scan2: warp_fs, then the stage and the minima, over which the output
// tile is laid once they are read.
__host__ __device__ constexpr size_t scan2_smem_bytes(int n_mm, int m) {
  return kFsBytes + (scan_smem_bytes(n_mm, m) > 16u * kT * kRowQ
                         ? scan_smem_bytes(n_mm, m)
                         : 16u * kT * kRowQ);
}

// Builds MinTabs at smem (after the stage). One thread per segment and
// direction walks its segment with the running minimum in registers;
// the whole block calls it.
__device__ MinTabs window_minima(unsigned char* smem, const uint64_t* hash,
                                 int n_mm, int W) {
  uint64_t* pre_h = reinterpret_cast<uint64_t*>(smem);
  uint64_t* suf_h = pre_h + n_mm;
  uint32_t* pre_lr = reinterpret_cast<uint32_t*>(suf_h + n_mm);
  uint32_t* suf_lr = pre_lr + n_mm;
  const int n_seg = (n_mm + W - 1) / W;
  for (int task = threadIdx.x; task < 2 * n_seg; task += blockDim.x) {
    const bool pre = task < n_seg;
    const int a = (pre ? task : task - n_seg) * W;
    const int b = min(a + W, n_mm) - 1;
    const int step = pre ? 1 : -1;
    uint64_t* out_h = pre ? pre_h : suf_h;
    uint32_t* out_lr = pre ? pre_lr : suf_lr;
    int i = pre ? a : b;
    uint64_t h = hash[i];
    uint32_t l = i, r = i;
    out_h[i] = h;
    out_lr[i] = l | (r << 16);
    for (int n = b - a; n > 0; --n) {
      i += step;
      const uint64_t x = hash[i];
      if (x < h) {
        h = x;
        l = r = i;
      } else if (x == h) {
        if (pre)
          r = i;
        else
          l = i;
      }
      out_h[i] = h;
      out_lr[i] = l | (r << 16);
    }
  }
  __syncthreads();
  return {pre_h, suf_h, pre_lr, suf_lr};
}

// The minimum of the hashes [s, s+W-1] and its leftmost and rightmost
// shared index. suf[s] covers s up to its segment's end and pre[s+W-1]
// the next segment up to s+W-1 (or, where s starts a segment, both
// cover the same segment).
struct WinMin {
  uint64_t h;
  int l, r;
};

__device__ __forceinline__ uint64_t min_u64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ WinMin window_min(const MinTabs& mt, int s,
                                             int W) {
  const int e = s + W - 1;
  const uint64_t hs = mt.suf_h[s], hp = mt.pre_h[e];
  const uint32_t ls = mt.suf_lr[s], lp = mt.pre_lr[e];
  if (hp < hs) return {hp, static_cast<int>(lp & 0xffff),
                       static_cast<int>(lp >> 16)};
  return {hs, static_cast<int>(ls & 0xffff),
          static_cast<int>((hs < hp ? ls : lp) >> 16)};
}

// regular_minimizer_pos (the reference's right-to-left election fold,
// SubSampler.cpp:81-169) of the window whose first m-mer sits at shared
// index s, from its minimum. Equal hashes are equal canonical m-mers
// (XXHash64 is a bijection on 64-bit words), so the
// fold's outcome depends only on where the minimal m-mer occurs, with
// r1 its rightmost occurrence (window offsets 0 .. km):
//   * r1 forward: the leftmost forward occurrence (the fold takes every
//     forward tie to its left);
//   * r1 reverse and r1 = km: position 0 (the fold's start value, which
//     no tie beats);
//   * r1 reverse, r1 < km: min(r1, km - r2) with r2 the rightmost
//     reverse occurrence left of r1 (a reverse tie takes the mirrored
//     position km - off once, if smaller), or r1 where there is none.
// Occurrences on the other strand never take. A unique minimum needs
// no search.
__device__ __forceinline__ Election elect_min(const Stage& st,
                                              const MinTabs& mt, int s,
                                              int W) {
  const int km = W - 1;
  const WinMin w = window_min(mt, s, W);
  Election e;
  e.hash = w.h;
  e.mini = st.canon[w.r];
  e.rev = st.rev[w.r];
  const int r1 = w.r - s;
  e.pos = r1;
  if (e.rev) {
    if (r1 == km) {
      e.pos = 0;
    } else {
      for (int x = w.r - 1; x >= w.l; --x) {
        if (st.rev[x] && st.canon[x] == e.mini) {
          e.pos = min(r1, km - (x - s));
          break;
        }
      }
    }
  } else if (w.l != w.r) {
    int x = w.l;  // stops at w.r at the latest
    while (st.rev[x] || st.canon[x] != e.mini) ++x;
    e.pos = x - s;
  }
  return e;
}

// Thread t of block b writes positions b*kScanT + t + kT*q, q < 4. For
// position o (block-local) the entering m-mer has shared index o + 2W,
// the election of window j+1 is that of index o+W+1, and the sync
// lookback covers indices [o, o+2W-1].
__global__ void scan_kernel(const uint8_t* __restrict__ packed, int64_t P,
                            int64_t P_rec, int k, int m,
                            const int32_t* __restrict__ last_i,
                            int32_t* __restrict__ h_hi,
                            int32_t* __restrict__ h_lo,
                            int32_t* __restrict__ cv,
                            int32_t* __restrict__ em,
                            int32_t* __restrict__ ep,
                            int32_t* __restrict__ eh_hi,
                            int32_t* __restrict__ eh_lo,
                            uint8_t* __restrict__ sync,
                            int32_t* __restrict__ init, int64_t n_rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = k - m + 1;
  const int n_mm = kScanT + 2 * W;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kScanT;
  const Stage st = stage_mmers(smem, packed, P, j0 - W, n_mm, m);
  const MinTabs mt =
      window_minima(smem + align8(stage_bytes(n_mm, m)), st.hash, n_mm, W);

  const int t = threadIdx.x;
  int64_t rec = (j0 + t) / P_rec;
  int64_t jloc = j0 + t - rec * P_rec;
#pragma unroll
  for (int q = 0; q < kScanT / kT; ++q) {
    const int o = t + q * kT;
    const int64_t j = j0 + o;
    if (j >= P) break;
    const uint64_t h0 = st.hash[o + 2 * W];
    h_hi[j] = static_cast<int32_t>(h0 >> 32);
    h_lo[j] = static_cast<int32_t>(h0);
    cv[j] = static_cast<int32_t>(
        st.canon[o + 2 * W] |
        (static_cast<uint32_t>(st.rev[o + 2 * W]) << 30));
    const Election e = elect_min(st, mt, o + W + 1, W);
    em[j] = static_cast<int32_t>(e.mini | (e.rev << 30));
    ep[j] = e.pos;
    eh_hi[j] = static_cast<int32_t>(e.hash >> 32);
    eh_lo[j] = static_cast<int32_t>(e.hash);

    const uint64_t look =
        min_u64(min_u64(mt.suf_h[o], mt.pre_h[o + W - 1]),
                min_u64(mt.suf_h[o + W], mt.pre_h[o + 2 * W - 1]));
    sync[j] = jloc >= 2 * W && jloc <= last_i[rec] && h0 < look;
    if (jloc == 0) write_init(init, rec, n_rec, elect_min(st, mt, o + W, W));
    jloc += kT;
    while (jloc >= P_rec) {
      jloc -= P_rec;
      ++rec;
    }
  }
}

// The v2 scan: the same tables for kLanes lanes of 256 positions,
// written in the column layout (entry [r, l] at r * n_lanes + l), plus
// each lane's first sync column. Thread t computes positions t + kT2 q
// of the block (lane o / 256, row o % 256) from the window minima as
// scan_kernel does and keeps their values in registers. Once every block
// of the cluster has read its minima, the values pass through a shared
// tile laid over the stage: its row r holds the 8 lanes of the 32-byte
// sector that starts among the block's lanes, a .. a + 7 with
// a = sector_lane(r), the last a of them stored there (16 bytes at a
// time) by the next block of the cluster. A warp then writes 32 / kLanes
// whole sectors of a table, with streaming stores (nothing reads them
// back here). Only the cluster's ends write part of a sector: its last
// block lanes a .. 7, its first block lanes 0 .. a - 1, through the tile
// again.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kT2, kScan2Blocks)
    scan2_kernel(const uint8_t* __restrict__ packed, int64_t P,
                 int64_t P_rec, int k, int m, int64_t n_lanes,
                 int32_t* __restrict__ h_hi, int32_t* __restrict__ h_lo,
                 int32_t* __restrict__ cv, int32_t* __restrict__ em,
                 int32_t* __restrict__ ep, int32_t* __restrict__ eh_hi,
                 int32_t* __restrict__ eh_lo, int32_t* __restrict__ fs,
                 int32_t* __restrict__ init, int64_t n_rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int W = k - m + 1;
  // blocks past the last lane (the grid is a whole number of clusters)
  // compute wrapped positions and store nothing
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int64_t j0 = l0 * kT;
  const int n_mm = kLanes * kT + 2 * W;
  // warp_fs[o / 32]: the first sync among positions of warp-sized run
  // o / 32 (kT / 32 runs a lane), kT if none
  int32_t* warp_fs = reinterpret_cast<int32_t*>(smem);
  unsigned char* work = smem + kFsBytes;
  const Stage st = stage_mmers(work, packed, P, j0 - W, n_mm, m);
  const MinTabs mt =
      window_minima(work + align8(stage_bytes(n_mm, m)), st.hash, n_mm, W);

  const int t = threadIdx.x;
  const int64_t left = n_lanes - l0;
  const int nl = left < kLanes ? static_cast<int>(left) : kLanes;
  constexpr int kQ = kLanes * kT / kT2;
  uint32_t v[7][kQ];  // set for the block's lanes, read only for them
  int64_t rec = (j0 + t) / P_rec;
  int64_t jloc = j0 + t - rec * P_rec;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int o = q * kT2 + t;
    if (o / kT < nl) {  // uniform across each warp
      const uint64_t h0 = st.hash[o + 2 * W];
      v[0][q] = static_cast<uint32_t>(h0 >> 32);
      v[1][q] = static_cast<uint32_t>(h0);
      v[2][q] = st.canon[o + 2 * W] |
                (static_cast<uint32_t>(st.rev[o + 2 * W]) << 30);
      const Election e = elect_min(st, mt, o + W + 1, W);
      v[3][q] = e.mini | (e.rev << 30);
      v[4][q] = static_cast<uint32_t>(e.pos);
      v[5][q] = static_cast<uint32_t>(e.hash >> 32);
      v[6][q] = static_cast<uint32_t>(e.hash);
      // v2 sync: masked by the record's first 2W positions only; the
      // caller drops a first sync past last_i (fused.py:515)
      const uint64_t look =
          min_u64(min_u64(mt.suf_h[o], mt.pre_h[o + W - 1]),
                  min_u64(mt.suf_h[o + W], mt.pre_h[o + 2 * W - 1]));
      const unsigned ballot =
          __ballot_sync(0xffffffffu, jloc >= 2 * W && h0 < look);
      if ((t & 31) == 0)
        warp_fs[o / 32] = ballot ? o % kT + __ffs(ballot) - 1 : kT;
      if (jloc == 0)
        write_init(init, rec, n_rec, elect_min(st, mt, o + W, W));
    }
    jloc += kT2;
    while (jloc >= P_rec) {
      jloc -= P_rec;
      ++rec;
    }
  }
  cluster.sync();  // every block of the cluster is done with its minima
  if (t < nl) {
    int f = kT;
    for (int w = 0; w < kT / 32; ++w) f = min(f, warp_fs[t * (kT / 32) + w]);
    fs[l0 + t] = f;
  }
  int32_t* const outs[7] = {h_hi, h_lo, cv, em, ep, eh_hi, eh_lo};
  // sector_lane(r): the lane (from l0) where a sector of row r starts
  const int e0 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(h_hi) / 4 + l0) & (kLanes - 1));
  const int n8 = static_cast<int>(n_lanes & (kLanes - 1));
  const auto sector_lane = [e0, n8](int r) {
    return -(e0 + r * n8) & (kLanes - 1);
  };
  const unsigned rank = cluster.block_rank();
  uint4* tile = reinterpret_cast<uint4*>(work);  // [kT][kRowQ]
  // entry c of row r: halves tile[r * kRowQ + c], [r * kRowQ + kLanes + c]
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int o = q * kT2 + t;
    const int li = o / kT, r = o % kT;
    const int a = sector_lane(r);
    if (li >= nl || (li < a && rank == 0)) continue;
    uint4* e = li >= a ? &tile[r * kRowQ + li - a]  // into the previous
                       : cluster.map_shared_rank(  // block's sector
                             &tile[r * kRowQ + kLanes - a + li], rank - 1);
    e[0] = make_uint4(v[0][q], v[1][q], v[2][q], v[3][q]);
    e[kLanes] = make_uint4(v[4][q], v[5][q], v[6][q], 0u);
  }
  cluster.sync();
  const bool next = rank + 1 < kCluster;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int f = q * kT2 + t;  // row f / kLanes, sector lane f % kLanes
    const int r = f / kLanes, c = f % kLanes;
    const int li = sector_lane(r) + c;
    if (li < kLanes ? li < nl : next && l0 + li < n_lanes) {
      const uint4 x0 = tile[r * kRowQ + c], x1 = tile[r * kRowQ + kLanes + c];
      const uint32_t x[7] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z};
#pragma unroll
      for (int i = 0; i < 7; ++i)
        __stcs(&outs[i][r * n_lanes + l0 + li], static_cast<int32_t>(x[i]));
    }
  }
  if (rank > 0) return;
  // the cluster's first block: its lanes 0 .. a - 1, part of a sector
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int o = q * kT2 + t;
    const int li = o / kT, r = o % kT;
    if (li >= nl || li >= sector_lane(r)) continue;
    tile[r * kRowQ + li] = make_uint4(v[0][q], v[1][q], v[2][q], v[3][q]);
    tile[r * kRowQ + kLanes + li] = make_uint4(v[4][q], v[5][q], v[6][q], 0u);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int f = q * kT2 + t;
    const int r = f / kLanes, c = f % kLanes;
    if (c >= nl || c >= sector_lane(r)) continue;
    const uint4 x0 = tile[r * kRowQ + c], x1 = tile[r * kRowQ + kLanes + c];
    const uint32_t x[7] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z};
#pragma unroll
    for (int i = 0; i < 7; ++i)
      __stcs(&outs[i][r * n_lanes + l0 + c], static_cast<int32_t>(x[i]));
  }
}

}  // namespace

extern "C" const char* spsp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// packed: P/4 bytes; last_i: n_rec = P / P_rec record bounds; the seven
// tables and sync hold P entries; init is (4, n_rec): value|rev<<30,
// position, hash hi, hash lo of each record's window-0 election.
extern "C" int spsp_scan(const uint8_t* packed, int64_t P, int64_t P_rec,
                         int k, int m, const int32_t* last_i,
                         int32_t* h_hi, int32_t* h_lo, int32_t* cv,
                         int32_t* em, int32_t* ep, int32_t* eh_hi,
                         int32_t* eh_lo, uint8_t* sync, int32_t* init,
                         void* stream) {
  if (P <= 0) return 0;
  const int W = k - m + 1;
  // at most 43,704 B (W = 63 at k = 63, m = 1): under the 48 KB default
  const size_t smem = scan_smem_bytes(kScanT + 2 * W, m);
  const int64_t blocks = (P + kScanT - 1) / kScanT;
  scan_kernel<<<static_cast<unsigned>(blocks), kT, smem,
                static_cast<cudaStream_t>(stream)>>>(
      packed, P, P_rec, k, m, last_i, h_hi, h_lo, cv, em, ep, eh_hi, eh_lo,
      sync, init, P / P_rec);
  return static_cast<int>(cudaGetLastError());
}

// The v2 scan. packed: P/4 bytes, P a multiple of 256 and of P_rec; the
// seven tables are (256, P/256) column layouts; fs holds P/256 first-sync
// columns (256 = none); init is (4, n_rec) as for spsp_scan.
extern "C" int spsp_scan2(const uint8_t* packed, int64_t P, int64_t P_rec,
                          int k, int m, int32_t* h_hi, int32_t* h_lo,
                          int32_t* cv, int32_t* em, int32_t* ep,
                          int32_t* eh_hi, int32_t* eh_lo, int32_t* fs,
                          int32_t* init, void* stream) {
  if (P <= 0) return 0;
  const int W = k - m + 1;
  const int64_t n_lanes = P / kT;
  // 79,688 B at W = 21 (k = 31, m = 11), at most 82,872 B (W = 63 at
  // k = 63, m = 1): over the 48 KB default, so the limit is raised
  const size_t smem = scan2_smem_bytes(kLanes * kT + 2 * W, m);
  const cudaError_t err = cudaFuncSetAttribute(
      scan2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_lanes + kLanes * kCluster - 1) /
                         (kLanes * kCluster) * kCluster;
  scan2_kernel<<<static_cast<unsigned>(blocks), kT2, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      packed, P, P_rec, k, m, n_lanes, h_hi, h_lo, cv, em, ep, eh_hi, eh_lo,
      fs, init, P / P_rec);
  return static_cast<int>(cudaGetLastError());
}
