// Walk kernel: the super-k-mer event chain over packed successor words,
// emitting the FHS-selected boundaries, as exact per-block transfer maps
// composed across blocks.
//
// Replaces the TPU kernel supersampler_tpu/ops/walker.py _walk_kernel
// (walker.py:72, launched by walk_pallas). Its plain twin is walk_plain
// (ops/walker.py of this package), with the same output contract.
//
// What it computes (reference SubSampler.cpp:367-454): from the entering
// state init5 = [nxt_pos, nxt_typ, cur_sel, cur_pos, cur_typ], follow
//   h = packed[nxt_pos] >> (nxt_typ * 16), delta = h & 63,
//   next = delta ? nxt_pos + delta : -1, next type = (h >> 6) & 1,
//   the new event's sel bit = (h >> 7) & 1
// while 0 <= nxt_pos < n_blocks * 2048. Each transition out of a
// selected event appends (boundary nxt_pos, cur_pos + 1, source
// 2 * cur_pos + cur_typ or -1) to the rows of the 2048-position block
// that holds nxt_pos; cnt[b] counts block b's rows, and rows past it
// are -1. The final state goes to scal = [n_ev, cur_pos, cur_typ,
// cur_sel, nxt_pos, nxt_typ], which the next tile's walk starts from.
//
// What bounds it on the H100: the chain looks serial, one dependent
// load per event (some 386k events on a 4 Mbp tile), but it is not.
// Every delta is 1..63, so the first event inside block b lies in
// [2048b, 2048b + 62], of type 0 or 1: at most 126 entries. The path
// through a block depends only on its entry, so each block is a map
// from 126 entries (plus "no event here") to an exit in the next block.
// Maps compose associatively, so all blocks work at once and the serial
// part shrinks to a chase over small maps and one walk through a block.
// What is left is that walk's latency (some 190 dependent shared-memory
// loads) and bytes: every word is read twice (maps and emit) and the
// three (n_blocks, 2048) row arrays are written once in full, -1 past
// cnt.
//
// The design, three launches (one for a 1-block walk). Each block's
// words become a node table in shared memory first: node x = 2 * offset
// + type holds its successor node (relative to the block; >= 4096 past
// it, kEnded + type where the chain ends) and its sel bit, so a step of
// a walk is one dependent 16-bit load.
//  1. walk_maps, one CTA per block: thread e < 126 walks from entry node
//     e (offset e / 2, type e & 1) to its first event in the pivot zone,
//     offsets [64, 127), which every path from an entry passes (deltas
//     <= 63); thread 126 walks from init5 in the block that holds it.
//     Paths merge there, so each pivot that some entry reached is walked
//     to the block's end once, by the thread of its slot. An entry's
//     record: the last event in the block (node and sel bit); its code:
//     the exit as an entry of block b + 1, or 127 (ended, or none).
//  2. walk_compose, one CTA per group of G blocks: chase each of the 128
//     states through the group's codes in shared memory, writing the
//     state on entry to every block (path) and after the group (fg).
//     The CTA that finishes last (a fenced counter) chases the groups
//     from init5's and writes each group's entering state (gent).
//  3. walk_emit, one CTA per block: its true entry is path[b][gent[g]]
//     and its incoming event the record of block b - 1's (or init5's).
//     Thread 0 re-walks the block and stores its rows, the other threads
//     then fill the rest with -1; the block whose exit ends the walk
//     writes scal, every block adds its events to scal[0].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBP = 2048;      // positions per block
constexpr int kNodes = 2 * kBP;
constexpr int kT = 128;        // threads per CTA
constexpr int kE = 128;        // states: 126 entries, init5, none
constexpr int kNCand = 126;    // entry nodes 0..125: offsets 0..62
constexpr int kInit = 126;     // init5's entry (in its own block only)
constexpr int kNone = 127;     // no event in this block or later
constexpr int kZone = 128;     // the pivot zone: nodes [128, 254)
constexpr int kEnded = 0x1FFE;  // successor node where the chain ends
constexpr int kNodeMask = 0x1FFF;

inline int group_size(int n_blocks) {
  int g = 32;
  while (g * g < n_blocks) ++g;
  return g;
}

// The block that holds init5's entry, or n_blocks if it is outside.
__device__ inline int init_block(const int32_t* init5, int n_blocks) {
  const int p = init5[0];
  return p >= 0 && p < n_blocks * kBP ? p / kBP : n_blocks;
}

// Node table entries of offset p, types 0 and 1 (successor node | sel
// << 13), as one word.
__device__ inline int node_pair(int32_t word, int p) {
  unsigned out = 0;
  for (int typ = 0; typ < 2; ++typ) {
    const int h = word >> (typ << 4);
    const int d = h & 63;
    const int nt = (h >> 6) & 1;
    const int x = d ? 2 * (p + d) + nt : kEnded + nt;
    out |= (static_cast<unsigned>(x) | ((h & 128) << 6)) << (typ << 4);
  }
  return static_cast<int>(out);
}

// The block's node table from its 2048 words, 16 bytes a thread a step.
__device__ inline void build_table(uint16_t* tab, const int32_t* src,
                                   int t) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* t4 = reinterpret_cast<int4*>(tab);
  for (int i = t; i < kBP / 4; i += kT) {
    const int4 v = s4[i];
    const int p = 4 * i;
    t4[i] = make_int4(node_pair(v.x, p), node_pair(v.y, p + 1),
                      node_pair(v.z, p + 2), node_pair(v.w, p + 3));
  }
}

// Walk from node x while it lies in the block and outside [zlo, zlo +
// zlen); last = the last event's node | sel << 12 (unchanged if none).
__device__ inline void walk_nodes(const uint16_t* tab, int& x, int zlo,
                                  int zlen, int& last) {
  while (x < kNodes &&
         static_cast<unsigned>(x - zlo) >= static_cast<unsigned>(zlen)) {
    const int e = tab[x];
    last = x | ((e >> 1) & 0x1000);
    x = e & kNodeMask;
  }
}

__global__ void __launch_bounds__(kT)
walk_maps(const int32_t* __restrict__ packed, int n_blocks,
          const int32_t* __restrict__ init5, uint16_t* __restrict__ rec,
          uint8_t* __restrict__ code, unsigned* __restrict__ counter) {
  __shared__ __align__(16) uint16_t tab[kNodes];
  __shared__ uint16_t tail_last[kNCand], tail_exit[kNCand];
  __shared__ uint8_t used[kNCand];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int b0 = init_block(init5, n_blocks);
  if (b == 0 && t == 0) *counter = 0;
  if (b < b0) {  // no event here: only "none" is ever looked up
    code[static_cast<size_t>(b) * kE + t] = kNone;
    return;
  }
  const int start = b * kBP;
  build_table(tab, packed + static_cast<size_t>(start), t);
  if (t < kNCand) used[t] = 0;
  __syncthreads();

  // phase A: from the entry to its pivot (or to the end of its path)
  const bool live = t < kNCand || (t == kInit && b == b0);
  int x = t < kNCand ? t : 2 * (init5[0] - start) + init5[1];
  int last = -1;
  if (live) {
    walk_nodes(tab, x, kZone, kNCand, last);
    if (static_cast<unsigned>(x - kZone) < kNCand) used[x - kZone] = 1;
  }
  __syncthreads();

  // phase B: each pivot that some entry reached, to the block's end
  if (t < kNCand && used[t]) {
    int y = kZone + t;
    int l = -1;
    walk_nodes(tab, y, 0, 0, l);
    tail_last[t] = static_cast<uint16_t>(l);
    tail_exit[t] = static_cast<uint16_t>(y);
  }
  __syncthreads();

  int c = kNone;
  if (live) {
    if (static_cast<unsigned>(x - kZone) < kNCand) {
      last = tail_last[x - kZone];
      x = tail_exit[x - kZone];
    }
    rec[static_cast<size_t>(b) * kE + t] = static_cast<uint16_t>(last);
    if (x >= kNodes && x < kEnded && b + 1 < n_blocks) c = x - kNodes;
  }
  code[static_cast<size_t>(b) * kE + t] = static_cast<uint8_t>(c);
}

__global__ void __launch_bounds__(kT)
walk_compose(int n_blocks, int G, const int32_t* __restrict__ init5,
             const uint8_t* __restrict__ code, uint8_t* path, uint8_t* fg,
             uint8_t* __restrict__ gent, unsigned* counter,
             int32_t* __restrict__ scal) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ bool last;
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int ng = gridDim.x;
  const int b0 = init_block(init5, n_blocks);
  const int lo = g * G;
  const int nb = min(G, n_blocks - lo);
  const int4* src = reinterpret_cast<const int4*>(
      code + static_cast<size_t>(lo) * kE);
  int4* s4 = reinterpret_cast<int4*>(sm);
  for (int i = t; i < nb * (kE / 16); i += kT) s4[i] = src[i];
  __syncthreads();
  // state t on entry to the group; init5's state starts at its block
  int x = t == kInit ? kNone : t;
  for (int i = 0; i < nb; ++i) {
    if (t == kInit && lo + i == b0) x = kInit;
    path[static_cast<size_t>(lo + i) * kE + t] = static_cast<uint8_t>(x);
    if (x != kNone) x = sm[i * kE + x];
  }
  fg[g * kE + t] = static_cast<uint8_t>(x);
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == static_cast<unsigned>(ng - 1);
  __syncthreads();
  if (!last) return;

  // the last CTA: every group's entering state, from init5's group
  __threadfence();
  const int4* f4 = reinterpret_cast<const int4*>(fg);
  for (int i = t; i < ng * (kE / 16); i += kT) s4[i] = __ldcg(f4 + i);
  __syncthreads();
  if (t == 0) {
    const int g0 = b0 < n_blocks ? b0 / G : ng;
    int y = kNone;
    for (int i = 0; i < ng; ++i) {
      if (i == g0) y = kInit;
      gent[i] = static_cast<uint8_t>(y);
      if (y != kNone) y = sm[i * kE + y];
    }
    scal[0] = 0;
    if (g0 == ng) {  // no event: the walk leaves the state as it found it
      scal[1] = init5[3];
      scal[2] = init5[4];
      scal[3] = init5[2];
      scal[4] = init5[0];
      scal[5] = init5[1];
    }
  }
}

// path == nullptr: a 1-block walk, whose entry is init5 and which writes
// all of scal itself.
__global__ void __launch_bounds__(kT)
walk_emit(const int32_t* __restrict__ packed, int n_blocks,
          const int32_t* __restrict__ init5,
          const uint16_t* __restrict__ rec, const uint8_t* __restrict__ path,
          const uint8_t* __restrict__ gent, int G, int32_t* __restrict__ ei,
          int32_t* __restrict__ el, int32_t* __restrict__ es,
          int32_t* __restrict__ cnt, int32_t* __restrict__ scal) {
  __shared__ __align__(16) uint16_t tab[kNodes];
  __shared__ int n_rows;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int start = b * kBP;
  const size_t o = static_cast<size_t>(start);
  const int e = path ? path[static_cast<size_t>(b) * kE + gent[b / G]]
                     : (init_block(init5, n_blocks) == 0 ? kInit : kNone);
  if (e != kNone) {
    build_table(tab, packed + o, t);
    __syncthreads();
  }
  if (t == 0) {
    int x = 2 * (init5[0] - start) + init5[1];
    int cur_sel = init5[2], cur_pos = init5[3], cur_typ = init5[4];
    if (e < kNCand) {  // entered from block b - 1's last event
      const size_t pb = static_cast<size_t>(b - 1) * kE;
      const int r = rec[pb + path[pb + gent[(b - 1) / G]]];
      x = e;
      cur_pos = start - kBP + ((r & 0xFFF) >> 1);
      cur_typ = r & 1;
      cur_sel = (r >> 12) & 1;
    }
    int c = 0;
    int n = 0;
    if (e != kNone) {
      while (x < kNodes) {
        if (cur_sel) {
          ei[o + c] = start + (x >> 1);
          el[o + c] = cur_pos + 1;
          es[o + c] = cur_pos < 0 ? -1 : 2 * cur_pos + cur_typ;
          ++c;
        }
        const int h = tab[x];
        cur_pos = start + (x >> 1);
        cur_typ = x & 1;
        cur_sel = h >> 13;
        x = h & kNodeMask;
        ++n;
      }
    }
    n_rows = c;
    cnt[b] = c;
    if (n == 0) {
      if (!path) {  // no event: the walk leaves the state as it found it
        scal[0] = 0;
        scal[1] = init5[3];
        scal[2] = init5[4];
        scal[3] = init5[2];
        scal[4] = init5[0];
        scal[5] = init5[1];
      }
    } else {
      if (path) {
        atomicAdd(scal, n);
      } else {
        scal[0] = n;
      }
      const bool ended = x >= kEnded;
      if (ended || b == n_blocks - 1) {  // the walk leaves from here
        scal[1] = cur_pos;
        scal[2] = cur_typ;
        scal[3] = cur_sel;
        scal[4] = ended ? -1 : start + (x >> 1);
        scal[5] = ended ? x - kEnded : x & 1;
      }
    }
  }
  __syncthreads();
  // -1 past the rows: a ragged head, then 16-byte stores
  const int c = n_rows;
  const int c4 = (c + 3) & ~3;
  int32_t* outs[3] = {ei + o, el + o, es + o};
  for (int a = 0; a < 3; ++a) {
    if (c + t < c4) outs[a][c + t] = -1;
    int4* o4 = reinterpret_cast<int4*>(outs[a]);
    for (int i = c4 / 4 + t; i < kBP / 4; i += kT) {
      o4[i] = make_int4(-1, -1, -1, -1);
    }
  }
}

struct Work {
  uint16_t* rec;
  uint8_t *code, *path, *fg, *gent;
  unsigned* counter;
  int64_t bytes;
};

// The scratch: records (2 B per block and state), codes and paths (1 B
// each), the groups' exits and entering states, and the counter.
Work carve(void* base, int n_blocks) {
  const int G = group_size(n_blocks);
  const int64_t ng = (n_blocks + G - 1) / G;
  const int64_t n = static_cast<int64_t>(n_blocks) * kE;
  const int64_t o_code = 2 * n, o_path = o_code + n, o_fg = o_path + n;
  const int64_t o_gent = o_fg + ng * kE;
  const int64_t o_ctr = (o_gent + ng + 15) / 16 * 16;
  uint8_t* p = static_cast<uint8_t*>(base);
  Work wk;
  wk.bytes = o_ctr + 16;
  if (!p) return wk;
  wk.rec = reinterpret_cast<uint16_t*>(p);
  wk.code = p + o_code;
  wk.path = p + o_path;
  wk.fg = p + o_fg;
  wk.gent = p + o_gent;
  wk.counter = reinterpret_cast<unsigned*>(p + o_ctr);
  return wk;
}

}  // namespace

// Bytes of device scratch that spsp_walk needs (16-byte aligned).
extern "C" int64_t spsp_walk_work_bytes(int n_blocks) {
  return n_blocks > 1 ? carve(nullptr, n_blocks).bytes : 0;
}

// One pass of a walk over n_blocks > 1 blocks: 0 maps, 1 compose, 2 emit,
// in that order on one stream (spsp_walk runs all three). packed: n_blocks
// * 2048 int32 words, 16-byte aligned; init5: 5 int32 on the device;
// work: spsp_walk_work_bytes bytes, 16-byte aligned. Outputs: ei/el/es
// (n_blocks, 2048), cnt (n_blocks,), scal (6,).
extern "C" int spsp_walk_pass(int pass, const int32_t* packed, int n_blocks,
                              const int32_t* init5, int32_t* ei, int32_t* el,
                              int32_t* es, int32_t* cnt, int32_t* scal,
                              void* work, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(work, n_blocks);
  const int G = group_size(n_blocks);
  const int ng = (n_blocks + G - 1) / G;
  if (pass == 0) {
    walk_maps<<<n_blocks, kT, 0, st>>>(packed, n_blocks, init5, wk.rec,
                                      wk.code, wk.counter);
  } else if (pass == 1) {
    const int smem = (G > ng ? G : ng) * kE;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          walk_compose, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    walk_compose<<<ng, kT, smem, st>>>(n_blocks, G, init5, wk.code, wk.path,
                                       wk.fg, wk.gent, wk.counter, scal);
  } else {
    walk_emit<<<n_blocks, kT, 0, st>>>(packed, n_blocks, init5, wk.rec,
                                       wk.path, wk.gent, G, ei, el, es, cnt,
                                       scal);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole walk: one launch of walk_emit for a 1-block walk (work may
// be null), else the three passes.
extern "C" int spsp_walk(const int32_t* packed, int n_blocks,
                         const int32_t* init5, int32_t* ei, int32_t* el,
                         int32_t* es, int32_t* cnt, int32_t* scal,
                         void* work, void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_blocks == 1) {
    walk_emit<<<1, kT, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, 1, init5, nullptr, nullptr, nullptr, 1, ei, el, es, cnt,
        scal);
    return static_cast<int>(cudaGetLastError());
  }
  for (int pass = 0; pass < 3; ++pass) {
    const int err = spsp_walk_pass(pass, packed, n_blocks, init5, ei, el, es,
                                   cnt, scal, work, stream);
    if (err) return err;
  }
  return 0;
}
