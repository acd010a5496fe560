// Walk kernel: the serial chase of the super-k-mer event chain over
// packed successor words, emitting the FHS-selected boundaries.
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
// that holds nxt_pos; cnt[b] counts block b's rows. The final state goes
// to scal = [n_ev, cur_pos, cur_typ, cur_sel, nxt_pos, nxt_typ], which
// the next tile's walk starts from.
//
// What bounds it on the H100: latency. The chain is dependent: one event
// every W/2 positions or so on random sequence, some 400k steps for a
// 4 Mbp tile, and each step needs the previous step's word. Read from
// HBM, a step would cost a load latency of hundreds of ns; read from
// shared memory, it costs tens of cycles.
//
// What the design does about it: one block of 256 threads takes the
// place of the TPU's sequential grid. The threads stage the packed words
// block by block (2048 words, 8 KB) into shared memory with cp.async,
// double-buffered, so the next block's copy is in flight while thread 0
// chases the chain through the current one with the state in registers.
// An event at or past the block's end waits for the next block, as the
// loop condition of the TPU kernel does. Emits are stored straight to
// device memory; the wrapper fills the emit rows with -1 first, so rows
// past cnt are defined. One walk per launch: several walks at once (one
// block each) are later work.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBP = 2048;      // positions per block
constexpr int kThreads = 256;  // copy threads; thread 0 also walks
constexpr int kVec = 4;        // int32 words per 16-byte cp.async

__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int tid) {
  for (int i = tid * kVec; i < kBP; i += kThreads * kVec) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(int32_t) * kVec);
  }
}

__global__ void __launch_bounds__(kThreads)
walk_kernel(const int32_t* __restrict__ packed, int n_blocks,
            const int32_t* __restrict__ init5, int32_t* __restrict__ ei,
            int32_t* __restrict__ el, int32_t* __restrict__ es,
            int32_t* __restrict__ cnt, int32_t* __restrict__ scal) {
  __shared__ __align__(16) int32_t buf[2][kBP];
  const int tid = threadIdx.x;
  int npos = init5[0];
  int ntyp = init5[1];
  int cur_sel = init5[2];
  int cur_pos = init5[3];
  int cur_typ = init5[4];
  int n_ev = 0;

  stage(buf[0], packed, tid);
  __pipeline_commit();
  for (int b = 0; b < n_blocks; ++b) {
    // every thread commits one batch per step (empty past the end), so
    // waiting for all but the newest means block b has landed
    if (b + 1 < n_blocks) {
      stage(buf[(b + 1) & 1], packed + static_cast<size_t>(b + 1) * kBP,
            tid);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    if (tid == 0) {
      const int32_t* w = buf[b & 1];
      const int start = b * kBP;
      const int end = start + kBP;
      const size_t o = static_cast<size_t>(b) * kBP;
      int c = 0;
      while (npos >= 0 && npos < end) {
        if (cur_sel) {
          ei[o + c] = npos;
          el[o + c] = cur_pos + 1;
          es[o + c] = cur_pos < 0 ? -1 : 2 * cur_pos + cur_typ;
          ++c;
        }
        const int h = w[npos - start] >> (ntyp << 4);
        const int delta = h & 63;
        cur_pos = npos;
        cur_typ = ntyp;
        cur_sel = (h >> 7) & 1;
        npos = delta > 0 ? npos + delta : -1;
        ntyp = (h >> 6) & 1;
        ++n_ev;
      }
      cnt[b] = c;
    }
    // buffer b & 1 is restaged at step b + 1
    __syncthreads();
  }
  if (tid == 0) {
    scal[0] = n_ev;
    scal[1] = cur_pos;
    scal[2] = cur_typ;
    scal[3] = cur_sel;
    scal[4] = npos;
    scal[5] = ntyp;
  }
}

}  // namespace

// packed: n_blocks * 2048 int32 words, 16-byte aligned; init5: 5 int32
// on the device. Outputs: ei/el/es (n_blocks, 2048), cnt (n_blocks,),
// scal (6,).
extern "C" int spsp_walk(const int32_t* packed, int n_blocks,
                         const int32_t* init5, int32_t* ei, int32_t* el,
                         int32_t* es, int32_t* cnt, int32_t* scal,
                         void* stream) {
  if (n_blocks <= 0) return 0;
  walk_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, n_blocks, init5, ei, el, es, cnt, scal);
  return static_cast<int>(cudaGetLastError());
}
