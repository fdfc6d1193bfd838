// B1: the whole-matrix early-exit cascade decide ("quit when you can").
//
// Replaces repro/kernels/cascade_kernel.py cascade_pallas (its pallas_call
// at :153).  Each row of a QWYC-ordered (N, T) f32 score matrix walks the T
// thresholds, 1-based exit steps, and stops once it has exited.  A row still
// active at T is decided by g >= beta (beta as f32, which is how the
// reference compares its f32 partial sums with its static Python float).
// Outputs: decisions (int32 0/1) and exit_step (int32, 1-based, T when the
// row never exited).
//
// What bounds it on an H100: bytes in principle (a row reads only the
// scores up to its exit; one add and two compares a step, far below the
// card's ratio of operations to bytes), and in practice latency: the steps
// of a row are a chain of f32 adds that must stay in order for the partial
// sums to be bit-identical to the plain version's, so a warp costs its
// longest row's steps one after another, and its loads must arrive ahead
// of them.
//
// Design: a lane owns a row and a CTA is one warp of 32 rows (N = 2000
// takes 63 CTAs, one an SM, where the thread-per-row frame of 256-row CTAs
// took 8).  The loads are taken off the chain: the warp stages its rows'
// scores in tiles of 32 x 32 (4 KB), with the tile's slice of eps_pos and
// eps_neg, in a ring of 8 tiles in shared memory, so shared memory does
// not grow with T and up to 8 tiles (32 KB) are in flight while the lanes
// walk the oldest.  Where the rows are 16-byte aligned (T % 4 == 0) a tile
// is three requests to the Tensor Memory Accelerator (cp.async.bulk.tensor
// on tensor maps of the scores, 2-D, the tile swizzled by 128 bytes so a
// lane's 16-byte reads of its row hit 32 distinct banks a quarter-warp,
// and of each threshold row, 1-D), counted in by the tile's mbarrier; rows
// past N and columns past T arrive as zeros.  Otherwise each lane copies
// the still-active rows' columns 4 bytes at a time (cp.async, into the same
// layout) and arrives on the mbarrier when they land.  (Issuing a tile
// from the lanes, as 16-byte cp.async copies or as one bulk copy a row,
// cost the warp more cycles than its walk of the tile.)  Each step is
// threshold_mark (threshold_step.cuh): an add with no select and a mark
// where the sum leaves the thresholds, so a step's loop-carried chain is
// one f32 add; an active row's first mark retires it (threshold_take, on
// the sum re-added to that step).  Quit when you can: after each tile a
// ballot stops the warp once none of its rows is active; the tiles
// already in flight are the only ones read past that point.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "threshold_step.cuh"

namespace {

constexpr int kTile = 32;  // columns (and rows) of a staged tile
constexpr int kRing = 8;   // tiles in a warp's ring, all in flight
constexpr int kRows = 32;  // rows a CTA of one warp takes, one a lane

struct __align__(1024) Ring {
  float scores[kRing][kRows * kTile];  // 128-byte swizzled rows
  float eps[kRing][2][kTile];          // eps_pos, eps_neg: 128 bytes each
  uint64_t bars[kRing];
};

// the word of row r, column c in a 128-byte swizzled tile: the 16-byte
// chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTile + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// an arrive that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the box of a 2-D `map` at (column x, row y) into `dst`, counted on `bar`
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, int x, int y,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 1-D `map` at x into `dst`, counted on `bar`
__device__ __forceinline__ void tma_load1(void* dst, const CUtensorMap* map, int x,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_addr(bar))
      : "memory");
}

struct Maps {
  CUtensorMap scores, eps_pos, eps_neg;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// an arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

struct Args {
  const float* scores;  // (n, T), for the 4-byte copies
  const float* eps_pos;
  const float* eps_neg;
  int n, T, tma;
  float beta;
  int* dec_out;
  int* exit_out;
};

// Stage tile k (columns [k * 32, k * 32 + 32)) of the warp's rows into
// slot b: a tensor request each for the scores and the two threshold
// rows, or 4-byte copies of the rows that `live` flags.
__device__ __forceinline__ void stage_tile(Ring& ring, int b, int k, const Args& a,
                                           const Maps& maps, int row0, unsigned live,
                                           int lane) {
  const int c0 = k * kTile;
  if (a.tma) {
    if (lane == 0) {
      mbar_arrive_expect(&ring.bars[b], sizeof(ring.scores[b]) + sizeof(ring.eps[b]));
      tma_load2(ring.scores[b], &maps.scores, c0, row0, &ring.bars[b]);
      tma_load1(ring.eps[b][0], &maps.eps_pos, c0, &ring.bars[b]);
      tma_load1(ring.eps[b][1], &maps.eps_neg, c0, &ring.bars[b]);
    }
    return;
  }
  const int c = c0 + lane;
  if (c < a.T) {
    for (int r = 0; r < kRows; ++r) {
      if ((live >> r) & 1u)
        cp_async4(&ring.scores[b][swz(r, lane)],
                  a.scores + static_cast<size_t>(row0 + r) * a.T + c);
    }
    cp_async4(&ring.eps[b][0][lane], a.eps_pos + c);
    cp_async4(&ring.eps[b][1][lane], a.eps_neg + c);
  }
  cp_async_arrive(&ring.bars[b]);
}

__global__ void __launch_bounds__(32)
    cascade_kernel(const __grid_constant__ Maps maps, const Args a) {
  __shared__ Ring ring;
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + lane;
  const bool row_ok = i < a.n;
  float g = 0.0f;
  bool active = row_ok;
  bool dec = false;
  int ex = a.T;
  unsigned live = __ballot_sync(0xffffffffu, active);
  if (lane == 0) {
    // a tensor tile is one arrive (lane 0's) and its bytes; the 4-byte
    // copies are one arrive a lane
    for (int b = 0; b < kRing; ++b) mbar_init(&ring.bars[b], a.tma ? 1 : 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  const int n_tiles = (a.T + kTile - 1) / kTile;
  int issued = 0;
  for (; issued < min(kRing, n_tiles); ++issued)
    stage_tile(ring, issued, issued, a, maps, row0, live, lane);
  int k = 0;
  for (; k < n_tiles; ++k) {
    const int b = k % kRing;
    mbar_wait(&ring.bars[b], (k / kRing) & 1);
    const float* tile = ring.scores[b];
    const float* tp = ring.eps[b][0];
    const float* tn = ring.eps[b][1];
    const int c0 = k * kTile;
    const int tc = min(kTile, a.T - c0);
    const float g0 = g;
    unsigned marks = 0;
    if (tc == kTile) {
      float f[kTile];
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(tile + swz(lane, 4 * q));
        f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(tp + 4 * q);
        const float4 n = *reinterpret_cast<const float4*>(tn + 4 * q);
        threshold_mark(g, marks, f[4 * q], p.x, n.x, 4 * q);
        threshold_mark(g, marks, f[4 * q + 1], p.y, n.y, 4 * q + 1);
        threshold_mark(g, marks, f[4 * q + 2], p.z, n.z, 4 * q + 2);
        threshold_mark(g, marks, f[4 * q + 3], p.w, n.w, 4 * q + 3);
      }
      if (active && marks) {
        const int j = __ffs(static_cast<int>(marks)) - 1;
        float gj = g0;
#pragma unroll
        for (int q = 0; q < kTile; ++q) gj += q <= j ? f[q] : 0.0f;
        // the adds past j add +0.0f: g0 + f[0] + ... + f[j] is unchanged,
        // a -0.0 sum aside, which no threshold test tells from +0.0
        threshold_take(gj, tp[j], tn[j], c0 + j + 1, active, dec, ex);
      }
    } else {
      for (int j = 0; j < tc; ++j) threshold_mark(g, marks, tile[swz(lane, j)], tp[j], tn[j], j);
      if (active && marks) {
        const int j = __ffs(static_cast<int>(marks)) - 1;
        float gj = g0;
        for (int q = 0; q <= j; ++q) gj += tile[swz(lane, q)];
        threshold_take(gj, tp[j], tn[j], c0 + j + 1, active, dec, ex);
      }
    }
    // quit when you can; the ballot also ends every lane's reads of this
    // slot before the copies issued into it below
    live = __ballot_sync(0xffffffffu, active);
    if (!live) break;
    if (issued < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_tile(ring, b, issued, a, maps, row0, live, lane);
      ++issued;
    }
  }
  // no copy may land after the CTA has left: wait for the tiles in flight
  for (int t = k + 1; t < issued; ++t) mbar_wait(&ring.bars[t % kRing], (t / kRing) & 1);
  if (row_ok) {
    a.dec_out[i] = (active ? (g >= a.beta) : dec) ? 1 : 0;
    a.exit_out[i] = ex;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// an f32 tensor map of `rows` x `cols` (row stride cols; rows == 0: a
// 1-D map of cols) in boxes of 32 columns by 32 rows
bool encode(EncodeTiled fn, CUtensorMap* map, const float* base, int rows, int cols,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {kTile, kRows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows ? 2 : 1, const_cast<float*>(base), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// `blocks` CTAs of one warp each (the wrapper's cascade_geometry).  tma:
// T % 4 == 0 and the three arrays 16-byte aligned (the tensor maps'
// conditions); else the 4-byte copies.
extern "C" int cascade_launch(const float* scores, const float* eps_pos,
                              const float* eps_neg, int n, int T, float beta, int tma,
                              int blocks, int threads, int* dec_out, int* exit_out,
                              cudaStream_t stream) {
  if (threads != 32) return static_cast<int>(cudaErrorInvalidValue);
  Maps maps{};
  if (tma) {
    static EncodeTiled fn = nullptr;
    if (!fn) {
      void* p = nullptr;
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err =
          cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (found != cudaDriverEntryPointSuccess || !p)
        return static_cast<int>(cudaErrorSymbolNotFound);
      fn = reinterpret_cast<EncodeTiled>(p);
    }
    if (!encode(fn, &maps.scores, scores, n, T, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode(fn, &maps.eps_pos, eps_pos, 0, T, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !encode(fn, &maps.eps_neg, eps_neg, 0, T, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{scores, eps_pos, eps_neg, n, T, tma, beta, dec_out, exit_out};
  cascade_kernel<<<blocks, threads, 0, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}
