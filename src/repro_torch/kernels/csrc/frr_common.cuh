// Shared pieces of the fused relax + reduce kernels (K1, K2): the launch
// constants, the relax and combine of each pairing, and the warp fold of
// one edge chunk into per-warp shared-memory accumulators.
//
// The fold.  A thread block of NWARP warps takes one EBLK-edge chunk;
// warp k takes the chunk's 32-edge batches k, k + NWARP, ...  Inside a
// batch, lanes that hit the same segment of the block are grouped with
// __match_any_sync; the lowest lane of a group folds the group in lane
// order and updates its warp's (SBLK,) accumulator.  `fold_warps` then
// folds the NWARP accumulators of one segment in warp order.  No atomics
// touch a value, so a sum is the same from run to run and a min is exact
// in any order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace frr {

constexpr int EBLK = 512;   // edges per chunk (must match the Python side)
constexpr int SBLK = 256;   // segments per block (must match the Python side)
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int BATCHES = EBLK / 32;

enum Relax { ADD_W = 0, ADD_ONE = 1, MUL_W = 2 };
enum Kind { KIND_MIN = 0, KIND_SUM = 1 };

template <int KIND>
__device__ __forceinline__ float identity() {
  return KIND == KIND_MIN ? INFINITY : 0.0f;
}

template <int KIND>
__device__ __forceinline__ float combine(float a, float b) {
  return KIND == KIND_MIN ? fminf(a, b) : __fadd_rn(a, b);
}

template <int RELAX>
__device__ __forceinline__ float relax(float v, const float* __restrict__ w,
                                       int e) {
  if (RELAX == ADD_W) return __fadd_rn(v, w[e]);
  if (RELAX == ADD_ONE) return __fadd_rn(v, 1.0f);
  return __fmul_rn(v, w[e]);
}

// Set every per-warp accumulator to the identity (all threads call it).
template <int KIND>
__device__ __forceinline__ void clear_acc(float (*acc)[SBLK]) {
  for (int t = threadIdx.x; t < NWARP * SBLK; t += THREADS)
    (&acc[0][0])[t] = identity<KIND>();
}

// Fold edge chunk `j`'s messages to segments [seg0, seg0 + SBLK) into the
// calling warp's accumulator acc[warp].  `gval` is the frontier-masked
// value table; padding edges (mask 0 or e >= num_edges) are never read
// past their mask.
template <int RELAX, int KIND>
__device__ __forceinline__ void fold_chunk(
    float (*acc)[SBLK], float (*msg_s)[32], const float* __restrict__ gval,
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ ids, int j,
    int num_edges, int seg0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e0 = j * EBLK;
  for (int b = warp; b < BATCHES; b += NWARP) {
    const int e = e0 + b * 32 + lane;
    int key = SBLK;                       // SBLK: no contribution
    float m = identity<KIND>();
    if (e < num_edges && mask[e]) {
      const int local = ids[e] - seg0;
      if (local >= 0 && local < SBLK) {
        m = relax<RELAX>(gval[src[e]], w, e);
        key = local;
      }
    }
    msg_s[warp][lane] = m;
    __syncwarp();
    const unsigned grp = __match_any_sync(0xffffffffu, key);
    if (key < SBLK && lane == __ffs(grp) - 1) {
      float r = m;
      unsigned rest = grp & (grp - 1);    // the other lanes, ascending
      while (rest) {
        r = combine<KIND>(r, msg_s[warp][__ffs(rest) - 1]);
        rest &= rest - 1;
      }
      acc[warp][key] = combine<KIND>(acc[warp][key], r);
    }
    __syncwarp();
  }
}

// Segment t of the block: the NWARP accumulators folded in warp order.
template <int KIND>
__device__ __forceinline__ float fold_warps(float (*acc)[SBLK], int t) {
  float r = acc[0][t];
  for (int k = 1; k < NWARP; ++k) r = combine<KIND>(r, acc[k][t]);
  return r;
}

}  // namespace frr
