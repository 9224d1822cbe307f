// Shared pieces of the fused relax + reduce kernels (K1, K2) and the
// segment reduce (K9): the launch constants, the relax and combine of each
// pairing, and the warp fold of one edge chunk's messages into per-warp
// shared-memory accumulators.
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
  if (RELAX == ADD_W) return __fadd_rn(v, __ldg(w + e));
  if (RELAX == ADD_ONE) return __fadd_rn(v, 1.0f);
  return __fmul_rn(v, __ldg(w + e));
}

// Set every per-warp accumulator to the identity (all threads call it).
template <int KIND>
__device__ __forceinline__ void clear_acc(float (*acc)[SBLK]) {
  for (int t = threadIdx.x; t < NWARP * SBLK; t += THREADS)
    (&acc[0][0])[t] = identity<KIND>();
}

// Per-edge messages for the warp fold.  `valid(e)` says whether edge e
// may contribute (it is read before the edge's destination); `value(e)`
// is its message, read only for edges that land in the block.
template <int RELAX>
struct RelaxMsg {                 // K1, K2: relax(gval[src[e]], w[e]) where mask[e]
  const float* gval;              // the frontier-masked value table
  const int32_t* src;
  const float* w;
  const uint8_t* mask;
  __device__ __forceinline__ bool valid(int e) const {
    return __ldg(mask + e) != 0;
  }
  __device__ __forceinline__ float value(int e) const {
    return relax<RELAX>(__ldg(gval + __ldg(src + e)), w, e);
  }
};

// Fold the messages of the `n` edges edges(0), ..., edges(n - 1) to
// segments [seg0, seg0 + SBLK) into the calling warp's accumulator
// acc[warp]: warp k takes the 32-edge batches k, k + NWARP, ...  Padding
// edges (e >= num_edges, or !msg.valid(e)) never have their message read.
template <int KIND, class Msg, class Edges>
__device__ __forceinline__ void fold_list(
    float (*acc)[SBLK], float (*msg_s)[32], const Msg& msg,
    const int32_t* __restrict__ ids, const Edges& edges, int n,
    int num_edges, int seg0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = warp; b * 32 < n; b += NWARP) {
    const int k = b * 32 + lane;
    const int e = k < n ? edges(k) : num_edges;
    int key = SBLK;                       // SBLK: no contribution
    float m = identity<KIND>();
    if (e < num_edges && msg.valid(e)) {
      const int local = ids[e] - seg0;
      if (local >= 0 && local < SBLK) {
        m = msg.value(e);
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

struct ChunkEdges {               // the EBLK edges of one chunk, in order
  int e0;
  __device__ __forceinline__ int operator()(int k) const { return e0 + k; }
};

// Fold edge chunk `j`'s messages to segments [seg0, seg0 + SBLK).
template <int KIND, class Msg>
__device__ __forceinline__ void fold_edges(
    float (*acc)[SBLK], float (*msg_s)[32], const Msg& msg,
    const int32_t* __restrict__ ids, int j, int num_edges, int seg0) {
  fold_list<KIND>(acc, msg_s, msg, ids, ChunkEdges{j * EBLK}, EBLK,
                  num_edges, seg0);
}

// The relax fold of K1 and K2: `gval` is the frontier-masked value table.
template <int RELAX, int KIND>
__device__ __forceinline__ void fold_chunk(
    float (*acc)[SBLK], float (*msg_s)[32], const float* __restrict__ gval,
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ ids, int j,
    int num_edges, int seg0) {
  fold_edges<KIND>(acc, msg_s, RelaxMsg<RELAX>{gval, src, w, mask}, ids, j,
                   num_edges, seg0);
}

// Segment t of the block: the NWARP accumulators folded in warp order.
template <int KIND>
__device__ __forceinline__ float fold_warps(float (*acc)[SBLK], int t) {
  float r = acc[0][t];
  for (int k = 1; k < NWARP; ++k) r = combine<KIND>(r, acc[k][t]);
  return r;
}

}  // namespace frr
