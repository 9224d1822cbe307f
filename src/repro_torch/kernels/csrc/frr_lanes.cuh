// Shared pieces of the lane-batched fused relax + reduce kernels (K3, K4):
// one (segment block, edge chunk) cell folded into a (SBLK, LGRP)
// accumulator of query lanes, and how a worklist piece's accumulator
// reaches the inbox (K4, K8).
//
// The value table is (V, Q) row-major, one column per query; a launch's
// grid has a lane-group axis, and the block of lane group y serves lanes
// [LGRP*y, LGRP*y + LGRP).  K1's per-warp (SBLK,) accumulators do not
// scale with Q (8 warps x SBLK x Q floats is 128 KB at Q = 16), so here
// every accumulator cell has ONE owner thread instead:
//
//   warp k owns segments [32k, 32k + 32) of the block, and thread t of
//   every warp owns lane LGRP*y + t; acc[s][t] is touched only by thread
//   t of warp s / 32.
//
// A cell first stages its chunk's EBLK edges in shared memory (local
// segment key, source, weight; masked and out-of-block edges get key -1).
// Then each warp walks the staged edges in order, 32 at a time: a ballot
// picks the edges that land in its 32 segments, and for each of them, in
// edge order, all 32 threads gather their lane of the source's row (one
// coalesced row read), relax and combine into their own cell.  Up to four
// edges' gathers are in flight before they are combined, in order.  No
// atomics touch a value: each (segment, lane) combines its edges in chunk
// order, then edge order, so a sum repeats bit for bit and min is exact.
#pragma once

#include "frr_common.cuh"

namespace frr {

constexpr int LGRP = 32;                 // lanes per lane group (a warp)
constexpr int SEG_PER_WARP = SBLK / NWARP;
static_assert(SEG_PER_WARP == 32, "a warp owns 32 segments of a block");
constexpr int GATHER_DEPTH = 4;          // gathers in flight per warp

struct LaneStage {                       // one chunk's edges, staged
  int32_t key[EBLK];                     // local segment in [0, SBLK) or -1
  int32_t src[EBLK];
  float w[EBLK];
};

// Set the (SBLK, LGRP) accumulator to the identity (all threads call it).
template <int KIND>
__device__ __forceinline__ void clear_lane_acc(float (*acc)[LGRP]) {
  for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS)
    (&acc[0][0])[t] = identity<KIND>();
}

// Stage positions [k_lo, k_hi) of edge chunk `j` for segments [seg0,
// seg0 + SBLK) (all threads call it; the caller syncs before and after).
__device__ __forceinline__ void stage_chunk(
    LaneStage& st, const int32_t* __restrict__ src,
    const float* __restrict__ w, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ ids, int j, int num_edges, int seg0,
    int k_lo = 0, int k_hi = EBLK) {
  for (int k = k_lo + threadIdx.x; k < k_hi; k += THREADS) {
    const int e = j * EBLK + k;
    int key = -1;
    int s = 0;
    float wt = 0.0f;
    if (e < num_edges && mask[e]) {
      const int local = ids[e] - seg0;
      if (local >= 0 && local < SBLK) {
        key = local;
        s = src[e];
        wt = w[e];
      }
    }
    st.key[k] = key;
    st.src[k] = s;
    st.w[k] = wt;
  }
}

// Fold the staged edges at chunk positions pos(0), ..., pos(n - 1) into
// acc: thread t of warp k updates acc[32k + s][t] for lane `lane_q` (< Q,
// else it only follows the warp), reading its value of source s as
// rows(s).  `unit` makes add_w relax with weight 1.0 for this lane.
template <int RELAX, int KIND, class Pos, class Rows>
__device__ __forceinline__ void fold_lane_list(
    float (*acc)[LGRP], const LaneStage& st, const Pos& pos, int n,
    const Rows& rows, bool on, bool unit) {
  const int t = threadIdx.x & 31;
  const int s0 = (threadIdx.x >> 5) * SEG_PER_WARP;
  for (int b = 0; b < n; b += 32) {
    const int k_own = b + t < n ? pos(b + t) : -1;
    const int key = k_own >= 0 ? st.key[k_own] : -1;
    unsigned hits = __ballot_sync(0xffffffffu,
                                  key >= s0 && key < s0 + SEG_PER_WARP);
    while (hits) {                        // warp-uniform
      int ks[GATHER_DEPTH];
      float vs[GATHER_DEPTH];
#pragma unroll
      for (int u = 0; u < GATHER_DEPTH; ++u) {
        ks[u] = -1;
        vs[u] = identity<KIND>();
        if (hits) {
          const int k = __shfl_sync(0xffffffffu, k_own, __ffs(hits) - 1);
          hits &= hits - 1;
          ks[u] = k;
          if (on) vs[u] = rows(st.src[k]);
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER_DEPTH; ++u) {
        if (ks[u] >= 0 && on) {
          const int k = ks[u];
          float m;
          if (RELAX == MUL_W)
            m = __fmul_rn(vs[u], st.w[k]);
          else
            m = __fadd_rn(vs[u], unit ? 1.0f : st.w[k]);
          float& a = acc[st.key[k]][t];
          a = combine<KIND>(a, m);
        }
      }
    }
  }
}

struct StagePos {                 // every staged position, in order
  __device__ __forceinline__ int operator()(int k) const { return k; }
};

struct RangePos {                 // the positions k0, k0 + 1, ...
  int k0;
  __device__ __forceinline__ int operator()(int i) const { return k0 + i; }
};

struct TableRows {                // lane lane_q of the (V, Q) table
  const float* gval;
  int Q;
  int lane_q;
  __device__ __forceinline__ float operator()(int s) const {
    return __ldg(gval + static_cast<size_t>(s) * Q + lane_q);
  }
};

// Fold the whole staged chunk into acc (K3, K4): `gval` is the
// frontier-masked (V, Q) table.
template <int RELAX, int KIND>
__device__ __forceinline__ void fold_lanes(
    float (*acc)[LGRP], const LaneStage& st, const float* __restrict__ gval,
    int Q, int lane_q, bool unit) {
  fold_lane_list<RELAX, KIND>(acc, st, StagePos{}, EBLK,
                              TableRows{gval, Q, lane_q}, lane_q < Q, unit);
}

// Finish piece k of segment block i for lane group blockIdx.y (K4, K8),
// as finish_piece does for K2: the inbox columns when the block is one
// piece, else the piece's (SBLK, Q) row of `split` (its group's columns)
// and, in the last piece of the block to arrive for this group, the rows
// folded in piece order.  `acc` must be whole (the caller syncs).
template <int KIND>
__device__ __forceinline__ void finish_lane_piece(
    float (*acc)[LGRP], const Pieces& pc, int k, int i, int num_segments,
    int Q, float* __restrict__ out, float* __restrict__ split) {
  const int seg0 = i * SBLK;
  const int c0 = blockIdx.y * LGRP;
  const int slot = pc.piece_slot[k];
  const size_t row = static_cast<size_t>(SBLK) * Q;
  if (slot < 0) {
    for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS) {
      const int d = seg0 + t / LGRP;
      const int q = c0 + t % LGRP;
      if (d < num_segments && q < Q)
        out[static_cast<size_t>(d) * Q + q] = acc[t / LGRP][t % LGRP];
    }
    return;
  }
  for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS) {
    const int q = c0 + t % LGRP;
    if (q < Q)
      split[slot * row + static_cast<size_t>(t / LGRP) * Q + q] =
          acc[t / LGRP][t % LGRP];
  }
  const int k0 = pc.blk_piece[i];
  const int n = pc.blk_piece[i + 1] - k0;
  if (!arrive_last(pc.tickets + static_cast<size_t>(i) * gridDim.y +
                       blockIdx.y, n))
    return;
  const float* rows = split + pc.piece_slot[k0] * row;
  for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS) {
    const int d = seg0 + t / LGRP;
    const int q = c0 + t % LGRP;
    if (d >= num_segments || q >= Q) continue;
    const size_t at = static_cast<size_t>(t / LGRP) * Q + q;
    float r = __ldcg(rows + at);
    for (int s = 1; s < n; ++s) r = combine<KIND>(r, __ldcg(rows + s * row + at));
    out[static_cast<size_t>(d) * Q + q] = r;
  }
}

}  // namespace frr
