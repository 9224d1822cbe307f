// Shared pieces of the tiled fused relax + reduce kernels (K5-K8): the
// value table stays in device memory, and each live cell copies only the
// source rows it reads into shared memory before it folds them.
//
// The copy unit.  The TPU kernels copy the vblk-wide slot tiles that a
// chunk's active sources fall in, because a TPU core cannot gather from
// device memory and its VMEM copies move contiguous blocks.  Hopper
// gathers at 32-byte-sector granularity and cp.async copies 4 or 16
// bytes to any shared-memory address, so here the unit is what a cell
// reads: one source row (a lane group's columns of it, laned).
//
//   K5, K6 (unlaned): a cell stages gval[src[e]] of every chunk position
//   whose edge is active (act[e]: mask and a changed source) and lands in
//   the cell's block into an (EBLK,) slot indexed by chunk position; every
//   other position gets the identity, which is what the masked table
//   holds for an inactive source.  K1's fold then reads the slot where K1
//   reads the table (StagedMsg), so the result is K1's (K2's) bit for bit.
//
//   K7, K8 (laned): a cell runs in two halves of EBLK / 2 positions, one
//   position a thread.  A half is staged as K3 stages a chunk, with a
//   position dead in every lane (the OR flags `act`) dropped (key -1) and
//   src[k] = k, the position's row in the half's row buffer, the source
//   row going to `row_src`; the block then copies its lane group's
//   columns of each kept row.  K3's fold_lane_runs reads the rows by
//   position (StagedRows) in K3's windows, so the result is K3's (K4's)
//   bit for bit.
//
// A copy never reads past the table's last row: staged sources are
// valid edges' sources, which plan_launch checks are in range.
#pragma once

#include "frr_lanes.cuh"

namespace frr {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every committed group but the newest has landed (the
// caller then syncs the block before reading it).
__device__ __forceinline__ void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every committed group but the newest has landed, then make
// the landed data visible to the whole block.
__device__ __forceinline__ void cp_async_wait_prev() {
  cp_async_wait_group1();
  __syncthreads();
}

// ---------------------------------------------------------------------
// K5, K6: a cell's rows staged by chunk position
// ---------------------------------------------------------------------

// K1's message from the cell's staged rows: relax(stage_s[e - e0], w[e])
// where mask[e].
template <int RELAX>
struct StagedMsg {
  const float* stage_s;           // the cell's slot, by chunk position
  int e0;                         // the chunk's first edge
  const float* w;
  const uint8_t* mask;
  __device__ __forceinline__ bool valid(int e) const {
    return __ldg(mask + e) != 0;
  }
  __device__ __forceinline__ float value(int e) const {
    return relax<RELAX>(stage_s[e - e0], w, e);
  }
};

// A cell's edges as this thread stages them: positions threadIdx.x and
// threadIdx.x + THREADS, loaded into registers a cell ahead of the stage.
struct CellRegs {
  int id[EBLK / THREADS];
  int s[EBLK / THREADS];
  bool act[EBLK / THREADS];
};

// Chunk j's edges for this thread (num_edges 0: an empty cell).
__device__ __forceinline__ CellRegs load_cell(
    const int32_t* __restrict__ src, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ act, int j, int num_edges) {
  CellRegs x;
#pragma unroll
  for (int u = 0; u < EBLK / THREADS; ++u) {
    const int e = j * EBLK + u * THREADS + threadIdx.x;
    const bool in = e < num_edges;
    x.id[u] = in ? __ldg(ids + e) : -1;
    x.s[u] = in ? __ldg(src + e) : 0;
    x.act[u] = in && __ldg(act + e) != 0;
  }
  return x;
}

// Start staging a cell's rows for segments [seg0, seg0 + SBLK) into
// slot[0 .. EBLK) from its registers (all threads call it).  Returns the
// rows this thread copied.
template <int KIND>
__device__ __forceinline__ int stage_rows(float* slot,
                                          const float* __restrict__ gval,
                                          const CellRegs& x, int seg0) {
  int rows = 0;
#pragma unroll
  for (int u = 0; u < EBLK / THREADS; ++u) {
    const int k = u * THREADS + threadIdx.x;
    const int local = x.id[u] - seg0;
    if (x.act[u] && local >= 0 && local < SBLK) {
      cp_async4(slot + k, gval + x.s[u]);
      ++rows;
    } else {
      slot[k] = identity<KIND>();
    }
  }
  return rows;
}

// ---------------------------------------------------------------------
// K7, K8: a cell's rows staged in two halves
// ---------------------------------------------------------------------

constexpr int HALF = EBLK / 2;            // positions of a half
static_assert(HALF == THREADS, "a thread stages one position of a half");

// K3's stage of this thread's position k (in half k / HALF) for
// segments [seg0, seg0 + SBLK), with a dead position dropped, src[k] = k
// and the source row in row_src[k].  Returns 1 if it keeps a row.
__device__ __forceinline__ int stage_position(LaneStage& st,
                                              int32_t* row_src,
                                              const EdgeRegs& x, int k,
                                              int num_slots, int seg0) {
  const int local = x.id - seg0;
  const bool keep = x.on && local >= 0 && local < SBLK && x.s < num_slots;
  st.key[k] = keep ? local : -1;
  st.src[k] = k;
  st.w[k] = keep ? x.w : 0.0f;
  row_src[k] = x.s;
  return keep;
}

// Start copying columns [c0, c0 + gw) of the rows of positions
// [k0, k0 + HALF) with key >= 0 into buf[(k - k0) * lw + c] (all threads
// call it).  With Q % 4 == 0 the row pieces are 16-byte aligned and go 16
// bytes at a time.
__device__ __forceinline__ void copy_rows(float* buf, const LaneStage& st,
                                          const int32_t* row_src,
                                          const float* __restrict__ gval,
                                          int k0, int Q, int c0, int gw,
                                          int lw) {
  if ((Q & 3) == 0) {
    const int per = gw >> 2;
    for (int i = threadIdx.x; i < HALF * per; i += THREADS) {
      const int r = i / per, c = 4 * (i % per);
      if (st.key[k0 + r] >= 0)
        cp_async16(buf + r * lw + c,
                   gval + static_cast<size_t>(row_src[k0 + r]) * Q + c0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < HALF * gw; i += THREADS) {
      const int r = i / gw, c = i % gw;
      if (st.key[k0 + r] >= 0)
        cp_async4(buf + r * lw + c,
                  gval + static_cast<size_t>(row_src[k0 + r]) * Q + c0 + c);
    }
  }
}

struct StagedRows {               // lane column c of a staged row
  const float* buf;               // the half's row buffer
  int k0;                         // the half's first position
  int lw;
  __device__ __forceinline__ float operator()(int k, int c) const {
    return buf[(k - k0) * lw + c];
  }
};

// Shared memory of a laned row buffer: two halves of HALF rows of
// min(Q, LGRP) floats.
inline size_t lane_row_smem(int Q) {
  return 2 * static_cast<size_t>(HALF) * (Q < LGRP ? Q : LGRP) *
         sizeof(float);
}

}  // namespace frr
