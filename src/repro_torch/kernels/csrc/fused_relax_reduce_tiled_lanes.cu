// Lane-batched tiled fused frontier relax + segment reduce for Hopper
// (sm_90a): kernel K7.
//
// Replaces the TPU kernel `_kernel_tiled_lanes` (with its loop
// `_tile_loop`) launched by `_fused_lanes_tiled` in
// src/repro/kernels/fused_relax_reduce.py.  It computes what K3
// (fused_relax_reduce_lanes.cu) computes over a (V, Q) frontier-masked
// lane table, for a table the residency budget keeps out of the pinned
// path.
//
// The copy unit.  The TPU kernel copies the (vblk, Q) slot tiles that a
// chunk's sources active in some lane fall in, because a TPU core cannot
// gather from device memory and its VMEM copies move contiguous blocks.
// Hopper gathers at 32-byte-sector granularity and cp.async copies 16 (or
// 4) bytes to any shared-memory address, so here the copy unit is what a
// cell reads: the block's lane-group columns of one source row.  At
// RMAT-18 and Q = 16 a cell copies a few KB, not 225 tiles of 48 KB.
//
// Launch shape: K3's (segment block, 32-lane group) grid, its chunk
// stage and its owner-thread fold (frr_lanes.cuh; the piece's stage and
// row copies, shared with K8, are in frr_tiles.cuh).  A block walks its
// live cells in two pieces of EBLK / 2 positions each, one position a
// thread.  A piece is staged as K3 stages a chunk, with two changes: a
// position whose source is dead in every lane (the OR table `act`) gets
// key -1, since its messages are all the identity and change no
// accumulator (so a piece with no row left, as in most cells of a chunk
// that straddles two shards' sorted runs, copies and folds nothing); and
// src[k] holds k itself, the position's row in the row buffer, while the
// source's row index goes to `row_src`.  The block then copies its
// group's gw columns of each kept position's row, 16-byte pieces when
// Q % 4 == 0 and 4-byte ones otherwise, into the piece's half of a row
// buffer of two halves, min(Q, 32) floats a row (64 KB at 32 lanes,
// 32 KB at 16).  Pipeline: while piece i is folded, piece i+1's rows are
// in flight (one commit group a piece) and piece i+2's edges are loaded
// into registers.  With K3's 38 KB of accumulators and stage and the
// 2 KB `row_src` that is at most 104 KB a block, so two blocks fit an SM.
// The fold is K3's fold_lane_list over the staged positions in order, so
// each (segment, lane) combines the same messages in the same order as
// K3 and the result is K3's bit for bit, sum included.  `dbg` counts
// [cells, staged rows] once per (cell, row), whatever the lane groups;
// the bytes are rows * Q * 4 over all groups.
//
// Bound: K3's.  The staged bytes are the gathered bytes, so the round's
// data needs what it needs for K3: each edge's source id and mask, each
// edge active in some lane's id and weight, the (V, Q) table, the inbox.
// What this version pays beyond K3 is three block barriers a piece, and
// a piece's copies land in about the time a piece takes to fold, so
// smaller pieces (more barriers, less fold to cover a copy) run slower.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_tiled_lanes_kernel(const float* __restrict__ gval,
                       const int32_t* __restrict__ src,
                       const float* __restrict__ w,
                       const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ act,
                       const uint8_t* __restrict__ unitw,
                       const int32_t* __restrict__ blk_ptr,
                       const int32_t* __restrict__ blk_chunk,
                       const uint8_t* __restrict__ chunk_act,
                       int num_edges, int num_segments, int num_slots, int Q,
                       float* __restrict__ out, int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;                // piece h in positions h * HALF..
  __shared__ int32_t row_src[EBLK];
  extern __shared__ __align__(16) float row_s[];    // [2][HALF][lw]
  const int t = threadIdx.x & 31;
  const int c0 = blockIdx.y * LGRP;
  const int lane_q = c0 + t;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - c0);
  const bool on = lane_q < Q;
  const bool unit = on && unitw[lane_q] != 0;
  clear_lane_acc<KIND>(acc);

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  auto next_live = [&](int p) {           // block-uniform
    while (p < p1 && !chunk_act[blk_chunk[p]]) ++p;
    return p;
  };
  // The block walks pieces (cell p, half h) in order.  At each step the
  // current piece's rows are in flight, the next piece is staged from
  // registers and its row copies committed, and the piece after it is
  // loaded into registers, before the current piece is folded.
  auto load = [&](int p, int h) {
    return p < p1 ? load_edge(src, w, act, ids,
                              blk_chunk[p] * EBLK + h * HALF + threadIdx.x,
                              num_edges)
                  : EdgeRegs{0, 0, 0.0f, false};
  };
  auto advance = [&](int& p, int& h) {
    if (h == 0) {
      h = 1;
    } else {
      h = 0;
      p = next_live(p + 1);
    }
  };
  auto stage = [&](int p, int h, const EdgeRegs& x) {  // returns the rows
    const int n = p < p1 ? stage_position(st, row_src, x,
                                          h * HALF + threadIdx.x, num_slots,
                                          seg0)
                         : 0;
    const bool any = __syncthreads_or(n);
    if (any)
      copy_rows(row_s + h * HALF * lw, st, row_src, gval, h * HALF, Q, c0,
                gw, lw);
    cp_async_commit();
    return any ? n : -1;
  };

  int rows = 0, cells = 0;
  int cp = next_live(blk_ptr[blockIdx.x]), ch = 0;   // the current piece
  int np = cp, nh = ch;                              // the next piece
  advance(np, nh);
  EdgeRegs x = load(cp, ch);
  const EdgeRegs x1 = load(np, nh);
  int n_cur = stage(cp, ch, x);
  x = x1;
  while (cp < p1) {
    int qp = np, qh = nh;                 // the piece after the next
    advance(qp, qh);
    const EdgeRegs xq = load(qp, qh);
    const int n_next = stage(np, nh, x);
    x = xq;
    cp_async_wait_prev();                 // the current piece has landed
    if (n_cur >= 0) {
      rows += n_cur;
      fold_lane_list<RELAX, KIND>(
          acc, st, HalfPos{ch * HALF}, HALF,
          StagedRows{row_s + ch * HALF * lw, ch * HALF, lw, t}, on, unit);
    }
    cells += ch == 0;
    __syncthreads();                      // the piece is read before reuse
    cp = np;
    ch = nh;
    np = qp;
    nh = qh;
    n_cur = n_next;
  }

  if (dbg != nullptr && blockIdx.y == 0) {
    rows = __reduce_add_sync(0xffffffffu, rows);
    if (t == 0 && rows) atomicAdd(dbg + 1, rows);
    if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
  }
  for (int k = threadIdx.x; k < SBLK * LGRP; k += THREADS) {
    const int d = seg0 + k / LGRP;
    const int q = c0 + k % LGRP;
    if (d < num_segments && q < Q)
      out[static_cast<size_t>(d) * Q + q] = acc[k / LGRP][k % LGRP];
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `act` is the (E,) uint8 flags of
// valid edges active in some lane (they stand in for the mask), `unitw`
// (Q,) uint8; `dbg` ((2,) int32) may
// be null.  The table must be 16-byte aligned.
extern "C" int frr_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const int32_t* ids, const uint8_t* act, const uint8_t* unitw,
    const int32_t* blk_ptr, const int32_t* blk_chunk,
    const uint8_t* chunk_act, int num_edges, int num_segments,
    int num_blocks, int num_slots, int Q, float* out, int32_t* dbg,
    int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lane_row_smem(Q);
  dim3 grid(num_blocks, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_TL_ARGS gval, src, w, ids, act, unitw, blk_ptr, blk_chunk, \
                    chunk_act, num_edges, num_segments, num_slots, Q, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_tiled_lanes_kernel<ADD_W, KIND_MIN>, grid,
                            block, smem, s, FRR_TL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_tiled_lanes_kernel<MUL_W, KIND_SUM>, grid,
                            block, smem, s, FRR_TL_ARGS);
#undef FRR_TL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
