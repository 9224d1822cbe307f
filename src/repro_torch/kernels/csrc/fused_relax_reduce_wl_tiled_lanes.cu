// Lane-batched tiled worklist launch of the fused frontier relax +
// segment reduce for Hopper (sm_90a): kernel K8.
//
// Replaces the TPU kernel `_kernel_wl_tiled_lanes` launched by
// `_fused_lanes_tiled_wl` in src/repro/kernels/fused_relax_reduce.py.
// K8 is the tiled twin of K4 (fused_relax_reduce_wl_lanes.cu): a
// worklist of live (segment block, edge chunk) cells, j-major, planned
// over the OR-across-lanes frontier; each cell writes one (SBLK, Q)
// partial that K4's laned fold (frr_wl_lanes_fold) combines into the
// inbox in cell-list order.
//
// The copy unit.  The TPU kernel copies the (vblk, Q) slot tiles that a
// cell's sources active in some lane fall in (at RMAT-18 and Q = 16 a
// cell copied most of the table's 348 tiles).  Here a cell copies what
// it reads: K7's cell (frr_tiles.cuh).  It runs in two pieces of EBLK / 2
// positions; a piece is staged as K3 stages a chunk, with a position
// dead in every lane dropped, and the block copies its lane group's
// columns of each kept row (16-byte pieces when Q % 4 == 0, else 4-byte
// ones) into the piece's half of a row buffer.  The fold is K3's
// fold_lane_list over the piece's positions in order into the cell's
// (SBLK, LGRP) accumulator, so each (segment, lane) of a cell combines
// the same messages in the same order as K4 and K8's partials, and
// after K4's fold its inbox, are K4's bit for bit, sum included.  A
// piece that keeps no row copies and folds nothing.
//
// Launch shape: K4's (cell, 32-lane group) grid, with blocks taking
// groups of `cpb` consecutive cells (frr_tiles.cuh block_cell): one
// block per group for a host plan, a fixed grid striding over the groups
// below *nlive for a device plan.  A block walks its cells' pieces with
// K7's pipeline: while piece i is folded, piece i+1's rows are in flight
// (one commit group a piece) and piece i+2's edges are loaded into
// registers.  After a cell's second piece, each thread writes and
// clears its own accumulator cells (thread t of warp k owns segments
// [32k, 32k + 32) of lane t), so the partial needs no extra barrier.
// Shared memory is K7's: K3's 38 KB of accumulators and stage, the 2 KB
// row_src and a row buffer of 2 * 256 * min(Q, 32) floats, at most
// 104 KB a block, so two blocks fit an SM.  `dbg` counts [cells, staged
// rows] once per (cell, row), whatever the lane groups; the bytes are
// rows * Q * 4.
//
// Bound: K4's (each edge's source id and mask, each edge active in some
// lane's id and weight, the (V, Q) table, the inbox), plus the SBLK * Q
// partial floats a live cell writes and the fold reads back.  The staged
// bytes are the gathered bytes.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_tiled_lanes_kernel(const float* __restrict__ gval,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ w,
                          const int32_t* __restrict__ ids,
                          const uint8_t* __restrict__ act,
                          const uint8_t* __restrict__ unitw,
                          const int32_t* __restrict__ wl_i,
                          const int32_t* __restrict__ wl_j,
                          const int32_t* __restrict__ nlive, int num_edges,
                          int num_slots, int Q, int cpb,
                          float* __restrict__ partials,
                          int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;                // piece h in positions h * HALF..
  __shared__ int32_t row_src[EBLK];
  extern __shared__ __align__(16) float row_s[];    // [2][HALF][lw]
  const int t = threadIdx.x & 31;
  const int s0 = (threadIdx.x >> 5) * SEG_PER_WARP;
  const int c0 = blockIdx.y * LGRP;
  const int lane_q = c0 + t;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - c0);
  const bool on = lane_q < Q;
  const bool unit = on && unitw[lane_q] != 0;
  const int n = *nlive;
  clear_lane_acc<KIND>(acc);

  // The block's k-th piece is half k & 1 of its (k >> 1)-th cell.
  auto cell = [&](int k) { return block_cell(k >> 1, cpb, n); };
  auto load = [&](int k) {
    const int c = cell(k);
    return c < n ? load_edge(src, w, act, ids,
                             wl_j[c] * EBLK + (k & 1) * HALF + threadIdx.x,
                             num_edges)
                 : EdgeRegs{0, 0, 0.0f, false};
  };
  auto stage = [&](int k, const EdgeRegs& x) {   // returns the rows
    const int c = cell(k), h = k & 1;
    const int m = c < n ? stage_position(st, row_src, x,
                                         h * HALF + threadIdx.x, num_slots,
                                         wl_i[c] * SBLK)
                        : 0;
    const bool any = __syncthreads_or(m);
    if (any)
      copy_rows(row_s + h * HALF * lw, st, row_src, gval, h * HALF, Q, c0,
                gw, lw);
    cp_async_commit();
    return any ? m : -1;
  };

  int rows = 0, cells = 0;
  EdgeRegs x = load(0);
  const EdgeRegs x1 = load(1);
  int m_cur = stage(0, x);                // the clear is ordered here too
  x = x1;
  for (int k = 0; cell(k) < n; ++k) {
    const EdgeRegs xq = load(k + 2);      // the piece after the next
    const int m_next = stage(k + 1, x);
    x = xq;
    cp_async_wait_prev();                 // the current piece has landed
    const int h = k & 1;
    if (m_cur >= 0) {
      rows += m_cur;
      fold_lane_list<RELAX, KIND>(
          acc, st, HalfPos{h * HALF}, HALF,
          StagedRows{row_s + h * HALF * lw, h * HALF, lw, t}, on, unit);
    }
    if (h == 1) {                         // the cell is folded
      ++cells;
      if (on) {
        float* row = partials + static_cast<size_t>(cell(k)) * SBLK * Q;
        for (int s = s0; s < s0 + SEG_PER_WARP; ++s) {
          row[static_cast<size_t>(s) * Q + lane_q] = acc[s][t];
          acc[s][t] = identity<KIND>();
        }
      }
    }
    __syncthreads();                      // the piece is read before reuse
    m_cur = m_next;
  }

  if (dbg != nullptr && blockIdx.y == 0) {
    rows = __reduce_add_sync(0xffffffffu, rows);
    if (t == 0 && rows) atomicAdd(dbg + 1, rows);
    if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `act` is the (E,) uint8 flags of
// valid edges active in some lane (they stand in for the mask), `unitw`
// (Q,) uint8; `nlive` a (1,) device count; `grid` >= 1 blocks per lane
// group take groups of `cpb` >= 1 consecutive cells; `partials` is
// (l_pad, SBLK, Q); `dbg` ((2,) int32) may be null.  The table must be
// 16-byte aligned.
extern "C" int frr_wl_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const int32_t* ids, const uint8_t* act, const uint8_t* unitw,
    const int32_t* wl_i, const int32_t* wl_j, const int32_t* nlive,
    int num_edges, int num_slots, int Q, int cpb, int grid,
    float* partials, int32_t* dbg, int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || Q < 1 || cpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lane_row_smem(Q);
  dim3 g(grid, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_WLTL_ARGS gval, src, w, ids, act, unitw, wl_i, wl_j, nlive, \
                      num_edges, num_slots, Q, cpb, partials, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<ADD_W, KIND_MIN>, g,
                            block, smem, s, FRR_WLTL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<MUL_W, KIND_SUM>, g,
                            block, smem, s, FRR_WLTL_ARGS);
#undef FRR_WLTL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
