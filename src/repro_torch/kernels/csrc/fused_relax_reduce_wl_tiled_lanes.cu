// Lane-batched tiled worklist launch of the fused frontier relax +
// segment reduce for Hopper (sm_90a): kernel K8.
//
// Replaces the TPU kernel `_kernel_wl_tiled_lanes` launched by
// `_fused_lanes_tiled_wl` in src/repro/kernels/fused_relax_reduce.py.
// K8 is the tiled twin of K4 (fused_relax_reduce_wl_lanes.cu): K4's
// launch (a thread block per (piece, 32-lane group), the round's listed
// cells of the piece, a split block's pieces combined in piece order
// through the split buffer and an arrival ticket per (block, lane
// group)) with K7's cell.
//
// The copy unit.  The TPU kernel copies the (vblk, Q) slot tiles that a
// cell's sources active in some lane fall in (at RMAT-18 and Q = 16 a
// cell copied most of the table's 348 tiles).  Here a cell copies what
// it reads: K7's cell (frr_tiles.cuh).  It runs in two halves of EBLK / 2
// positions; a half is staged as K3 stages a chunk, with a position dead
// in every lane dropped, and the block copies its lane group's columns
// of each kept row (16-byte pieces when Q % 4 == 0, else 4-byte ones)
// into the half's part of a row buffer.  The fold is K3's fold_lane_list
// over the half's positions in order into the piece's (SBLK, LGRP)
// accumulator, so each (segment, lane) combines the same messages in the
// same order as K4, and K8's inbox is K4's bit for bit, sum included.  A
// half that keeps no row copies and folds nothing.
//
// A block walks the halves of its piece's listed cells with K7's
// pipeline: while half h is folded, half h+1's rows are in flight (one
// commit group a half) and half h+2's edges are loaded into registers.
// Shared memory is K7's: K3's 38 KB of accumulators and stage, the 2 KB
// row_src and a row buffer of 2 * 256 * min(Q, 32) floats, at most
// 104 KB a block, so two blocks fit an SM.  `dbg` counts [cells, staged
// rows] once per (cell, row), whatever the lane groups; the bytes are
// rows * Q * 4.
//
// Bound: K4's (each edge's source id and mask, each edge active in some
// lane's id and weight, the (V, Q) table, the inbox).  The staged bytes
// are the gathered bytes.

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
                          const uint8_t* __restrict__ unitw, const Pieces pc,
                          int num_edges, int num_segments, int num_slots,
                          int Q, float* __restrict__ out,
                          float* __restrict__ split,
                          int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;                // half h in positions h * HALF..
  __shared__ int32_t row_src[EBLK];
  extern __shared__ __align__(16) float row_s[];    // [2][HALF][lw]
  const int k = blockIdx.x;
  const int i = pc.piece_blk[k];
  if (i < 0) return;                      // past the real pieces
  const int t = threadIdx.x & 31;
  const int c0 = blockIdx.y * LGRP;
  const int lane_q = c0 + t;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - c0);
  const bool on = lane_q < Q;
  const bool unit = on && unitw[lane_q] != 0;
  clear_lane_acc<KIND>(acc);

  const int seg0 = i * SBLK;
  const int p1 = pc.piece_hi[k];
  // The next listed cell from p that holds an edge of the block; a listed
  // cell with none (a device plan's cell of a chunk that straddles two
  // shards' runs) stages no row and folds nothing, so it is counted and
  // passed over.  Each position is scanned once.  Block-uniform.
  int empty = 0;
  auto next_live = [&](int p) {
    for (; p < p1; ++p) {
      if (!pc.live(p)) continue;
      if (pc.batch_hi(p) > 0) break;
      ++empty;
    }
    return p;
  };
  // The block walks halves (cell p, half h) in order.  At each step the
  // current half's rows are in flight, the next half is staged from
  // registers and its row copies committed, and the half after it is
  // loaded into registers, before the current half is folded.
  auto load = [&](int p, int h) {
    return p < p1 ? load_edge(src, w, act, ids,
                              pc.blk_chunk[p] * EBLK + h * HALF +
                                  threadIdx.x,
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
  int cp = next_live(pc.piece_lo[k]), ch = 0;       // the current half
  int np = cp, nh = ch;                              // the next half
  advance(np, nh);
  EdgeRegs x = load(cp, ch);
  const EdgeRegs x1 = load(np, nh);
  int n_cur = stage(cp, ch, x);           // the clear is ordered here too
  x = x1;
  while (cp < p1) {
    int qp = np, qh = nh;                 // the half after the next
    advance(qp, qh);
    const EdgeRegs xq = load(qp, qh);
    const int n_next = stage(np, nh, x);
    x = xq;
    cp_async_wait_prev();                 // the current half has landed
    if (n_cur >= 0) {
      rows += n_cur;
      fold_lane_list<RELAX, KIND>(
          acc, st, RangePos{ch * HALF}, HALF,
          StagedRows{row_s + ch * HALF * lw, ch * HALF, lw, t}, on, unit);
    }
    cells += ch == 0;
    __syncthreads();                      // the half is read before reuse
    cp = np;
    ch = nh;
    np = qp;
    nh = qh;
    n_cur = n_next;
  }

  cells += empty;
  if (dbg != nullptr && blockIdx.y == 0) {
    rows = __reduce_add_sync(0xffffffffu, rows);
    if (t == 0 && rows) atomicAdd(dbg + 1, rows);
    if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
  }
  finish_lane_piece<KIND>(acc, pc, k, i, num_segments, Q, out, split);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `act` is the (E,) uint8 flags of
// valid edges active in some lane (they stand in for the mask), `unitw`
// (Q,) uint8; the Pieces come as ten pointers (FRR_PIECE_PARAMS; `flags`
// null for a device plan, `tickets` one per (block, lane group)); `split`
// has SBLK * Q floats per piece of a split block; `dbg` ((2,) int32) may
// be null.  The table must be 16-byte aligned.
extern "C" int frr_wl_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const int32_t* ids, const uint8_t* act, const uint8_t* unitw,
    FRR_PIECE_PARAMS, int num_edges, int num_segments, int num_pieces,
    int num_slots, int Q, float* out, float* split, int32_t* dbg,
    int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
  const size_t smem = lane_row_smem(Q);
  dim3 g(num_pieces, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_WLTL_ARGS gval, src, w, ids, act, unitw, pc, num_edges, \
                      num_segments, num_slots, Q, out, split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<ADD_W, KIND_MIN>, g,
                            block, smem, s, FRR_WLTL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<MUL_W, KIND_SUM>, g,
                            block, smem, s, FRR_WLTL_ARGS);
#undef FRR_WLTL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
