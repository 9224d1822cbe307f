// Lane-batched worklist launch of the fused frontier relax + segment
// reduce for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel `_kernel_wl_lanes` launched by
// `_fused_lanes_pinned_wl` in src/repro/kernels/fused_relax_reduce.py,
// and the `_scatter_partials` fold after it.  K4 is to K3
// (fused_relax_reduce_lanes.cu) what K2 is to K1: for every segment d and
// lane q, the combine over the listed (block, chunk) cells' edges with
// ids[e] == d and mask[e] of relax_q(gval[src[e], q], w[e]), the cells
// planned over the OR-across-lanes frontier.
//
// Launch shape: K2's (fused_relax_reduce_wl.cu, frr_common.cuh).  One
// thread block per (piece, 32-lane group): it walks the piece's planned
// cells in chunk order, skips the ones the round does not list (a host
// plan's flag byte, or a device plan's chunk frontier bit), and runs K3's
// cell body (frr_lanes.cuh) on the others, staging only the cell's batch
// range (the 32-edge batches of its chunk that hold a valid edge of its
// block), into the (SBLK, LGRP) owner-thread accumulator carried across
// the piece.  Each (segment, lane) combines the same messages in the same
// order as K3, so a block that is one piece gives K3's columns bit for
// bit, sum included.  The pieces of a split block combine in piece order
// through the split buffer (SBLK * Q floats a piece of a split block)
// and an arrival ticket per (block, lane group) (finish_lane_piece); no
// float atomics.  `dbg` counts the cells run, once per cell (lane group
// 0).
//
// Bound.  Bytes: each edge's source id and mask, each edge active in some
// lane's id and weight, the (V, Q) table and frontier once, the inbox
// once.  As K3, a source's row is gathered once per edge, and a warp's
// edges are serialised (four gathers in flight): a hub chunk whose edges
// land in one warp's 32 segments keeps that warp busy while the block's
// other warps wait.

#include "frr_lanes.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_lanes_kernel(const float* __restrict__ gval,
                    const int32_t* __restrict__ src,
                    const float* __restrict__ w,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ ids,
                    const uint8_t* __restrict__ unitw, const Pieces pc,
                    int num_edges, int num_segments, int Q,
                    float* __restrict__ out, float* __restrict__ split,
                    int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;
  const int k = blockIdx.x;
  const int i = pc.piece_blk[k];
  if (i < 0) return;                      // past the real pieces
  const int lane_q = blockIdx.y * LGRP + (threadIdx.x & 31);
  const bool unit = lane_q < Q && unitw[lane_q] != 0;
  clear_lane_acc<KIND>(acc);

  const int seg0 = i * SBLK;
  const int p1 = pc.piece_hi[k];
  int cells = 0;
  for (int p = pc.piece_lo[k]; p < p1; ++p) {
    if (!pc.live(p)) continue;            // block-uniform
    ++cells;
    const int k_lo = 32 * pc.batch_lo(p);
    const int k_hi = 32 * pc.batch_hi(p);
    if (k_lo == k_hi) continue;           // no edge of the block
    __syncthreads();                      // the last cell's stage is read
    stage_chunk(st, src, w, mask, ids, pc.blk_chunk[p], num_edges, seg0,
                k_lo, k_hi);
    __syncthreads();
    fold_lane_list<RELAX, KIND>(acc, st, RangePos{k_lo}, k_hi - k_lo,
                                TableRows{gval, Q, lane_q}, lane_q < Q,
                                unit);
  }
  if (dbg != nullptr && blockIdx.y == 0 && threadIdx.x == 0 && cells)
    atomicAdd(dbg, cells);
  __syncthreads();
  finish_lane_piece<KIND>(acc, pc, k, i, num_segments, Q, out, split);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `unitw` is (Q,) uint8; the Pieces
// come as ten pointers (FRR_PIECE_PARAMS; `flags` null for a device
// plan, `tickets` one per (block, lane group)); `split` has SBLK * Q
// floats per piece of a split block; `dbg` may be null.
extern "C" int frr_wl_lanes_launch(const float* gval, const int32_t* src,
                                   const float* w, const uint8_t* mask,
                                   const int32_t* ids, const uint8_t* unitw,
                                   FRR_PIECE_PARAMS, int num_edges,
                                   int num_segments, int num_pieces, int Q,
                                   float* out, float* split, int32_t* dbg,
                                   int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
  dim3 g(num_pieces, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_WLL_ARGS gval, src, w, mask, ids, unitw, pc, num_edges, \
                     num_segments, Q, out, split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_wl_lanes_kernel<ADD_W, KIND_MIN><<<g, block, 0, s>>>(FRR_WLL_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_wl_lanes_kernel<MUL_W, KIND_SUM><<<g, block, 0, s>>>(FRR_WLL_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_WLL_ARGS
  return static_cast<int>(cudaGetLastError());
}
