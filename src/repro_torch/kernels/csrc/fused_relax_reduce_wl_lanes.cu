// Lane-batched piece launch of the fused frontier relax + segment reduce
// for Hopper (sm_90a): kernels K3 (dense) and K4 (worklist).
//
// Replaces the TPU kernels `_kernel_lanes` launched by
// `_fused_lanes_pinned` (K3) and `_kernel_wl_lanes` launched by
// `_fused_lanes_pinned_wl` (K4), with the `_scatter_partials` fold
// after it, in src/repro/kernels/fused_relax_reduce.py.  The value table
// carries a trailing query axis: for every segment d and lane q,
//
//   out[d, q] = (+) over edges e of the run cells with ids[e] == d and
//               mask[e] of relax_q(gval[src[e], q], w[e])
//
// where (+) is min or sum, relax_q is add_w (with weight 1.0 on lanes
// whose unitw flag is set: BFS lanes inside an SSSP launch) or mul_w, and
// `gval` is frontier-masked per lane.  Cells are planned over the
// OR-across-lanes frontier: K3 runs the planned cells whose chunk bit
// (the OR across lanes) is set, K4 the cells a worklist lists.
//
// Launch shape: K1's and K2's (fused_relax_reduce_wl.cu, frr_common.cuh),
// with a second grid axis of one block per group of LGRP = 32 lanes, so
// any Q works with no lane padding.  A thread block takes a (piece, lane
// group), walks the piece's planned cells in chunk order, skips the ones
// the round does not run, and stages each run cell's batch range (the
// 32-edge batches of its chunk that hold a valid edge of its block),
// loaded into registers while the cell before it is folded.  It folds
// the stage with frr_lanes.cuh's two-phase fold into the (SBLK, lanes)
// owner-thread accumulator carried across the piece: every warp
// gathers a slice of the cell's positions at once (phase A), so a hub
// chunk's 512 edges are gathered by eight warps, not by the one that owns
// the hub's segment; then the owners combine the slices' partials in
// position order (phase B).  With Q <= 16 each half-warp takes a list of
// its own (HALVES = 2).  The pieces of a split block combine in piece
// order through the split buffer (SBLK * Q floats a piece of a split
// block) and an arrival ticket per (block, lane group)
// (finish_lane_piece); no float atomics, so sums repeat bit for bit and
// K4 on the same cells gives K3's bits.  `dbg` counts the cells run,
// once per cell (lane group 0).
//
// Bound.  Bytes: each edge's source id and mask, each edge active in some
// lane's id and weight, the (V, Q) table and frontier once, the inbox
// once; the arithmetic is a relax and a combine per active (edge, lane).
// A source's row is gathered once per edge (one coalesced read of the
// lane group's columns); what remains is the gathers' latency, GATHER_
// DEPTH rows in flight a list, and two block barriers a window.

#include "frr_lanes.cuh"

namespace {

using namespace frr;

// Blocks an SM holds at Q <= 16 (the registers are capped to fit them:
// 48 a thread; 40 KB of shared memory a block).  Five ran 9-10% faster
// than the four the compiler's own register choice left (PERF.md).
constexpr int BLOCKS_PER_SM = 5;

template <int RELAX, int KIND, int HALVES>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
frr_wl_lanes_kernel(const float* __restrict__ gval,
                    const int32_t* __restrict__ src,
                    const float* __restrict__ w,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ ids,
                    const uint8_t* __restrict__ unitw, const Pieces pc,
                    int num_edges, int num_segments, int Q,
                    float* __restrict__ out, float* __restrict__ split,
                    int32_t* __restrict__ dbg) {
  __shared__ LaneStage st;
  extern __shared__ __align__(16) float dyn[];      // lane_smem(Q) bytes
  const int lw = min(Q, LGRP);
  float* acc = dyn;                                   // (SBLK, lw)
  const Runs runs = Runs::at(dyn + SBLK * lw, lw);
  const LaneCols lc{static_cast<int>(blockIdx.y) * LGRP, Q, unitw};
  const TableRows rows{gval, Q, lc.c0};
  run_piece(pc, [&](int k, int i) {
    clear_lane_acc<KIND>(acc, lw);
    const int seg0 = i * SBLK;
    const int p1 = pc.piece_hi[k];
    int cells = 0;
    // The next run cell from p that holds an edge of the block; a run
    // cell with none (a chunk that straddles two shards' runs) is counted
    // and passed over.  Each position is scanned once.  Block-uniform.
    auto next = [&](int p) {
      for (; p < p1; ++p) {
        if (!pc.live(p)) continue;
        ++cells;
        if (pc.batch_hi(p) > 0) break;
      }
      return p;
    };
    // This thread's positions of cell p's batch range, in registers.
    auto load = [&](int p, EdgeRegs (&x)[EBLK / THREADS]) {
#pragma unroll
      for (int u = 0; u < EBLK / THREADS; ++u) {
        const int kk = u * THREADS + threadIdx.x;
        x[u] = p < p1 && kk >= 32 * pc.batch_lo(p) && kk < 32 * pc.batch_hi(p)
                   ? load_edge(src, w, mask, ids, pc.blk_chunk[p] * EBLK + kk,
                               num_edges)
                   : EdgeRegs{0, 0, 0.0f, false};
      }
    };
    // While a cell is folded, the next one's edges are loaded.
    EdgeRegs x[EBLK / THREADS];
    int p = next(pc.piece_lo[k]);
    load(p, x);
    while (p < p1) {
      const int pn = next(p + 1);
      const int k_lo = 32 * pc.batch_lo(p);
      const int k_hi = 32 * pc.batch_hi(p);
      __syncthreads();                    // the last cell's stage is read
#pragma unroll
      for (int u = 0; u < EBLK / THREADS; ++u) {
        const int kk = u * THREADS + threadIdx.x;
        if (kk >= k_lo && kk < k_hi) stage_edge(st, x[u], kk, seg0);
      }
      load(pn, x);
      __syncthreads();
      fold_lane_runs<RELAX, KIND, HALVES>(acc, runs, st, k_lo, k_hi, rows,
                                          lc);
      p = pn;
    }
    if (dbg != nullptr && blockIdx.y == 0 && threadIdx.x == 0 && cells)
      atomicAdd(dbg, cells);
    __syncthreads();
    finish_lane_piece<KIND>(acc, lw, pc, k, i, num_segments, Q, out,
                            split);
  });
}

template <int RELAX, int KIND>
int launch(int halves, int num_pieces, int Q, cudaStream_t s,
           const float* gval, const int32_t* src,
           const float* w, const uint8_t* mask, const int32_t* ids,
           const uint8_t* unitw, const Pieces& pc, int num_edges,
           int num_segments, float* out, float* split, int32_t* dbg) {
  const int groups = (Q + LGRP - 1) / LGRP;
  if (halves == 2)
    return launch_pieces(frr_wl_lanes_kernel<RELAX, KIND, 2>, num_pieces,
                         groups, lane_smem(Q), s, gval, src, w, mask, ids,
                         unitw, pc, num_edges, num_segments, Q, out, split,
                         dbg);
  return launch_pieces(frr_wl_lanes_kernel<RELAX, KIND, 1>, num_pieces,
                       groups, lane_smem(Q), s, gval, src, w, mask, ids,
                       unitw, pc, num_edges, num_segments, Q, out, split,
                       dbg);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `unitw` is (Q,) uint8; the Pieces
// come as ten pointers (FRR_PIECE_PARAMS; `flags` null for a dense
// launch or a device plan, `tickets` one per (block, lane group));
// `split` has SBLK * Q floats per piece of a split block; `dbg` may be
// null.  `halves` 2 (only for Q <= 16) runs a list per half-warp, 1 a
// list per warp.
extern "C" int frr_wl_lanes_launch(const float* gval, const int32_t* src,
                                   const float* w, const uint8_t* mask,
                                   const int32_t* ids, const uint8_t* unitw,
                                   FRR_PIECE_PARAMS, int num_edges,
                                   int num_segments, int num_pieces, int Q,
                                   float* out, float* split, int32_t* dbg,
                                   int relax, int kind, int halves,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1 || Q < 1 || (halves != 1 && halves != 2) ||
      (halves == 2 && Q > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
#define FRR_WLL_ARGS halves, num_pieces, Q, s, gval, src, w, mask, ids,   \
                     unitw, pc, num_edges, num_segments, out, split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch<ADD_W, KIND_MIN>(FRR_WLL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch<MUL_W, KIND_SUM>(FRR_WLL_ARGS);
#undef FRR_WLL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the (add_w, min) kernel resident on one SM at Q lanes, or
// -cudaError_t.
extern "C" int frr_wl_lanes_blocks_per_sm(int Q, int halves) {
  return halves == 2
             ? blocks_per_sm(frr_wl_lanes_kernel<ADD_W, KIND_MIN, 2>,
                             lane_smem(Q))
             : blocks_per_sm(frr_wl_lanes_kernel<ADD_W, KIND_MIN, 1>,
                             lane_smem(Q));
}
