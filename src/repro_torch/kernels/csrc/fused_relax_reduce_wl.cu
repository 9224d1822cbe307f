// The piece launch of the fused frontier relax + segment reduce for
// Hopper (sm_90a): kernels K1 (dense) and K2 (worklist).
//
// Replaces the TPU kernels `_kernel` launched by `_fused_pinned` (K1) and
// `_kernel_wl` launched by `_fused_pinned_wl` (K2), with the
// `_scatter_partials` fold after it, in
// src/repro/kernels/fused_relax_reduce.py.  For every segment d,
//
//   out[d] = (+) over edges e of the run (block, chunk) cells with
//            ids[e] == d and mask[e] of relax(gval[src[e]], w[e])
//
// over the frontier-masked table (inactive sources read as the combine
// identity, which absorbs under every supported relax); empty segments
// hold the identity.  K1 runs the planned cells whose chunk frontier bit
// is set, as the TPU's dense grid runs its live cells; K2 the cells a
// worklist lists (a host plan's flag bytes, or a device plan's chunk
// bits, which is K1's list).
//
// Why not the TPU's shape.  A Pallas grid runs in order on one core, so
// the TPU walks a dense (segment block, chunk) grid, or a compacted list
// of live cells each writing an (SBLK,) partial that a second pass
// scatters.  Here blocks run in any order on 132 SMs, so one launch walks
// the static pieces of frr_common.cuh: a thread block takes a piece (at
// most PIECE_CELLS consecutive planned cells of one segment block,
// chunks ascending), skips the cells the round does not run, and folds
// each run cell with the warp fold of frr_common.cuh (fold_range: batch b
// on warp b % NWARP) into per-warp accumulators carried across the piece.
// It folds only the 32-edge batches of the cell's chunk that hold a valid
// edge of its block (cell_batch), so a chunk whose range meets several
// blocks is read about once in all.  The pieces of a split block combine
// in piece order through the split buffer and an arrival ticket
// (finish_piece); no float atomics, so K1's sums repeat bit for bit, and
// K2 on the same cells gives K1's bits.
//
// The cell reads a run cell's edges from device memory as it folds them.
// A cell that stages its batch range into shared memory first, with TMA
// bulk copies (cp.async.bulk, an mbarrier a stage, one thread issuing a
// ring of two to four stages a cell or more ahead of the warps), was
// built and timed against it on the H100 and ran 8-33% slower on the
// heaviest RMAT-18 round (PERF.md): a piece runs about five cells, so the
// ring never fills, and every cell pays a block barrier to free its
// stage.
//
// Bound.  Bytes: a round must read each active edge's src, id, mask and
// weight once, the value table once, and write the inbox once; there is
// O(1) arithmetic per edge.  Beyond that a launch reads a byte a planned
// cell (flags, or the chunk bits) and, for a split block, writes and
// reads back 1 KB a piece.

#include "frr_common.cuh"

namespace {

using namespace frr;

// Fold the run cells of positions [p0, p1) of segment block seg0 / SBLK
// into acc, reading the edges from device memory; returns the cells run.
template <int RELAX, int KIND>
__device__ __forceinline__ int fold_cells(
    float (*acc)[SBLK], float (*msg_s)[32], const Pieces& pc,
    const RelaxMsg<RELAX>& msg, const int32_t* __restrict__ ids, int p0,
    int p1, int num_edges, int seg0) {
  int cells = 0;
  for (int p = p0; p < p1; ++p) {
    if (!pc.live(p)) continue;            // block-uniform
    ++cells;
    const int j = pc.blk_chunk[p];
    fold_range<KIND>(acc, msg_s, msg, ids, ChunkEdges{j * EBLK},
                     pc.batch_lo(p), pc.batch_hi(p), EBLK, num_edges, seg0);
  }
  return cells;
}

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_kernel(const float* __restrict__ gval,
              const int32_t* __restrict__ src,
              const float* __restrict__ w,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ ids, const Pieces pc,
              int num_edges, int num_segments,
              float* __restrict__ out, float* __restrict__ split,
              int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  run_piece(pc, [&](int k, int i) {
    clear_acc<KIND>(acc);
    __syncthreads();
    const int cells = fold_cells<RELAX, KIND>(
        acc, msg_s, pc, RelaxMsg<RELAX>{gval, src, w, mask}, ids,
        pc.piece_lo[k], pc.piece_hi[k], num_edges, i * SBLK);
    if (dbg != nullptr && threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
    __syncthreads();
    finish_piece<KIND>(acc, pc, k, i, num_segments, out, split);
  });
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  The Pieces come as ten
// pointers (FRR_PIECE_PARAMS; `flags` null for a dense launch or a
// device plan); one block per piece; `split` has a row of SBLK floats
// per piece of a split block; `dbg` may be null.
extern "C" int frr_wl_launch(const float* gval, const int32_t* src,
                             const float* w, const uint8_t* mask,
                             const int32_t* ids, FRR_PIECE_PARAMS,
                             int num_edges, int num_segments, int num_pieces,
                             float* out, float* split, int32_t* dbg,
                             int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
#define FRR_WL_ARGS gval, src, w, mask, ids, pc, num_edges, num_segments, \
                    out, split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_pieces(frr_wl_kernel<ADD_W, KIND_MIN>, num_pieces, 1, 0,
                         s, FRR_WL_ARGS);
  if (relax == ADD_ONE && kind == KIND_MIN)
    return launch_pieces(frr_wl_kernel<ADD_ONE, KIND_MIN>, num_pieces, 1, 0,
                         s, FRR_WL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_pieces(frr_wl_kernel<MUL_W, KIND_SUM>, num_pieces, 1, 0,
                         s, FRR_WL_ARGS);
#undef FRR_WL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
