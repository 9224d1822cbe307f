// Fused frontier relax + segment reduce for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` launched by `_fused_pinned` in
// src/repro/kernels/fused_relax_reduce.py.  For every segment d:
//
//   out[d] = (+) over edges e with ids[e] == d and mask[e] of
//            relax(gval[src[e]], w[e])
//
// where (+) is min or sum and `gval` is the frontier-masked value table:
// inactive sources already read as the combine identity, which absorbs
// under every supported relax (inf + w = inf, 0 * w = 0).  Empty segments
// hold the identity.
//
// Launch shape.  The TPU kernel runs a dense (segment block, edge chunk)
// grid in order and carries each out block across chunks.  Here one
// thread block owns one SBLK-wide segment block and walks only the edge
// chunks whose [lo, hi] destination range meets it (a CSR built once per
// partition: blk_ptr / blk_chunk, chunks ascending).  A chunk whose
// frontier bit is 0 is skipped without reading its edges.  The executed
// (block, chunk) cells are therefore exactly the TPU grid's live cells;
// `dbg` counts them.
//
// Reduction: the warp fold of frr_common.cuh.  Each warp owns a private
// (SBLK,) accumulator in shared memory for all of the block's chunks; at
// the end thread t folds the NWARP accumulators of segment t in warp
// order.  No atomics touch a value, so the sum is the same from run to
// run; min is exact in any order.
//
// Bound.  Bytes: a full-frontier RMAT-18 round (4.19 M edge slots of
// src + ids + mask + w, a 1 MB slot table) must move about 55 MB, about
// 17 us at 3.35 TB/s; there is O(1) arithmetic per edge.  This design
// reads each live chunk's edges once per segment block that the chunk
// meets, with the re-reads served from L2 when neighbouring blocks run
// together, and gathers table values at random from a table that fits
// in L2.  On the RMAT-18 partition a chunk meets 4.9 blocks on average
// (40,382 cells over 8,181 chunks), so the edges are read about five
// times: that, not device memory, bounds this version.  About 15.6 k of
// those cells belong to the 15 chunks that straddle two shards' sorted
// runs, whose [lo, hi] range spans the whole slot space although no edge
// of theirs lands in most blocks.  The worklist kernel K2
// (fused_relax_reduce_wl.cu) runs a block's cells in pieces and reads
// only the batches of a cell that hold edges of its block; TMA staging
// is later work.

#include "frr_common.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
fused_relax_reduce_kernel(const float* __restrict__ gval,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ w,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ blk_ptr,
                          const int32_t* __restrict__ blk_chunk,
                          const uint8_t* __restrict__ chunk_act,
                          int num_edges, int num_segments,
                          float* __restrict__ out,
                          int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  clear_acc<KIND>(acc);
  __syncthreads();

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  for (int p = blk_ptr[blockIdx.x]; p < p1; ++p) {
    const int j = blk_chunk[p];
    if (!chunk_act[j]) continue;          // frontier skip, block-uniform
    if (dbg != nullptr && threadIdx.x == 0) atomicAdd(dbg, 1);
    fold_chunk<RELAX, KIND>(acc, msg_s, gval, src, w, mask, ids, j,
                            num_edges, seg0);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < SBLK; t += THREADS) {
    const int d = seg0 + t;
    if (d < num_segments) out[d] = fold_warps<KIND>(acc, t);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  `dbg` may be null.
extern "C" int frr_launch(const float* gval, const int32_t* src,
                          const float* w, const uint8_t* mask,
                          const int32_t* ids, const int32_t* blk_ptr,
                          const int32_t* blk_chunk, const uint8_t* chunk_act,
                          int num_edges, int num_segments, int num_blocks,
                          float* out, int32_t* dbg, int relax, int kind,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_blocks), block(THREADS);
#define FRR_ARGS gval, src, w, mask, ids, blk_ptr, blk_chunk, chunk_act, \
                 num_edges, num_segments, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    fused_relax_reduce_kernel<ADD_W, KIND_MIN><<<grid, block, 0, s>>>(FRR_ARGS);
  else if (relax == ADD_ONE && kind == KIND_MIN)
    fused_relax_reduce_kernel<ADD_ONE, KIND_MIN><<<grid, block, 0, s>>>(FRR_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    fused_relax_reduce_kernel<MUL_W, KIND_SUM><<<grid, block, 0, s>>>(FRR_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_ARGS
  return static_cast<int>(cudaGetLastError());
}
