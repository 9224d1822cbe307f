// Lane-batched fused frontier relax + segment reduce for Hopper (sm_90a):
// kernel K3.
//
// Replaces the TPU kernel `_kernel_lanes` launched by `_fused_lanes_pinned`
// in src/repro/kernels/fused_relax_reduce.py.  The value table carries a
// trailing query axis: for every segment d and lane q,
//
//   out[d, q] = (+) over edges e with ids[e] == d and mask[e] of
//               relax_q(gval[src[e], q], w[e])
//
// where (+) is min or sum, relax_q is add_w (with weight 1.0 on lanes
// whose unitw flag is set: BFS lanes inside an SSSP launch) or mul_w, and
// `gval` is frontier-masked per lane: a source inactive in lane q reads
// the combine identity there, which absorbs under relax.  Empty segments
// hold the identity.
//
// Launch shape.  As K1, one thread block per SBLK-wide segment block walks
// the edge chunks whose destination range meets it (blk_ptr / blk_chunk,
// chunks ascending) and skips a chunk whose frontier bit is 0 — the OR
// across lanes, so a chunk is skipped only when it is dead in every lane.
// A second grid axis runs one block per group of LGRP = 32 lanes, so any
// Q works with no lane padding.  The cell body is frr_lanes.cuh's: one
// owner thread per (segment, lane) accumulator, the chunk staged in
// shared memory, the lanes of a source gathered as one row.  `dbg` counts
// executed (block, chunk) cells, once per segment block (lane group 0).
//
// Bound.  Bytes: a round must read each edge's src and mask, each active
// edge's id and weight, the (V, Q) value table and frontier once, and
// write the (num_segments, Q) inbox once; the arithmetic is a relax and a
// combine per active (edge, lane).  This version gathers a source's row
// once per edge and per segment block it meets, and serialises a warp's
// edges (four gathers in flight): a chunk whose edges all land in one
// warp's 32 segments (a hub's in-edges) keeps that warp busy while the
// block's seven other warps wait.  With Q < 32 the threads of the
// missing lanes idle.

#include "frr_lanes.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_lanes_kernel(const float* __restrict__ gval,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ unitw,
                 const int32_t* __restrict__ blk_ptr,
                 const int32_t* __restrict__ blk_chunk,
                 const uint8_t* __restrict__ chunk_act,
                 int num_edges, int num_segments, int Q,
                 float* __restrict__ out, int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;
  const int lane_q = blockIdx.y * LGRP + (threadIdx.x & 31);
  const bool unit = lane_q < Q && unitw[lane_q] != 0;
  clear_lane_acc<KIND>(acc);

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  for (int p = blk_ptr[blockIdx.x]; p < p1; ++p) {
    const int j = blk_chunk[p];
    if (!chunk_act[j]) continue;          // frontier skip, block-uniform
    if (dbg != nullptr && blockIdx.y == 0 && threadIdx.x == 0)
      atomicAdd(dbg, 1);
    __syncthreads();                      // the last chunk's stage is read
    stage_chunk(st, src, w, mask, ids, j, num_edges, seg0);
    __syncthreads();
    fold_lanes<RELAX, KIND>(acc, st, gval, Q, lane_q, unit);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS) {
    const int d = seg0 + t / LGRP;
    const int q = blockIdx.y * LGRP + t % LGRP;
    if (d < num_segments && q < Q)
      out[static_cast<size_t>(d) * Q + q] = acc[t / LGRP][t % LGRP];
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `unitw` is (Q,) uint8; `dbg` may
// be null.
extern "C" int frr_lanes_launch(const float* gval, const int32_t* src,
                                const float* w, const uint8_t* mask,
                                const int32_t* ids, const uint8_t* unitw,
                                const int32_t* blk_ptr,
                                const int32_t* blk_chunk,
                                const uint8_t* chunk_act, int num_edges,
                                int num_segments, int num_blocks, int Q,
                                float* out, int32_t* dbg, int relax,
                                int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(num_blocks, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_LANES_ARGS gval, src, w, mask, ids, unitw, blk_ptr, blk_chunk, \
                       chunk_act, num_edges, num_segments, Q, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_lanes_kernel<ADD_W, KIND_MIN><<<grid, block, 0, s>>>(FRR_LANES_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_lanes_kernel<MUL_W, KIND_SUM><<<grid, block, 0, s>>>(FRR_LANES_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_LANES_ARGS
  return static_cast<int>(cudaGetLastError());
}
