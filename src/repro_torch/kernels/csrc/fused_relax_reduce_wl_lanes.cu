// Lane-batched worklist launch of the fused frontier relax + segment
// reduce for Hopper (sm_90a): kernel K4 and its laned fold.
//
// Replaces the TPU kernel `_kernel_wl_lanes` launched by
// `_fused_lanes_pinned_wl` in src/repro/kernels/fused_relax_reduce.py,
// and the `_scatter_partials` fold after it.  K4 is to K3
// (fused_relax_reduce_lanes.cu) what K2 is to K1: a worklist lists live
// (segment block, edge chunk) cells, j-major — cell c works chunk wl_j[c]
// against block wl_i[c] — planned over the OR-across-lanes frontier.
//
//   frr_wl_lanes_kernel  one thread block per live cell (c < *nlive) and
//                        lane group: K3's cell body (frr_lanes.cuh) into a
//                        (SBLK, LGRP) accumulator, written to the cell's
//                        (SBLK, Q) partial.  A host plan launches exactly
//                        nlive blocks per lane group; a device plan, whose
//                        count lives only in device memory, a fixed grid of
//                        a few blocks per SM striding over c < *nlive.
//   frr_wl_lanes_fold    one thread block per segment block folds that
//                        block's partials into the (num_segments, Q) inbox
//                        in cell-list order, through the same stable
//                        ordering of wl_i[:nlive] (order, ptr) as K2's
//                        fold.  No float atomics anywhere.
//
// Bound.  As K3, plus the partials: SBLK * Q floats a live cell, written
// once and read back once by the fold (16 KB a cell at Q = 16).  The
// buffer is sized by the plan's padded length, l_pad * SBLK * Q * 4 bytes:
// 1 GiB for a device plan of 65,536 cells at Q = 16, so the wrapper checks
// it against free device memory before it allocates.  `dbg` counts
// executed cells, once per cell (lane group 0).

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
                    const uint8_t* __restrict__ unitw,
                    const int32_t* __restrict__ wl_i,
                    const int32_t* __restrict__ wl_j,
                    const int32_t* __restrict__ nlive, int num_edges, int Q,
                    float* __restrict__ partials,
                    int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;
  const int lane_q = blockIdx.y * LGRP + (threadIdx.x & 31);
  const bool unit = lane_q < Q && unitw[lane_q] != 0;
  const int n = *nlive;
  for (int c = blockIdx.x; c < n; c += gridDim.x) {
    if (dbg != nullptr && blockIdx.y == 0 && threadIdx.x == 0)
      atomicAdd(dbg, 1);
    clear_lane_acc<KIND>(acc);
    stage_chunk(st, src, w, mask, ids, wl_j[c], num_edges, wl_i[c] * SBLK);
    __syncthreads();
    fold_lanes<RELAX, KIND>(acc, st, gval, Q, lane_q, unit);
    __syncthreads();
    float* row = partials + static_cast<size_t>(c) * SBLK * Q;
    for (int t = threadIdx.x; t < SBLK * LGRP; t += THREADS) {
      const int q = blockIdx.y * LGRP + t % LGRP;
      if (q < Q) row[(t / LGRP) * Q + q] = acc[t / LGRP][t % LGRP];
    }
    __syncthreads();                      // acc and st are reused
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_lanes_fold_kernel(const float* __restrict__ partials,
                         const int64_t* __restrict__ order,
                         const int32_t* __restrict__ ptr, int num_segments,
                         int Q, float* __restrict__ out) {
  const int i = blockIdx.x;
  const int p0 = ptr[i];
  const int p1 = ptr[i + 1];
  const int n = SBLK * Q;                 // a block's (SBLK, Q) entries
  const int rows = min(SBLK, num_segments - i * SBLK);
  for (int t = threadIdx.x; t < rows * Q; t += THREADS) {
    float r = identity<KIND>();
    for (int p = p0; p < p1; ++p)
      r = combine<KIND>(r, partials[order[p] * n + t]);
    out[static_cast<size_t>(i) * n + t] = r;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `nlive` is a (1,) device count;
// `grid` >= 1 blocks per lane group stride over the cells; `partials` is
// (l_pad, SBLK, Q); `dbg` may be null.
extern "C" int frr_wl_lanes_launch(const float* gval, const int32_t* src,
                                   const float* w, const uint8_t* mask,
                                   const int32_t* ids, const uint8_t* unitw,
                                   const int32_t* wl_i, const int32_t* wl_j,
                                   const int32_t* nlive, int num_edges,
                                   int grid, int Q, float* partials,
                                   int32_t* dbg, int relax, int kind,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 g(grid, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_WLL_ARGS gval, src, w, mask, ids, unitw, wl_i, wl_j, nlive, \
                     num_edges, Q, partials, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_wl_lanes_kernel<ADD_W, KIND_MIN><<<g, block, 0, s>>>(FRR_WLL_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_wl_lanes_kernel<MUL_W, KIND_SUM><<<g, block, 0, s>>>(FRR_WLL_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_WLL_ARGS
  return static_cast<int>(cudaGetLastError());
}

// Fold the (l_pad, SBLK, Q) partials into the (num_segments, Q) inbox:
// block i combines partials[order[p]] for p in [ptr[i], ptr[i + 1]) in
// that order.
extern "C" int frr_wl_lanes_fold(const float* partials, const int64_t* order,
                                 const int32_t* ptr, int num_blocks,
                                 int num_segments, int Q, float* out,
                                 int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1 || Q < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == KIND_MIN)
    frr_wl_lanes_fold_kernel<KIND_MIN><<<num_blocks, THREADS, 0, s>>>(
        partials, order, ptr, num_segments, Q, out);
  else if (kind == KIND_SUM)
    frr_wl_lanes_fold_kernel<KIND_SUM><<<num_blocks, THREADS, 0, s>>>(
        partials, order, ptr, num_segments, Q, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
