// Worklist launch of the fused frontier relax + segment reduce for Hopper
// (sm_90a): kernel K2 and its fold.
//
// Replaces the TPU kernel `_kernel_wl` launched by `_fused_pinned_wl` in
// src/repro/kernels/fused_relax_reduce.py, and the `_scatter_partials`
// fold after it.  A worklist lists live (segment block, edge chunk)
// cells, j-major: cell c works chunk wl_j[c] against block wl_i[c].
//
//   frr_wl_kernel  one thread block per live cell (c < *nlive): gather,
//                  relax, mask and reduce the chunk's EBLK edges into an
//                  (SBLK,) partial in shared memory with the warp fold of
//                  frr_common.cuh, then write it to partials[c].  A host
//                  plan launches exactly nlive blocks; a device plan, whose
//                  count lives only in device memory, launches a fixed grid
//                  of a few blocks per SM that strides over c < *nlive.
//   frr_wl_fold    one thread block per segment block i folds that block's
//                  partials into the inbox in cell-list order, through a
//                  stable ordering of wl_i[:nlive] (order, ptr) built on
//                  the device; a block with no live cell writes the
//                  identity.  No float atomics anywhere, so sums repeat bit
//                  for bit and min is exact.
//
// Bound.  Bytes: a round must read each active edge's src, id, mask and
// weight once, the value table once, and write the inbox once.  K2 reads
// each live cell's chunk once, so a chunk whose range meets several
// blocks is still read once per live cell (4.9 on average at RMAT-18, as
// K1), but by blocks that run in any order rather than by one block per
// segment block in turn; its partials (SBLK floats a cell) are written
// and read back once by the fold.  That partial traffic, 1 KB per cell,
// is the price of the order-free cell grid.  `dbg` counts executed cells.

#include "frr_common.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_kernel(const float* __restrict__ gval,
              const int32_t* __restrict__ src,
              const float* __restrict__ w,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ ids,
              const int32_t* __restrict__ wl_i,
              const int32_t* __restrict__ wl_j,
              const int32_t* __restrict__ nlive, int num_edges,
              float* __restrict__ partials, int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  const int n = *nlive;
  for (int c = blockIdx.x; c < n; c += gridDim.x) {
    clear_acc<KIND>(acc);
    __syncthreads();
    if (dbg != nullptr && threadIdx.x == 0) atomicAdd(dbg, 1);
    fold_chunk<RELAX, KIND>(acc, msg_s, gval, src, w, mask, ids, wl_j[c],
                            num_edges, wl_i[c] * SBLK);
    __syncthreads();
    float* row = partials + static_cast<size_t>(c) * SBLK;
    for (int t = threadIdx.x; t < SBLK; t += THREADS)
      row[t] = fold_warps<KIND>(acc, t);
    __syncthreads();                      // acc is cleared for the next cell
  }
}

template <int KIND>
__global__ void __launch_bounds__(SBLK)
frr_wl_fold_kernel(const float* __restrict__ partials,
                   const int64_t* __restrict__ order,
                   const int32_t* __restrict__ ptr, int num_segments,
                   float* __restrict__ out) {
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  float r = identity<KIND>();
  const int p1 = ptr[i + 1];
  for (int p = ptr[i]; p < p1; ++p)
    r = combine<KIND>(r, partials[order[p] * SBLK + t]);
  const int d = i * SBLK + t;
  if (d < num_segments) out[d] = r;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  `nlive` is a (1,) device count;
// `grid` >= 1 blocks stride over the cells; `dbg` may be null.
extern "C" int frr_wl_launch(const float* gval, const int32_t* src,
                             const float* w, const uint8_t* mask,
                             const int32_t* ids, const int32_t* wl_i,
                             const int32_t* wl_j, const int32_t* nlive,
                             int num_edges, int grid, float* partials,
                             int32_t* dbg, int relax, int kind,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
#define FRR_WL_ARGS gval, src, w, mask, ids, wl_i, wl_j, nlive, num_edges, \
                    partials, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_wl_kernel<ADD_W, KIND_MIN><<<grid, THREADS, 0, s>>>(FRR_WL_ARGS);
  else if (relax == ADD_ONE && kind == KIND_MIN)
    frr_wl_kernel<ADD_ONE, KIND_MIN><<<grid, THREADS, 0, s>>>(FRR_WL_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_wl_kernel<MUL_W, KIND_SUM><<<grid, THREADS, 0, s>>>(FRR_WL_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_WL_ARGS
  return static_cast<int>(cudaGetLastError());
}

// Fold the (l_pad, SBLK) partials into the (num_segments,) inbox: block i
// combines partials[order[p]] for p in [ptr[i], ptr[i + 1]) in that order.
extern "C" int frr_wl_fold(const float* partials, const int64_t* order,
                           const int32_t* ptr, int num_blocks,
                           int num_segments, float* out, int kind,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == KIND_MIN)
    frr_wl_fold_kernel<KIND_MIN><<<num_blocks, SBLK, 0, s>>>(
        partials, order, ptr, num_segments, out);
  else if (kind == KIND_SUM)
    frr_wl_fold_kernel<KIND_SUM><<<num_blocks, SBLK, 0, s>>>(
        partials, order, ptr, num_segments, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
