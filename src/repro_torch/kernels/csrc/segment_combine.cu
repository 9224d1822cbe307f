// Blocked semiring segment reduce for Hopper (sm_90a): kernel K9.
//
// Replaces the TPU kernel `_kernel` launched by `segment_combine_pallas`
// in src/repro/kernels/rhizome_segment_reduce.py, the standalone reduce of
// the engine's pallas_mode='reduce' composition (plain relax ops, then
// this kernel).  For every segment d:
//
//   out[d] = (+) over edges e with ids[e] == d of data[e]
//
// where (+) is min or sum; empty segments hold the identity.  `data` is
// float32 or bfloat16; the kernel accumulates in float32 and writes the
// input type (one rounding per segment).
//
// Launch shape: K1's without the gather and relax.  One thread block owns
// one SBLK-wide segment block and walks the edge chunks whose [lo, hi]
// destination range meets it (blk_ptr / blk_chunk from the launch plan,
// chunks ascending): the sorted-range skip.  There is no frontier skip:
// the messages are already relaxed and masked.  The reduction is the warp
// fold of frr_common.cuh (`fold_edges`) fed by data[e], so a sum is the
// same from run to run and min is exact.  `dbg` counts the (block, chunk)
// cells walked.
//
// Bound.  Bytes: every edge's message and id read once and the out vector
// written once (RMAT-18: 4.19 M edges x 8 B = 34 MB, about 10 us at
// 3.35 TB/s); one combine per edge.  Like K1 it reads a chunk once per
// segment block that the chunk meets (4.9 on average on the RMAT-18
// partition), with the re-reads mostly served from L2.

#include <cuda_bf16.h>

#include "frr_common.cuh"

namespace {

using namespace frr;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct DataMsg {                          // every edge's message is data[e]
  const T* data;
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ float value(int e) const {
    return to_float(data[e]);
  }
};

template <typename T, int KIND>
__global__ void __launch_bounds__(THREADS)
segment_combine_kernel(const T* __restrict__ data,
                       const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ blk_ptr,
                       const int32_t* __restrict__ blk_chunk, int num_edges,
                       int num_segments, T* __restrict__ out,
                       int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  clear_acc<KIND>(acc);
  __syncthreads();

  const int seg0 = blockIdx.x * SBLK;
  const int p0 = blk_ptr[blockIdx.x];
  const int p1 = blk_ptr[blockIdx.x + 1];
  if (dbg != nullptr && threadIdx.x == 0 && p1 > p0) atomicAdd(dbg, p1 - p0);
  for (int p = p0; p < p1; ++p)
    fold_edges<KIND>(acc, msg_s, DataMsg<T>{data}, ids, blk_chunk[p],
                     num_edges, seg0);
  __syncthreads();

  for (int t = threadIdx.x; t < SBLK; t += THREADS) {
    const int d = seg0 + t;
    if (d < num_segments) out[d] = from_float<T>(fold_warps<KIND>(acc, t));
  }
}

template <typename T>
int launch(const void* data, const int32_t* ids, const int32_t* blk_ptr,
           const int32_t* blk_chunk, int num_edges, int num_segments,
           int num_blocks, void* out, int32_t* dbg, int kind,
           cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  if (kind == KIND_MIN)
    segment_combine_kernel<T, KIND_MIN><<<num_blocks, THREADS, 0, s>>>(
        d, ids, blk_ptr, blk_chunk, num_edges, num_segments, o, dbg);
  else if (kind == KIND_SUM)
    segment_combine_kernel<T, KIND_SUM><<<num_blocks, THREADS, 0, s>>>(
        d, ids, blk_ptr, blk_chunk, num_edges, num_segments, o, dbg);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  kind: 0 min, 1 sum;
// dtype: 0 float32, 1 bfloat16 (data and out alike); `dbg` may be null.
extern "C" int segment_combine_launch(const void* data, const int32_t* ids,
                                      const int32_t* blk_ptr,
                                      const int32_t* blk_chunk,
                                      int num_edges, int num_segments,
                                      int num_blocks, void* out,
                                      int32_t* dbg, int kind, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(data, ids, blk_ptr, blk_chunk, num_edges,
                         num_segments, num_blocks, out, dbg, kind, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, ids, blk_ptr, blk_chunk, num_edges,
                                 num_segments, num_blocks, out, dbg, kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
