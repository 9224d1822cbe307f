// Parent trees of a min-semiring fixpoint for Hopper (sm_90a): kernel K10.
//
// Replaces no TPU kernel: the JAX package returns no search tree.  It
// was added for Graph500's kernels 2 and 3 (BFS and SSSP), whose output
// is a parent array.  After `run_stacked` has reached its fixpoint, one
// launch walks the partition's stacked edges (S * E_max of them, as the
// engine holds them on the card) and, for every input edge (u, v, w)
// with
//
//   fl32(d[u] + w) == d[v]  and  d[u] < d[v]          (w = 1 for BFS)
//
// offers u as v's parent; parent[v] keeps the smallest global id offered
// (an atomic min into the (n,) array, so every replica of v agrees).
// d[u] is read at the edge's source root slot, d[v] at its destination
// replica slot (replicas agree at the fixpoint: the collapse made them
// so); ids come from the slot -> vertex table.  A tie round (`ties`)
// takes the edges with d[u] == d[v] instead and offers u only where u
// had a parent before the round (`before`, a copy of the array) and v
// had none: a vertex reached only through zero weights, or through a
// weight that rounding absorbed, takes its parent that way, and the
// result is a tree whatever the weights.
//
// Bound.  Bytes: each edge's source and destination slot, mask and
// (SSSP) weight read once, two values gathered from the (S, R_max)
// table, the (n,) parent array written.  A warp takes 32 consecutive
// edges; the engine sorts each shard's edges by destination slot, so the
// candidates of one warp
// often share v: they are grouped with __match_any_sync, reduced with
// __reduce_min_sync, and the group's first lane makes the one atomic,
// after a plain read that skips it where the array already holds a
// smaller id.  The (S, E_max) padding (mask false) is read and skipped.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;
constexpr int32_t NONE = INT_MAX;          // no parent (yet)
constexpr unsigned FULL = 0xffffffffu;

template <bool TIES, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS) tree_parents_kernel(
    const float* __restrict__ val, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const float* __restrict__ w,
    const bool* __restrict__ mask, const int32_t* __restrict__ slot_vertex,
    const int32_t* __restrict__ before, int64_t num_edges,
    int32_t* parent) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS * 32;
  // every lane of a warp runs the same trips: the warp votes below
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32) * 32;
       base < num_edges; base += stride) {
    const int64_t e = base + lane;
    bool cand = false;
    int32_t u = NONE, v = -1;
    if (e < num_edges && mask[e]) {
      const int32_t s = src[e], t = dst[e];
      const float du = val[s], dv = val[t];
      const float c = WEIGHTED ? w[e] : 1.0f;
      if ((TIES ? du == dv : du < dv) && dv < INFINITY &&
          __fadd_rn(du, c) == dv) {
        u = slot_vertex[s];
        v = slot_vertex[t];
        cand = TIES ? (before[u] != NONE && before[v] == NONE) : true;
      }
    }
    if (__ballot_sync(FULL, cand) == 0) continue;
    if (!cand) v = -1;
    const unsigned peers = __match_any_sync(FULL, v);
    const int32_t best = __reduce_min_sync(peers, cand ? u : NONE);
    if (cand && lane == __ffs(peers) - 1 && best < parent[v])
      atomicMin(parent + v, best);
  }
}

template <bool TIES>
void launch(const float* val, const int32_t* src, const int32_t* dst,
            const float* w, const bool* mask, const int32_t* slot_vertex,
            const int32_t* before, int32_t* parent, int64_t num_edges,
            int weighted, int blocks, cudaStream_t s) {
  if (weighted)
    tree_parents_kernel<TIES, true><<<blocks, THREADS, 0, s>>>(
        val, src, dst, w, mask, slot_vertex, before, num_edges, parent);
  else
    tree_parents_kernel<TIES, false><<<blocks, THREADS, 0, s>>>(
        val, src, dst, w, mask, slot_vertex, before, num_edges, parent);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `val`: the flat
// (S * R_max,) float32 values; `src`, `dst`: (E,) int32 slot ids (the
// source's root slot, the destination's replica slot); `w`: (E,) float32
// (read only when `weighted`); `mask`: (E,) bool; `slot_vertex`: (S *
// R_max,) int32 vertex ids; `parent`: (n,) int32, NONE where no parent
// yet, lowered in place.  `before` is null for the first pass and a copy
// of `parent` for a tie round.
extern "C" int tree_parents_launch(const float* val, const int32_t* src,
                                   const int32_t* dst, const float* w,
                                   const bool* mask,
                                   const int32_t* slot_vertex,
                                   const int32_t* before, int32_t* parent,
                                   long long num_edges, int weighted,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_edges <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = (num_edges + 31) / 32;
  const long long need = (warps + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(
      need < static_cast<long long>(sms) * BLOCKS_PER_SM
          ? need
          : static_cast<long long>(sms) * BLOCKS_PER_SM);
  if (before == nullptr)
    launch<false>(val, src, dst, w, mask, slot_vertex, before, parent,
                  num_edges, weighted, blocks, s);
  else
    launch<true>(val, src, dst, w, mask, slot_vertex, before, parent,
                 num_edges, weighted, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
