// Shared pieces of the tiled fused relax + reduce kernels (K5-K8): the
// value table stays in device memory and is read through shared memory.
// The worklist kernels K6 and K8 copy the vblk-wide slot tiles that a
// cell's active sources fall in into a 2-slot shared-memory buffer and
// fold each tile's own edges from there; the dense kernels K5 and K7
// stage only the source rows a cell reads (their own sources) and use the
// cp.async helpers below.
//
// Tile tables (built per round on the device, fused_relax_reduce.py
// `_chunk_tile_tables`): chunk j's active edges fall in the ntiles[j]
// distinct tiles tiles[j][0..ntiles[j]) (ascending); order[j] lists the
// chunk's edge positions stably sorted by tile, so tile k's own edges are
// order[j][off[j][k] .. off[j][k + 1]), in chunk order.
//
// Copies are cp.async (16-byte pieces where the rows allow it, 4-byte
// otherwise), one commit group per tile, and the walk keeps tile t+1's
// copy in flight while tile t is folded: at step t the block commits
// tile t+1's group (or an empty one), waits for all groups but the
// newest, and syncs.  A copy never reads past the table's last row.
#pragma once

#include "frr_lanes.cuh"

namespace frr {

struct TileTables {
  const int32_t* ntiles;   // (n_chunks,)
  const int32_t* tiles;    // (n_chunks, t_max)
  const int32_t* off;      // (n_chunks, t_max + 1)
  const int32_t* order;    // (n_chunks, EBLK)
  int t_max;

  __device__ __forceinline__ int count(int j) const { return ntiles[j]; }
  __device__ __forceinline__ int tile(int j, int k) const {
    return tiles[static_cast<size_t>(j) * t_max + k];
  }
  __device__ __forceinline__ int begin(int j, int k) const {
    return off[static_cast<size_t>(j) * (t_max + 1) + k];
  }
  __device__ __forceinline__ const int32_t* positions(int j) const {
    return order + static_cast<size_t>(j) * EBLK;
  }
  // k with tile(j, k) == tile, or -1 (the list is ascending)
  __device__ __forceinline__ int find(int j, int tile_id) const {
    int lo = 0, hi = ntiles[j];
    const int32_t* row = tiles + static_cast<size_t>(j) * t_max;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < tile_id) lo = mid + 1; else hi = mid;
    }
    return lo < ntiles[j] && row[lo] == tile_id ? lo : -1;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every committed group but the newest has landed (the
// caller then syncs the block before reading it).
__device__ __forceinline__ void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until every committed group but the newest has landed, then make
// the landed data visible to the whole block.
__device__ __forceinline__ void cp_async_wait_prev() {
  cp_async_wait_group1();
  __syncthreads();
}

// Rows of tile `tile` that exist in a table of `num_slots` rows.
__device__ __forceinline__ int tile_rows(int tile, int vblk, int num_slots) {
  const long long base = static_cast<long long>(tile) * vblk;
  return static_cast<int>(min(static_cast<long long>(vblk),
                              static_cast<long long>(num_slots) - base));
}

// Start copying tile `tile` of the (V,) table into buf[0 .. vblk) (all
// threads call it; the table is 16-byte aligned and vblk % 128 == 0).
__device__ __forceinline__ void copy_tile(float* buf,
                                          const float* __restrict__ gval,
                                          int tile, int vblk, int num_slots) {
  const int n = tile_rows(tile, vblk, num_slots);
  const float* g = gval + static_cast<size_t>(tile) * vblk;
  const int n4 = n >> 2;
  for (int k = threadIdx.x; k < n4; k += blockDim.x)
    cp_async16(buf + 4 * k, g + 4 * k);
  for (int k = 4 * n4 + threadIdx.x; k < n; k += blockDim.x)
    cp_async4(buf + k, g + k);
}

// Start copying columns [c0, c0 + gw) of tile `tile` of the (V, Q) table
// into buf[r * lw + c] (lw = min(Q, LGRP) >= gw).  With Q % 4 == 0 the row
// pieces are 16-byte aligned and go 16 bytes at a time.
__device__ __forceinline__ void copy_lane_tile(
    float* buf, const float* __restrict__ gval, int tile, int vblk,
    int num_slots, int Q, int c0, int gw, int lw) {
  const int rows = tile_rows(tile, vblk, num_slots);
  const float* g = gval + static_cast<size_t>(tile) * vblk * Q + c0;
  if ((Q & 3) == 0) {
    const int per = gw >> 2;
    for (int k = threadIdx.x; k < rows * per; k += blockDim.x) {
      const int r = k / per, c = 4 * (k % per);
      cp_async16(buf + r * lw + c, g + static_cast<size_t>(r) * Q + c);
    }
  } else {
    for (int k = threadIdx.x; k < rows * gw; k += blockDim.x) {
      const int r = k / gw, c = k % gw;
      cp_async4(buf + r * lw + c, g + static_cast<size_t>(r) * Q + c);
    }
  }
}

// Unlaned tile message: relax(tile_s[src[e] - base], w[e]) where mask[e].
template <int RELAX>
struct TileMsg {
  const float* tile_s;            // the tile's slot in shared memory
  int base;                       // the tile's first table row
  const int32_t* src;
  const float* w;
  const uint8_t* mask;
  __device__ __forceinline__ bool valid(int e) const {
    return __ldg(mask + e) != 0;
  }
  __device__ __forceinline__ float value(int e) const {
    return relax<RELAX>(tile_s[__ldg(src + e) - base], w, e);
  }
};

struct TileEdges {                // a tile's edges: chunk positions -> edges
  const int32_t* pos;
  int e0;
  __device__ __forceinline__ int operator()(int k) const {
    return e0 + __ldg(pos + k);
  }
};

struct TilePos {                  // a tile's edges as staged chunk positions
  const int32_t* pos;
  __device__ __forceinline__ int operator()(int k) const {
    return __ldg(pos + k);
  }
};

struct TileRows {                 // this thread's lane of a staged tile
  const float* tile_s;
  int base;
  int lw;
  int t;
  __device__ __forceinline__ float operator()(int s) const {
    return tile_s[(s - base) * lw + t];
  }
};

// A tiled host plan's per-cell tile schedule (K6, K8): cell c lists
// ntiles[c] tiles tile[c][k] (a subset of its chunk's, ascending), each
// read from shared-memory slot slot[c][k] and copied there first iff
// fetch[c][k].  All null: a cell walks its chunk's own list and copies
// every tile, tile k into slot k % 2 (device plans).
struct CellSchedule {
  const int32_t* ntiles;
  const int32_t* tile;
  const int32_t* slot;
  const int32_t* fetch;
  int t_max;
};

// The worklist cells a K6/K8 block runs: a host plan's run blockIdx.x
// (run_ptr, one block per run of cells sharing wl_j), or a device plan's
// cells blockIdx.x, blockIdx.x + gridDim.x, ... below *nlive.
struct BlockCells {
  int c0, c1, step;
};

__device__ __forceinline__ BlockCells block_cells(
    const int32_t* __restrict__ run_ptr, int n_runs,
    const int32_t* __restrict__ nlive) {
  if (run_ptr == nullptr)
    return {static_cast<int>(blockIdx.x), *nlive,
            static_cast<int>(gridDim.x)};
  if (static_cast<int>(blockIdx.x) >= n_runs) return {0, 0, 1};
  return {run_ptr[blockIdx.x], run_ptr[blockIdx.x + 1], 1};
}

// Walk cell c (chunk j)'s tiles: copy(slot, tile) starts a tile's copy
// into a slot, fold(slot, tile, k) folds the edges of the chunk's k-th
// tile from that slot.  Tile t+1's copy is in flight while tile t is
// folded.  All threads call it; returns the copies it started.
template <class Copy, class Fold>
__device__ __forceinline__ int walk_tiles(const TileTables& tt,
                                          const CellSchedule& cs, int c,
                                          int j, const Copy& copy,
                                          const Fold& fold) {
  const bool own = cs.tile == nullptr;
  const size_t row = static_cast<size_t>(c) * cs.t_max;
  const int n = own ? tt.count(j) : cs.ntiles[c];
  auto tile = [&](int t) { return own ? tt.tile(j, t) : cs.tile[row + t]; };
  auto slot = [&](int t) { return own ? (t & 1) : cs.slot[row + t]; };
  auto fetch = [&](int t) { return own ? 1 : cs.fetch[row + t]; };
  int copies = 0;
  if (n > 0 && fetch(0)) copy(slot(0), tile(0));
  cp_async_commit();
  for (int t = 0; t < n; ++t) {
    if (t + 1 < n && fetch(t + 1)) copy(slot(t + 1), tile(t + 1));
    cp_async_commit();
    cp_async_wait_prev();                 // tile t has landed
    const int k = own ? t : tt.find(j, tile(t));
    if (k >= 0) fold(slot(t), tile(t), k);
    __syncthreads();                      // the slot is read before reuse
    copies += fetch(t);
  }
  return copies;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, first
// raising the kernel's dynamic limit to it: static and dynamic shared
// memory together may pass the default 48 KB only with that opt-in.
// Returns the launch's cudaError_t.
template <class... KArgs, class... Args>
inline int launch_with_smem(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                            size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace frr
