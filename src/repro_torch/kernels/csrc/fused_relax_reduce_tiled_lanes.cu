// Lane-batched tiled fused frontier relax + segment reduce for Hopper
// (sm_90a): kernel K7.
//
// Replaces the TPU kernel `_kernel_tiled_lanes` (with its loop
// `_tile_loop`) launched by `_fused_lanes_tiled` in
// src/repro/kernels/fused_relax_reduce.py.  It computes what K3
// (fused_relax_reduce_lanes.cu) computes over a (V, Q) frontier-masked
// lane table, but each live cell copies the tiles of its chunk's tile
// list — built from the frontier OR'd across lanes — into a 2-slot
// shared-memory buffer and gathers from there.
//
// Launch shape: K3's (segment block, 32-lane group) grid, one owner
// thread per (segment, lane) accumulator (frr_lanes.cuh).  A block
// stages only its own group's columns of each (vblk, Q) tile, a strided
// copy with a row stride of Q * 4 bytes (16-byte pieces when Q % 4 == 0,
// else 4-byte ones), so its two slots take 2 * vblk * min(Q, 32) * 4
// bytes.  Per chunk it stages the chunk's edges once (K3's stage), then
// folds each tile's own edges (their staged positions, from the tile
// tables) from the tile's slot.  A lane past Q, or converged, reads the
// identity and changes nothing.  `dbg` counts [cells, tile copies], once
// per (cell, tile) whatever the lane groups, as the TPU kernel does; the
// bytes a copy moves are vblk * Q * 4 over all groups.
//
// Bound: K3's (the round's edges, the (V, Q) table, the inbox).  The
// tiles are extra traffic: at Q = 16 and vblk 768 a chunk whose sources
// spread over the table copies hundreds of tiles of 48 KB each.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_tiled_lanes_kernel(const float* __restrict__ gval,
                       const int32_t* __restrict__ src,
                       const float* __restrict__ w,
                       const uint8_t* __restrict__ mask,
                       const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ unitw,
                       const int32_t* __restrict__ blk_ptr,
                       const int32_t* __restrict__ blk_chunk,
                       const uint8_t* __restrict__ chunk_act, TileTables tt,
                       int num_edges, int num_segments, int num_slots, int Q,
                       int vblk, float* __restrict__ out,
                       int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;
  extern __shared__ __align__(16) float tile_s[];   // [2][vblk][lw]
  const int t = threadIdx.x & 31;
  const int c0 = blockIdx.y * LGRP;
  const int lane_q = c0 + t;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - c0);
  const bool on = lane_q < Q;
  const bool unit = on && unitw[lane_q] != 0;
  clear_lane_acc<KIND>(acc);

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  for (int p = blk_ptr[blockIdx.x]; p < p1; ++p) {
    const int j = blk_chunk[p];
    if (!chunk_act[j]) continue;          // frontier skip, block-uniform
    __syncthreads();                      // the last chunk's stage is read
    stage_chunk(st, src, w, mask, ids, j, num_edges, seg0);
    __syncthreads();
    const int32_t* pos = tt.positions(j);
    const int copies = walk_tiles(
        tt, CellSchedule{}, 0, j,
        [&](int slot, int tile) {
          copy_lane_tile(tile_s + slot * vblk * lw, gval, tile, vblk,
                         num_slots, Q, c0, gw, lw);
        },
        [&](int slot, int tile, int k) {
          const int b0 = tt.begin(j, k);
          fold_lane_list<RELAX, KIND>(
              acc, st, TilePos{pos + b0}, tt.begin(j, k + 1) - b0,
              TileRows{tile_s + slot * vblk * lw, tile * vblk, lw, t}, on,
              unit);
        });
    if (dbg != nullptr && blockIdx.y == 0 && threadIdx.x == 0) {
      atomicAdd(dbg, 1);
      atomicAdd(dbg + 1, copies);
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < SBLK * LGRP; k += THREADS) {
    const int d = seg0 + k / LGRP;
    const int q = c0 + k % LGRP;
    if (d < num_segments && q < Q)
      out[static_cast<size_t>(d) * Q + q] = acc[k / LGRP][k % LGRP];
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `unitw` is (Q,) uint8; the tile
// tables as for K5; `dbg` ((2,) int32) may be null.
extern "C" int frr_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const uint8_t* unitw,
    const int32_t* blk_ptr, const int32_t* blk_chunk,
    const uint8_t* chunk_act, const int32_t* ntiles, const int32_t* tiles,
    const int32_t* off, const int32_t* order, int num_edges,
    int num_segments, int num_blocks, int num_slots, int Q, int vblk,
    int t_max, float* out, int32_t* dbg, int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1 || Q < 1 || vblk < 128 || vblk % 128 || t_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileTables tt{ntiles, tiles, off, order, t_max};
  const size_t smem =
      2 * static_cast<size_t>(vblk) * (Q < LGRP ? Q : LGRP) * sizeof(float);
  dim3 grid(num_blocks, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_TL_ARGS gval, src, w, mask, ids, unitw, blk_ptr, blk_chunk, \
                    chunk_act, tt, num_edges, num_segments, num_slots, Q, \
                    vblk, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_tiled_lanes_kernel<ADD_W, KIND_MIN>, grid,
                            block, smem, s, FRR_TL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_tiled_lanes_kernel<MUL_W, KIND_SUM>, grid,
                            block, smem, s, FRR_TL_ARGS);
#undef FRR_TL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
