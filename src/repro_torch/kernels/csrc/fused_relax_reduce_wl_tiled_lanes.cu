// Lane-batched tiled worklist launch of the fused frontier relax +
// segment reduce for Hopper (sm_90a): kernel K8.
//
// Replaces the TPU kernel `_kernel_wl_tiled_lanes` launched by
// `_fused_lanes_tiled_wl` in src/repro/kernels/fused_relax_reduce.py.
// K8 runs K6's two plan forms (fused_relax_reduce_wl_tiled.cu: a host
// plan's runs of cells sharing wl_j, each block following the plan's
// slot/fetch schedule restarted at the run's first cell; a device plan's
// fixed grid striding over *nlive, each cell copying its chunk's tiles)
// with a laned tile body (K3's stage and fold, frr_lanes.cuh: a 32-lane
// group per block, its columns of each (vblk, Q) tile staged in shared
// memory, a strided copy 16 bytes a piece when Q % 4 == 0, else 4),
// and writes one (SBLK, Q) partial per cell that K4's laned fold
// (fused_relax_reduce_wl_lanes.cu, frr_wl_lanes_fold) combines into the
// inbox in cell-list order.  `dbg` counts [cells, tile copies] once per
// cell, whatever the lane groups.
//
// Bound: K4's (the round's edges, the (V, Q) table, the inbox, plus the
// SBLK * Q partial floats a live cell writes and the fold reads back);
// the tile copies are extra traffic, as for K6.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_tiled_lanes_kernel(const float* __restrict__ gval,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ w,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ ids,
                          const uint8_t* __restrict__ unitw,
                          const int32_t* __restrict__ wl_i,
                          const int32_t* __restrict__ wl_j,
                          const int32_t* __restrict__ nlive,
                          const int32_t* __restrict__ run_ptr,
                          CellSchedule cs, TileTables tt, int num_edges,
                          int num_slots, int Q, int vblk, int n_runs,
                          float* __restrict__ partials,
                          int32_t* __restrict__ dbg) {
  __shared__ float acc[SBLK][LGRP];
  __shared__ LaneStage st;
  extern __shared__ __align__(16) float tile_s[];   // [2][vblk][lw]
  const int t = threadIdx.x & 31;
  const int q0 = blockIdx.y * LGRP;
  const int lane_q = q0 + t;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - q0);
  const bool on = lane_q < Q;
  const bool unit = on && unitw[lane_q] != 0;
  const BlockCells cells = block_cells(run_ptr, n_runs, nlive);
  for (int c = cells.c0; c < cells.c1; c += cells.step) {
    const int j = wl_j[c];
    clear_lane_acc<KIND>(acc);
    stage_chunk(st, src, w, mask, ids, j, num_edges, wl_i[c] * SBLK);
    __syncthreads();
    const int32_t* pos = tt.positions(j);
    const int copies = walk_tiles(
        tt, cs, c, j,
        [&](int slot, int tile) {
          copy_lane_tile(tile_s + slot * vblk * lw, gval, tile, vblk,
                         num_slots, Q, q0, gw, lw);
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
    float* row = partials + static_cast<size_t>(c) * SBLK * Q;
    for (int k = threadIdx.x; k < SBLK * LGRP; k += THREADS) {
      const int q = q0 + k % LGRP;
      if (q < Q) row[(k / LGRP) * Q + q] = acc[k / LGRP][k % LGRP];
    }
    __syncthreads();                      // acc and st are reused
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  Plan arguments as for K6 (null
// run_ptr and cell tables for a device plan); `partials` is
// (l_pad, SBLK, Q); `dbg` ((2,) int32) may be null.
extern "C" int frr_wl_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const uint8_t* unitw,
    const int32_t* wl_i, const int32_t* wl_j, const int32_t* nlive,
    const int32_t* run_ptr, const int32_t* cell_ntiles,
    const int32_t* cell_tile, const int32_t* cell_slot,
    const int32_t* cell_fetch, const int32_t* ntiles, const int32_t* tiles,
    const int32_t* off, const int32_t* order, int num_edges, int num_slots,
    int Q, int vblk, int t_max, int cell_tmax, int grid, int n_runs,
    float* partials, int32_t* dbg, int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || Q < 1 || vblk < 128 || vblk % 128 || t_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileTables tt{ntiles, tiles, off, order, t_max};
  const CellSchedule cs{cell_ntiles, cell_tile, cell_slot, cell_fetch,
                        cell_tmax};
  const size_t smem =
      2 * static_cast<size_t>(vblk) * (Q < LGRP ? Q : LGRP) * sizeof(float);
  dim3 g(grid, (Q + LGRP - 1) / LGRP), block(THREADS);
#define FRR_WLTL_ARGS gval, src, w, mask, ids, unitw, wl_i, wl_j, nlive, \
                      run_ptr, cs, tt, num_edges, num_slots, Q, vblk, \
                      n_runs, partials, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<ADD_W, KIND_MIN>, g,
                            block, smem, s, FRR_WLTL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_wl_tiled_lanes_kernel<MUL_W, KIND_SUM>, g,
                            block, smem, s, FRR_WLTL_ARGS);
#undef FRR_WLTL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
