// Tiled worklist launch of the fused frontier relax + segment reduce for
// Hopper (sm_90a): kernel K6.
//
// Replaces the TPU kernel `_kernel_wl_tiled` (with its loop
// `_wl_tile_loop`) launched by `_fused_tiled_wl` in
// src/repro/kernels/fused_relax_reduce.py.  K6 is the tiled twin of K2:
// a worklist lists live (segment block, edge chunk) cells, j-major, and
// each cell writes an (SBLK,) partial that K2's fold
// (fused_relax_reduce_wl.cu, frr_wl_fold) combines into the inbox in
// cell-list order.  Each cell copies the vblk-wide slot tiles its active
// sources fall in into a 2-slot shared-memory buffer and folds each
// tile's own edges from there (frr_tiles.cuh walk_tiles).
//
//   host plan    one block per run of consecutive cells that share wl_j
//                (run_ptr).  A cell walks its own dst-filtered tile list
//                and follows the plan's slot/fetch schedule, so a tile
//                still in a slot from the run's previous cell is reused,
//                not copied.  On a TPU the grid runs in order on one core
//                and the reference's schedule also reuses tiles across
//                runs; here the runs are independent blocks, and the
//                planner restarts the schedule at each run's first cell
//                (`tile_schedule`), so the copies made are exactly the
//                plan's.
//   device plan  the count lives only in device memory: a fixed grid of a
//                few blocks per SM strides over c < *nlive, one cell at a
//                time, and a cell walks its chunk's whole tile list
//                (through wl_j: no per-cell tables), copying every tile.
//
// `dbg` counts [executed cells, tile copies].  Bound: K2's (the round's
// edges, table and inbox) plus K2's partials; the tile copies are extra
// traffic: a cell whose 512 sources spread over the table copies nearly
// every tile of it.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_wl_tiled_kernel(const float* __restrict__ gval,
                    const int32_t* __restrict__ src,
                    const float* __restrict__ w,
                    const uint8_t* __restrict__ mask,
                    const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ wl_i,
                    const int32_t* __restrict__ wl_j,
                    const int32_t* __restrict__ nlive,
                    const int32_t* __restrict__ run_ptr, CellSchedule cs,
                    TileTables tt, int num_edges, int num_slots, int vblk,
                    int n_runs, float* __restrict__ partials,
                    int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  extern __shared__ __align__(16) float tile_s[];   // [2][vblk]
  const BlockCells cells = block_cells(run_ptr, n_runs, nlive);
  for (int c = cells.c0; c < cells.c1; c += cells.step) {
    const int j = wl_j[c];
    const int seg0 = wl_i[c] * SBLK;
    const int32_t* pos = tt.positions(j);
    clear_acc<KIND>(acc);
    __syncthreads();
    const int copies = walk_tiles(
        tt, cs, c, j,
        [&](int slot, int tile) {
          copy_tile(tile_s + slot * vblk, gval, tile, vblk, num_slots);
        },
        [&](int slot, int tile, int k) {
          const int b0 = tt.begin(j, k);
          fold_list<KIND>(acc, msg_s,
                          TileMsg<RELAX>{tile_s + slot * vblk, tile * vblk,
                                         src, w, mask},
                          ids, TileEdges{pos + b0, j * EBLK},
                          tt.begin(j, k + 1) - b0, num_edges, seg0);
        });
    if (dbg != nullptr && threadIdx.x == 0) {
      atomicAdd(dbg, 1);
      atomicAdd(dbg + 1, copies);
    }
    float* row = partials + static_cast<size_t>(c) * SBLK;
    for (int t = threadIdx.x; t < SBLK; t += THREADS)
      row[t] = fold_warps<KIND>(acc, t);
    __syncthreads();                      // acc is cleared for the next cell
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  A host plan passes run_ptr
// ((n_runs + 1,)) and its (l_pad,) / (l_pad, cell_tmax) cell tables and
// grid >= n_runs; a device plan passes null for all five and a grid of
// blocks that stride over *nlive.  `partials` is (l_pad, SBLK); `dbg`
// ((2,) int32) may be null.
extern "C" int frr_wl_tiled_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const int32_t* wl_i,
    const int32_t* wl_j, const int32_t* nlive, const int32_t* run_ptr,
    const int32_t* cell_ntiles, const int32_t* cell_tile,
    const int32_t* cell_slot, const int32_t* cell_fetch,
    const int32_t* ntiles, const int32_t* tiles, const int32_t* off,
    const int32_t* order, int num_edges, int num_slots, int vblk, int t_max,
    int cell_tmax, int grid, int n_runs, float* partials, int32_t* dbg,
    int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || vblk < 128 || vblk % 128 || t_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileTables tt{ntiles, tiles, off, order, t_max};
  const CellSchedule cs{cell_ntiles, cell_tile, cell_slot, cell_fetch,
                        cell_tmax};
  const size_t smem = 2 * static_cast<size_t>(vblk) * sizeof(float);
#define FRR_WLT_ARGS gval, src, w, mask, ids, wl_i, wl_j, nlive, run_ptr, \
                     cs, tt, num_edges, num_slots, vblk, n_runs, partials, \
                     dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_wl_tiled_kernel<ADD_W, KIND_MIN>, grid,
                            THREADS, smem, s, FRR_WLT_ARGS);
  if (relax == ADD_ONE && kind == KIND_MIN)
    return launch_with_smem(frr_wl_tiled_kernel<ADD_ONE, KIND_MIN>, grid,
                            THREADS, smem, s, FRR_WLT_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_wl_tiled_kernel<MUL_W, KIND_SUM>, grid,
                            THREADS, smem, s, FRR_WLT_ARGS);
#undef FRR_WLT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
