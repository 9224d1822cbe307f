// Tiled worklist launch of the fused frontier relax + segment reduce for
// Hopper (sm_90a): kernel K6.
//
// Replaces the TPU kernel `_kernel_wl_tiled` (with its loop
// `_wl_tile_loop`) launched by `_fused_tiled_wl` in
// src/repro/kernels/fused_relax_reduce.py.  K6 is the tiled twin of K2
// (fused_relax_reduce_wl.cu): a worklist lists live (segment block, edge
// chunk) cells, j-major, and each cell writes an (SBLK,) partial that
// K2's fold (frr_wl_fold) combines into the inbox in cell-list order.
//
// The copy unit.  The TPU kernel copies the vblk-wide slot tiles that a
// cell's active sources fall in, on a 2-slot schedule that reuses a tile
// from one cell to the next, because its grid runs in order on one core
// that cannot gather from device memory.  At RMAT-18 a chunk's sources
// spread over the whole table, so a cell copied nearly every tile to
// read about a hundred values.  Here a cell copies what it reads: K5's
// cell (frr_tiles.cuh).  It stages with cp.async the masked value
// gval[src[e]] of each chunk position whose edge is active (act[e]) and
// lands in its block into an (EBLK,) slot by chunk position, the
// identity elsewhere, and folds with K2's own fold (K1's fold_list over
// the chunk's edges) reading the slot where K2 reads the table.  So K6's
// partials, and after K2's fold its inbox, are K2's bit for bit, sum
// included.  A cell that stages no row skips the fold and writes the
// identity, which K2's fold of its identity messages gives too; this
// happens only on device plans, whose cells are not dst-filtered.
//
// Launch shape: K2's grid over the cells, with blocks taking groups of
// `cpb` consecutive cells (frr_tiles.cuh block_cell).  A host plan
// launches one block per group; a device plan, whose count lives only in
// device memory, a fixed grid of a few blocks per SM striding over the
// groups below *nlive.  A block walks its cells with K5's pipeline: two
// (EBLK,) slots, and while cell c is folded, cell c+1's copies are in
// flight (one commit group a cell) and cell c+2's ids, sources and act
// flags are loaded into registers.  Each active edge is staged once, by
// the one cell that owns it, so a round stages the same rows as K5 under
// any plan.  `dbg` counts [executed cells, staged rows].
//
// Bound: K2's.  The staged bytes are the gathered bytes (4 per active
// edge); beyond K2 the kernel reads each position's act flag once and
// syncs the block twice a cell.  The partials (SBLK floats a cell) are
// written and read back once by the fold, as for K2.

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
                    const uint8_t* __restrict__ act,
                    const int32_t* __restrict__ wl_i,
                    const int32_t* __restrict__ wl_j,
                    const int32_t* __restrict__ nlive, int num_edges,
                    int cpb, float* __restrict__ partials,
                    int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  __shared__ __align__(16) float stage_s[2][EBLK];
  const int n = *nlive;
  auto load = [&](int c) {
    return load_cell(src, ids, act, c < n ? wl_j[c] : 0,
                     c < n ? num_edges : 0);
  };
  auto stage = [&](float* slot, int c, const CellRegs& x) {
    return c < n ? stage_rows<KIND>(slot, gval, x, wl_i[c] * SBLK) : 0;
  };
  clear_acc<KIND>(acc);
  // At each step the current cell's rows are in flight, the next cell is
  // staged from registers, and the cell after it is loaded into
  // registers, before the current cell is folded.
  int rows = 0, cells = 0, slot = 0;
  int c = block_cell(0, cpb, n);
  int cn = block_cell(1, cpb, n);
  CellRegs xn = load(cn);
  int m = stage(stage_s[0], c, load(c));
  cp_async_commit();
  bool any = __syncthreads_or(m);         // the cell stages a row
  for (int k = 2; c < n; ++k) {
    const int cq = block_cell(k, cpb, n);
    const CellRegs xq = load(cq);
    rows += m;
    m = stage(stage_s[slot ^ 1], cn, xn);
    xn = xq;
    cp_async_commit();
    cp_async_wait_group1();               // this cell's rows have landed
    const bool any_next = __syncthreads_or(m);
    if (any) {                            // else every message is identity
      const int j = wl_j[c];
      fold_list<KIND>(acc, msg_s,
                      StagedMsg<RELAX>{stage_s[slot], j * EBLK, w, mask},
                      ids, ChunkEdges{j * EBLK}, EBLK, num_edges,
                      wl_i[c] * SBLK);
    }
    __syncthreads();                      // acc is whole; the slot is read
    float* row = partials + static_cast<size_t>(c) * SBLK;
    for (int t = threadIdx.x; t < SBLK; t += THREADS) {
      row[t] = fold_warps<KIND>(acc, t);
#pragma unroll
      for (int u = 0; u < NWARP; ++u) acc[u][t] = identity<KIND>();
    }                                     // the next stage's barrier
    ++cells;                              // orders this before its fold
    any = any_next;
    slot ^= 1;
    c = cn;
    cn = cq;
  }

  if (dbg != nullptr) {
    rows = __reduce_add_sync(0xffffffffu, rows);
    if ((threadIdx.x & 31) == 0 && rows) atomicAdd(dbg + 1, rows);
    if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  `act` is the (E,) uint8
// active-edge flags (mask and a changed source); `nlive` a (1,) device
// count; `grid` >= 1 blocks take groups of `cpb` >= 1 consecutive cells
// (one group each for a host plan's exact grid, striding otherwise);
// `partials` is (l_pad, SBLK); `dbg` ((2,) int32) may be null.
extern "C" int frr_wl_tiled_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const uint8_t* act,
    const int32_t* wl_i, const int32_t* wl_j, const int32_t* nlive,
    int num_edges, int cpb, int grid, float* partials, int32_t* dbg,
    int relax, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid < 1 || cpb < 1) return static_cast<int>(cudaErrorInvalidValue);
#define FRR_WLT_ARGS gval, src, w, mask, ids, act, wl_i, wl_j, nlive, \
                     num_edges, cpb, partials, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_wl_tiled_kernel<ADD_W, KIND_MIN><<<grid, THREADS, 0, s>>>(
        FRR_WLT_ARGS);
  else if (relax == ADD_ONE && kind == KIND_MIN)
    frr_wl_tiled_kernel<ADD_ONE, KIND_MIN><<<grid, THREADS, 0, s>>>(
        FRR_WLT_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_wl_tiled_kernel<MUL_W, KIND_SUM><<<grid, THREADS, 0, s>>>(
        FRR_WLT_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_WLT_ARGS
  return static_cast<int>(cudaGetLastError());
}
