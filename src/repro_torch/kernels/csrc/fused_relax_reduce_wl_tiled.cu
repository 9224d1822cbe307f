// Tiled piece launch of the fused frontier relax + segment reduce for
// Hopper (sm_90a): kernels K5 (dense) and K6 (worklist).
//
// Replaces the TPU kernels `_kernel_tiled` (with its loop `_tile_loop`)
// launched by `_fused_tiled` (K5) and `_kernel_wl_tiled` (with its loop
// `_wl_tile_loop`) launched by `_fused_tiled_wl` (K6) in
// src/repro/kernels/fused_relax_reduce.py.  K5 and K6 are the tiled
// twins of K1 and K2 (fused_relax_reduce_wl.cu): K1's and K2's launch (a
// thread block per piece of a segment block's planned cells, the cells
// whose chunk bit is set (K5) or that the worklist lists (K6), the
// pieces of a split block combined in piece order through the split
// buffer and an arrival ticket) with a cell that stages rows.
//
// The copy unit.  The TPU kernels copy the vblk-wide slot tiles that a
// cell's active sources fall in, because a TPU core cannot gather from
// device memory and its VMEM copies move contiguous blocks; the worklist
// kernel reuses a tile from one cell to the next on a 2-slot schedule.
// At RMAT-18 a chunk's sources spread over the whole table, so a cell
// copied nearly every tile to read about a hundred values.  Here a cell
// copies what it reads (frr_tiles.cuh): it stages with cp.async the
// masked value gval[src[e]] of each chunk position whose edge is active
// (act[e]) and lands in its block into an (EBLK,) slot by chunk
// position, the identity elsewhere, and folds with K1's fold_range over
// the cell's batch range, reading the slot where K1 reads the table.  So
// K5's inbox is K1's and K6's is K2's bit for bit, sum included.  A cell
// that stages no row skips the fold, whose messages would all be the
// identity.
//
// A block walks the run cells of its piece in a pipeline: two (EBLK,)
// slots, and while cell c is folded, cell c+1's copies are in flight (one
// commit group a cell) and cell c+2's ids, sources and act flags are
// loaded into registers.  Each active edge is staged once, by the one
// cell that owns it, so a round stages the same rows under any launch.
// `dbg` counts [cells run, staged rows].
//
// Bound: K1's.  The staged bytes are the gathered bytes (4 per active
// edge); beyond K1 the kernel reads each position's act flag once and
// syncs the block twice a cell.

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
                    const uint8_t* __restrict__ act, const Pieces pc,
                    int num_edges, int num_segments,
                    float* __restrict__ out, float* __restrict__ split,
                    int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  __shared__ __align__(16) float stage_s[2][EBLK];
  run_piece(pc, [&](int k, int i) {
    clear_acc<KIND>(acc);

    const int seg0 = i * SBLK;
    const int p1 = pc.piece_hi[k];
    // The next run cell from p that holds an edge of the block; a run cell
    // with none (a chunk that straddles two shards' runs) stages no row and
    // folds nothing, so it is counted and passed over.  Each position is
    // scanned once.  Block-uniform.
    int empty = 0;
    auto next_live = [&](int p) {
      for (; p < p1; ++p) {
        if (!pc.live(p)) continue;
        if (pc.batch_hi(p) > 0) break;
        ++empty;
      }
      return p;
    };
    auto load = [&](int p) {
      return load_cell(src, ids, act, p < p1 ? pc.blk_chunk[p] : 0,
                       p < p1 ? num_edges : 0);
    };
    // At each step the current cell's rows are in flight, the next cell is
    // staged from registers, and the cell after it is loaded into
    // registers, before the current cell is folded.
    int rows = 0, cells = 0, slot = 0;
    int p = next_live(pc.piece_lo[k]);
    int pn = next_live(p + 1);
    CellRegs xn = load(pn);
    int n = p < p1 ? stage_rows<KIND>(stage_s[0], gval, load(p), seg0) : 0;
    cp_async_commit();
    bool any = __syncthreads_or(n);         // the cell stages a row
    while (p < p1) {
      const int j = pc.blk_chunk[p];
      const int pq = next_live(pn + 1);
      const CellRegs xq = load(pq);
      rows += n;
      n = pn < p1 ? stage_rows<KIND>(stage_s[slot ^ 1], gval, xn, seg0) : 0;
      xn = xq;
      cp_async_commit();
      cp_async_wait_group1();               // this cell's rows have landed
      const bool any_next = __syncthreads_or(n);
      if (any)                              // else every message is identity
        fold_range<KIND>(acc, msg_s,
                         StagedMsg<RELAX>{stage_s[slot], j * EBLK, w, mask},
                         ids, ChunkEdges{j * EBLK}, pc.batch_lo(p),
                         pc.batch_hi(p), EBLK, num_edges, seg0);
      __syncthreads();                      // the slot is read before reuse
      ++cells;
      any = any_next;
      slot ^= 1;
      p = pn;
      pn = pq;
    }

    cells += empty;
    if (dbg != nullptr) {
      rows = __reduce_add_sync(0xffffffffu, rows);
      if ((threadIdx.x & 31) == 0 && rows) atomicAdd(dbg + 1, rows);
      if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
    }
    finish_piece<KIND>(acc, pc, k, i, num_segments, out, split);
  });
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  `act` is the (E,) uint8
// active-edge flags (mask and a changed source); the Pieces come as ten
// pointers (FRR_PIECE_PARAMS; `flags` null for a dense launch or a
// device plan); `split` has a row of SBLK floats per piece of a split
// block; `dbg` ((2,) int32) may be null.
extern "C" int frr_wl_tiled_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const uint8_t* act,
    FRR_PIECE_PARAMS, int num_edges, int num_segments, int num_pieces,
    float* out, float* split, int32_t* dbg, int relax, int kind,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
#define FRR_WLT_ARGS gval, src, w, mask, ids, act, pc, num_edges, \
                     num_segments, out, split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_pieces(frr_wl_tiled_kernel<ADD_W, KIND_MIN>, num_pieces,
                         1, 0, s, FRR_WLT_ARGS);
  if (relax == ADD_ONE && kind == KIND_MIN)
    return launch_pieces(frr_wl_tiled_kernel<ADD_ONE, KIND_MIN>, num_pieces,
                         1, 0, s, FRR_WLT_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_pieces(frr_wl_tiled_kernel<MUL_W, KIND_SUM>, num_pieces,
                         1, 0, s, FRR_WLT_ARGS);
#undef FRR_WLT_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
