// Tiled fused frontier relax + segment reduce for Hopper (sm_90a):
// kernel K5.
//
// Replaces the TPU kernel `_kernel_tiled` (with its loop `_tile_loop`)
// launched by `_fused_tiled` in src/repro/kernels/fused_relax_reduce.py.
// It computes what K1 (fused_relax_reduce.cu) computes,
//
//   out[d] = (+) over edges e with ids[e] == d and mask[e] of
//            relax(gval[src[e]], w[e])
//
// over the frontier-masked value table, for a table the residency budget
// keeps out of the pinned path.
//
// The copy unit.  A TPU core cannot gather from device memory, and its
// VMEM copies move contiguous (8, 128) blocks, so the TPU kernel copies
// the vblk-wide slot tiles that a chunk's active sources fall in and
// gathers from VMEM.  Hopper gathers at 32-byte-sector granularity and
// cp.async copies 4 bytes to any shared-memory address, so here the copy
// unit is what a cell reads: one source row.  A cell whose 512 sources
// spread over the table copies 2 KB, not every tile of it (about 1 MB at
// RMAT-18).
//
// Launch shape: K1's.  One block per SBLK-wide segment block walks the
// chunks whose destination range meets it and skips dead chunks, so the
// executed cells are K1's.  For each live cell the block copies, with
// cp.async, the masked value gval[src[e]] of every chunk position whose
// edge is active (act[e]: mask[e] and a changed source) and lands in the
// block into a shared-memory slot at the edge's chunk position; every
// other position gets the identity, written directly, which is what the
// masked table holds for an inactive source.  Two slots of EBLK floats
// double-buffer across the block's cells: while cell c is folded, cell
// c+1's copies are in flight (one commit group a cell) and cell c+2's
// ids, sources and act flags are loaded into registers (the cell's
// stage, shared with K6, is in frr_tiles.cuh).  The fold is
// K1's own (fold_list over ChunkEdges) with a message read from the slot
// where K1 reads the table, so K5's result is K1's bit for bit, sum
// included.  A cell that stages no row (no active edge lands in its
// block: a chunk that straddles two shards' sorted runs meets nearly
// every block) skips the fold, whose messages would all be the identity
// and change no accumulator.  `dbg` counts [cells, staged rows], a row
// once per (cell, staged position).
//
// Bound: K1's.  The staged bytes are the gathered bytes (4 per active
// edge), so the round's data needs what it needs for K1: the edges'
// ids, sources, weights and masks, the table, the inbox.  Beyond K1 the
// kernel reads each position's act flag, id and source once more, in a
// coalesced pass a cell ahead, and syncs the block twice a cell; it
// saves the fold of the cells that stage no row, which K1 walks.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND>
__global__ void __launch_bounds__(THREADS)
frr_tiled_kernel(const float* __restrict__ gval,
                 const int32_t* __restrict__ src,
                 const float* __restrict__ w,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ ids,
                 const uint8_t* __restrict__ act,
                 const int32_t* __restrict__ blk_ptr,
                 const int32_t* __restrict__ blk_chunk,
                 const uint8_t* __restrict__ chunk_act, int num_edges,
                 int num_segments, float* __restrict__ out,
                 int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  __shared__ __align__(16) float stage_s[2][EBLK];
  clear_acc<KIND>(acc);

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  auto next_live = [&](int p) {           // block-uniform
    while (p < p1 && !chunk_act[blk_chunk[p]]) ++p;
    return p;
  };
  auto load = [&](int p) {
    return load_cell(src, ids, act, p < p1 ? blk_chunk[p] : 0,
                     p < p1 ? num_edges : 0);
  };
  // At each step the current cell's rows are in flight, the next cell is
  // staged from registers, and the cell after it is loaded into
  // registers, before the current cell is folded.
  int rows = 0, cells = 0, slot = 0;
  int p = next_live(blk_ptr[blockIdx.x]);
  int pn = next_live(p + 1);
  CellRegs xn = load(pn);
  int n = p < p1 ? stage_rows<KIND>(stage_s[0], gval, load(p), seg0) : 0;
  cp_async_commit();
  bool any = __syncthreads_or(n);         // the cell stages a row
  while (p < p1) {
    const int j = blk_chunk[p];
    const int pq = next_live(pn + 1);
    const CellRegs xq = load(pq);
    rows += n;
    n = pn < p1 ? stage_rows<KIND>(stage_s[slot ^ 1], gval, xn, seg0) : 0;
    xn = xq;
    cp_async_commit();
    cp_async_wait_group1();               // this cell's rows have landed
    const bool any_next = __syncthreads_or(n);
    if (any)                              // else every message is identity
      fold_list<KIND>(acc, msg_s,
                      StagedMsg<RELAX>{stage_s[slot], j * EBLK, w, mask},
                      ids, ChunkEdges{j * EBLK}, EBLK, num_edges, seg0);
    __syncthreads();                      // the slot is read before reuse
    ++cells;
    any = any_next;
    slot ^= 1;
    p = pn;
    pn = pq;
  }

  if (dbg != nullptr) {
    rows = __reduce_add_sync(0xffffffffu, rows);
    if ((threadIdx.x & 31) == 0 && rows) atomicAdd(dbg + 1, rows);
    if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
  }
  for (int t = threadIdx.x; t < SBLK; t += THREADS) {
    const int d = seg0 + t;
    if (d < num_segments) out[d] = fold_warps<KIND>(acc, t);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  `act` is the (E,) uint8
// active-edge flags (mask and a changed source); `dbg` ((2,) int32) may
// be null.
extern "C" int frr_tiled_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const uint8_t* act,
    const int32_t* blk_ptr, const int32_t* blk_chunk,
    const uint8_t* chunk_act, int num_edges, int num_segments,
    int num_blocks, float* out, int32_t* dbg, int relax, int kind,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(num_blocks), block(THREADS);
#define FRR_TILED_ARGS gval, src, w, mask, ids, act, blk_ptr, blk_chunk, \
                       chunk_act, num_edges, num_segments, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    frr_tiled_kernel<ADD_W, KIND_MIN><<<grid, block, 0, s>>>(FRR_TILED_ARGS);
  else if (relax == ADD_ONE && kind == KIND_MIN)
    frr_tiled_kernel<ADD_ONE, KIND_MIN><<<grid, block, 0, s>>>(
        FRR_TILED_ARGS);
  else if (relax == MUL_W && kind == KIND_SUM)
    frr_tiled_kernel<MUL_W, KIND_SUM><<<grid, block, 0, s>>>(FRR_TILED_ARGS);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef FRR_TILED_ARGS
  return static_cast<int>(cudaGetLastError());
}
