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
// over the frontier-masked value table, but never gathers from the table
// in device memory: each live cell copies the vblk-wide slot tiles that
// its chunk's active sources fall in into a 2-slot shared-memory buffer
// (frr_tiles.cuh), tile t+1's cp.async copy in flight while tile t's own
// edges are folded with K1's warp fold, reading tile_s[src - tile * vblk].
// Every active edge lies in exactly one listed tile, so the result is
// K1's: min bit for bit, sum up to the order of its terms (tile by tile
// rather than edge by edge; still no atomics, so it repeats bit for bit).
//
// Launch shape: K1's.  One block per SBLK-wide segment block walks the
// chunks whose destination range meets it and skips dead chunks, so the
// executed cells are K1's; `dbg` counts [cells, tile copies], each live
// cell copying its chunk's ntiles tiles, as the TPU kernel does.
//
// Bound.  What a round's data needs is K1's bound (the edges' ids,
// sources, weights and masks, the table, the inbox).  The tiles are
// extra traffic: a chunk of 512 edges with sources spread over the table
// touches nearly every tile, so a cell copies up to ntiles * vblk * 4
// bytes (about 1 MB at RMAT-18 with vblk 12,288) where K1 gathers 2 KB.
// Those copies are served from L2 while the table fits there (1 MB at
// RMAT-18).  The design exists for tables no fast memory holds and for
// sparse frontiers, whose chunks list few tiles.

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
                 const int32_t* __restrict__ blk_ptr,
                 const int32_t* __restrict__ blk_chunk,
                 const uint8_t* __restrict__ chunk_act, TileTables tt,
                 int num_edges, int num_segments, int num_slots, int vblk,
                 float* __restrict__ out, int32_t* __restrict__ dbg) {
  __shared__ float acc[NWARP][SBLK];
  __shared__ float msg_s[NWARP][32];
  extern __shared__ __align__(16) float tile_s[];   // [2][vblk]
  clear_acc<KIND>(acc);
  __syncthreads();

  const int seg0 = blockIdx.x * SBLK;
  const int p1 = blk_ptr[blockIdx.x + 1];
  for (int p = blk_ptr[blockIdx.x]; p < p1; ++p) {
    const int j = blk_chunk[p];
    if (!chunk_act[j]) continue;          // frontier skip, block-uniform
    const int32_t* pos = tt.positions(j);
    const int copies = walk_tiles(
        tt, CellSchedule{}, 0, j,
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
  }
  __syncthreads();

  for (int t = threadIdx.x; t < SBLK; t += THREADS) {
    const int d = seg0 + t;
    if (d < num_segments) out[d] = fold_warps<KIND>(acc, t);
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 1 add_one, 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must
// be absorbing, which the caller checks.  The tile tables are
// (n_chunks,), (n_chunks, t_max), (n_chunks, t_max + 1) and
// (n_chunks, EBLK) int32; `dbg` ((2,) int32) may be null.
extern "C" int frr_tiled_launch(
    const float* gval, const int32_t* src, const float* w,
    const uint8_t* mask, const int32_t* ids, const int32_t* blk_ptr,
    const int32_t* blk_chunk, const uint8_t* chunk_act,
    const int32_t* ntiles, const int32_t* tiles, const int32_t* off,
    const int32_t* order, int num_edges, int num_segments, int num_blocks,
    int num_slots, int vblk, int t_max, float* out, int32_t* dbg, int relax,
    int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_blocks < 1 || vblk < 128 || vblk % 128 || t_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileTables tt{ntiles, tiles, off, order, t_max};
  const size_t smem = 2 * static_cast<size_t>(vblk) * sizeof(float);
  dim3 grid(num_blocks), block(THREADS);
#define FRR_TILED_ARGS gval, src, w, mask, ids, blk_ptr, blk_chunk, \
                       chunk_act, tt, num_edges, num_segments, num_slots, \
                       vblk, out, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch_with_smem(frr_tiled_kernel<ADD_W, KIND_MIN>, grid, block,
                            smem, s, FRR_TILED_ARGS);
  if (relax == ADD_ONE && kind == KIND_MIN)
    return launch_with_smem(frr_tiled_kernel<ADD_ONE, KIND_MIN>, grid, block,
                            smem, s, FRR_TILED_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch_with_smem(frr_tiled_kernel<MUL_W, KIND_SUM>, grid, block,
                            smem, s, FRR_TILED_ARGS);
#undef FRR_TILED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
