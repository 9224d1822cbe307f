// Shared pieces of the fused relax + reduce kernels (K1, K2) and the
// segment reduce (K9): the launch constants, the relax and combine of each
// pairing, the warp fold of one edge chunk's messages into per-warp
// shared-memory accumulators, and the piece launch that K1-K8 share.
//
// The fold.  A thread block of NWARP warps takes one EBLK-edge chunk;
// warp k takes the chunk's 32-edge batches k, k + NWARP, ...  Inside a
// batch, lanes that hit the same segment of the block are grouped with
// __match_any_sync; the lowest lane of a group folds the group in lane
// order and updates its warp's (SBLK,) accumulator.  `fold_warps` then
// folds the NWARP accumulators of one segment in warp order.  No atomics
// touch a value, so a sum is the same from run to run and a min is exact
// in any order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace frr {

constexpr int EBLK = 512;   // edges per chunk (must match the Python side)
constexpr int SBLK = 256;   // segments per block (must match the Python side)
constexpr int NWARP = 8;
constexpr int THREADS = NWARP * 32;
constexpr int BATCHES = EBLK / 32;

enum Relax { ADD_W = 0, ADD_ONE = 1, MUL_W = 2 };
enum Kind { KIND_MIN = 0, KIND_SUM = 1 };

template <int KIND>
__device__ __forceinline__ float identity() {
  return KIND == KIND_MIN ? INFINITY : 0.0f;
}

template <int KIND>
__device__ __forceinline__ float combine(float a, float b) {
  return KIND == KIND_MIN ? fminf(a, b) : __fadd_rn(a, b);
}

template <int RELAX>
__device__ __forceinline__ float relax(float v, const float* __restrict__ w,
                                       int e) {
  if (RELAX == ADD_W) return __fadd_rn(v, __ldg(w + e));
  if (RELAX == ADD_ONE) return __fadd_rn(v, 1.0f);
  return __fmul_rn(v, __ldg(w + e));
}

// Set every per-warp accumulator to the identity (all threads call it).
template <int KIND>
__device__ __forceinline__ void clear_acc(float (*acc)[SBLK]) {
  for (int t = threadIdx.x; t < NWARP * SBLK; t += THREADS)
    (&acc[0][0])[t] = identity<KIND>();
}

// Per-edge messages for the warp fold.  `valid(e)` says whether edge e
// may contribute (it is read before the edge's destination); `value(e)`
// is its message, read only for edges that land in the block.
template <int RELAX>
struct RelaxMsg {                 // K1, K2: relax(gval[src[e]], w[e]) where mask[e]
  const float* gval;              // the frontier-masked value table
  const int32_t* src;
  const float* w;
  const uint8_t* mask;
  __device__ __forceinline__ bool valid(int e) const {
    return __ldg(mask + e) != 0;
  }
  __device__ __forceinline__ float value(int e) const {
    return relax<RELAX>(__ldg(gval + __ldg(src + e)), w, e);
  }
};

// Fold the messages of the 32-edge batches [b_lo, b_hi) of the `n` edges
// edges(0), ..., edges(n - 1) to segments [seg0, seg0 + SBLK) into the
// calling warp's accumulator acc[warp]: batch b goes to warp b % NWARP,
// whatever the range, so a fold over a sub-range that holds every edge of
// the block changes no bit.  Padding edges (e >= num_edges, or
// !msg.valid(e)) never have their message read.
template <int KIND, class Msg, class Edges>
__device__ __forceinline__ void fold_range(
    float (*acc)[SBLK], float (*msg_s)[32], const Msg& msg,
    const int32_t* __restrict__ ids, const Edges& edges, int b_lo, int b_hi,
    int n, int num_edges, int seg0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b = b_lo + ((warp - b_lo) & (NWARP - 1)); b < b_hi;
       b += NWARP) {
    const int k = b * 32 + lane;
    const int e = k < n ? edges(k) : num_edges;
    int key = SBLK;                       // SBLK: no contribution
    float m = identity<KIND>();
    if (e < num_edges && msg.valid(e)) {
      const int local = ids[e] - seg0;
      if (local >= 0 && local < SBLK) {
        m = msg.value(e);
        key = local;
      }
    }
    msg_s[warp][lane] = m;
    __syncwarp();
    const unsigned grp = __match_any_sync(0xffffffffu, key);
    if (key < SBLK && lane == __ffs(grp) - 1) {
      float r = m;
      unsigned rest = grp & (grp - 1);    // the other lanes, ascending
      while (rest) {
        r = combine<KIND>(r, msg_s[warp][__ffs(rest) - 1]);
        rest &= rest - 1;
      }
      acc[warp][key] = combine<KIND>(acc[warp][key], r);
    }
    __syncwarp();
  }
}

// fold_range over every batch: warp k takes batches k, k + NWARP, ...
template <int KIND, class Msg, class Edges>
__device__ __forceinline__ void fold_list(
    float (*acc)[SBLK], float (*msg_s)[32], const Msg& msg,
    const int32_t* __restrict__ ids, const Edges& edges, int n,
    int num_edges, int seg0) {
  fold_range<KIND>(acc, msg_s, msg, ids, edges, 0, (n + 31) / 32, n,
                   num_edges, seg0);
}

struct ChunkEdges {               // the EBLK edges of one chunk, in order
  int e0;
  __device__ __forceinline__ int operator()(int k) const { return e0 + k; }
};

// Fold edge chunk `j`'s messages to segments [seg0, seg0 + SBLK).
template <int KIND, class Msg>
__device__ __forceinline__ void fold_edges(
    float (*acc)[SBLK], float (*msg_s)[32], const Msg& msg,
    const int32_t* __restrict__ ids, int j, int num_edges, int seg0) {
  fold_list<KIND>(acc, msg_s, msg, ids, ChunkEdges{j * EBLK}, EBLK,
                  num_edges, seg0);
}

// Segment t of the block: the NWARP accumulators folded in warp order.
template <int KIND>
__device__ __forceinline__ float fold_warps(float (*acc)[SBLK], int t) {
  float r = acc[0][t];
  for (int k = 1; k < NWARP; ++k) r = combine<KIND>(r, acc[k][t]);
  return r;
}

// ---------------------------------------------------------------------
// The piece launches (K1-K8): thread blocks over pieces
// ---------------------------------------------------------------------
//
// The Python side (piece_tables) cuts each segment block's planned cells
// (blk_chunk, i-major: chunks ascending) into pieces of at most
// PIECE_CELLS consecutive cells, on a plan's first launch, with no host
// sync: the piece count is a bound known on the host, and a piece past
// the real ones (piece_blk -1) is never run.  A thread block takes a
// piece, walks its cells in order, runs those the round lists (a
// worklist's flag bytes, or for a dense launch and a device plan the
// cells whose chunk frontier bit is set) and carries one accumulator
// across them.  A block that is one piece writes the inbox itself.  The
// pieces of a split block each write their partial to a row of the split
// buffer (rows consecutive, in piece order), then take a ticket; the
// piece that arrives last folds the rows in piece order into the inbox
// and resets the ticket for the next launch.  No float atomics, so a sum
// repeats bit for bit, and no thread block waits on another.

struct Pieces {
  const int32_t* piece_lo;    // (n_pieces,) a piece's first cell position
  const int32_t* piece_hi;    // (n_pieces,) one past its last
  const int32_t* piece_blk;   // (n_pieces,) its segment block, -1: none
  const int32_t* piece_slot;  // (n_pieces,) split-buffer row, -1: whole block
  const int32_t* blk_piece;   // (n_blocks + 1,) a block's pieces
  const int32_t* blk_chunk;   // (n_cells,) a cell's chunk
  const uint8_t* cell_batch;  // (n_cells, 2) [first, last + 1) batches
  const uint8_t* flags;       // (n_cells,) listed cells; null: chunk bits
  const uint8_t* chunk_act;   // (n_chunks,) chunk frontier bits
  int32_t* tickets;           // arrivals per (block, lane group), zero

  // Whether the round runs cell p: a host plan's flag, or (no flags: a
  // dense launch, a device plan) its chunk's frontier bit.  Block-uniform.
  __device__ __forceinline__ bool live(int p) const {
    return flags != nullptr ? flags[p] != 0 : chunk_act[blk_chunk[p]] != 0;
  }
  __device__ __forceinline__ int batch_lo(int p) const {
    return cell_batch[2 * p];
  }
  __device__ __forceinline__ int batch_hi(int p) const {
    return cell_batch[2 * p + 1];
  }
};

// The C entry points take a Pieces as ten pointers, in field order.
#define FRR_PIECE_PARAMS                                                  \
  const int32_t *piece_lo, const int32_t *piece_hi,                       \
      const int32_t *piece_blk, const int32_t *piece_slot,                \
      const int32_t *blk_piece, const int32_t *blk_chunk,                 \
      const uint8_t *cell_batch, const uint8_t *flags,                    \
      const uint8_t *chunk_act, int32_t *tickets
#define FRR_PIECES                                                        \
  Pieces{piece_lo, piece_hi, piece_blk, piece_slot, blk_piece, blk_chunk,  \
         cell_batch, flags, chunk_act, tickets}

// Called by every thread of a piece of a split block once it has written
// its partial: true in the piece that arrives last of the block's `n`
// (block-uniform), which then reads the other pieces' rows.
__device__ __forceinline__ bool arrive_last(int32_t* ticket, int n) {
  __shared__ int last;
  __threadfence();                        // this piece's row is visible
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == n - 1;
    if (last) *ticket = 0;                // every piece has arrived
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Finish piece k of segment block i (K2, K6): the block's inbox when it
// is one piece, else the piece's row of `split` and, in the last piece to
// arrive, the rows folded in piece order.  `acc` must be whole (the
// caller syncs).
template <int KIND>
__device__ __forceinline__ void finish_piece(
    float (*acc)[SBLK], const Pieces& pc, int k, int i, int num_segments,
    float* __restrict__ out, float* __restrict__ split) {
  const int seg0 = i * SBLK;
  const int slot = pc.piece_slot[k];
  if (slot < 0) {
    for (int t = threadIdx.x; t < SBLK; t += THREADS)
      if (seg0 + t < num_segments) out[seg0 + t] = fold_warps<KIND>(acc, t);
    return;
  }
  for (int t = threadIdx.x; t < SBLK; t += THREADS)
    split[static_cast<size_t>(slot) * SBLK + t] = fold_warps<KIND>(acc, t);
  const int k0 = pc.blk_piece[i];
  const int n = pc.blk_piece[i + 1] - k0;
  if (!arrive_last(pc.tickets + i, n)) return;
  const float* rows = split + static_cast<size_t>(pc.piece_slot[k0]) * SBLK;
  for (int t = threadIdx.x; t < SBLK; t += THREADS) {
    float r = __ldcg(rows + t);
    for (int s = 1; s < n; ++s)
      r = combine<KIND>(r, __ldcg(rows + static_cast<size_t>(s) * SBLK + t));
    if (seg0 + t < num_segments) out[seg0 + t] = r;
  }
}

// Run body(k, i) for this thread block's piece k = blockIdx.x, of
// segment block i, unless k is past the real pieces.
template <class Body>
__device__ __forceinline__ void run_piece(const Pieces& pc, Body&& body) {
  const int k = blockIdx.x;
  const int i = pc.piece_blk[k];
  if (i >= 0) body(k, i);
}

// Launch a piece kernel, one thread block per piece and lane group, with
// `smem` bytes of dynamic shared memory, first raising the kernel's
// dynamic limit to it (static and dynamic shared memory together may pass
// the default 48 KB only with that opt-in).  Returns the launch's
// cudaError_t.
template <class... KArgs, class... Args>
inline int launch_pieces(void (*kernel)(KArgs...), int num_pieces,
                         int groups, size_t smem, cudaStream_t stream,
                         Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(num_pieces, groups), THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `kernel` resident on one SM with `smem` bytes of dynamic
// shared memory (after the opt-in), or -cudaError_t.
template <class... KArgs>
inline int blocks_per_sm(void (*kernel)(KArgs...), size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  return e == cudaSuccess ? per_sm : -static_cast<int>(e);
}

}  // namespace frr
