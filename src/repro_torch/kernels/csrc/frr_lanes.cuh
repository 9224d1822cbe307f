// Shared pieces of the lane-batched fused relax + reduce kernels (K3, K4,
// and the cell fold of K7, K8): one (segment block, edge chunk) cell
// folded into an (SBLK, lanes) accumulator of query lanes, and how a
// piece's accumulator reaches the inbox.
//
// The value table is (V, Q) row-major, one column per query; a launch's
// grid has a lane-group axis, and the block of lane group y serves lanes
// [LGRP*y, LGRP*y + LGRP).  K1's per-warp (SBLK,) accumulators do not
// scale with Q (8 warps x SBLK x Q floats is 128 KB at Q = 16), so here
// every accumulator cell has ONE owner thread instead:
//
//   warp k owns segments [32k, 32k + 32) of the block, and thread t of
//   every warp owns lane LGRP*y + t; acc[s][t] is touched only by thread
//   t of warp s / 32.  The accumulator is (SBLK, min(Q, LGRP)) in dynamic
//   shared memory, so Q <= 16 pays for the lanes it has.
//
// A cell first stages its batch range of edges in shared memory (local
// segment key, source, weight; masked and out-of-block edges get key
// -1).  A warp per segment range would then walk most of a cell's edges
// alone while the other seven wait: edges are sorted by destination, so
// a chunk covers a few dozen consecutive segments, one or two warps'
// worth, and all 512 edges of a hub chunk land in one warp's segments.
// So the fold
// (fold_lane_runs) works in windows of WINDOW chunk positions, each in
// two phases:
//
//   A (gather, every warp at once): the window is cut into LISTS
//   contiguous lists of LEN positions, a warp (or, in the half-warp form,
//   a half-warp) each.  It walks its list in order, GATHER_DEPTH row
//   gathers in flight, and folds each segment's messages of the list, in
//   position order, into one partial per (segment, lane): an entry of
//   the list's run table in shared memory.
//
//   B (combine, the owners): after a block barrier, the owner of (s, t)
//   combines the entries of segment s into acc[s][t], list after list.
//
// So each (segment, lane) folds, window after window and list after
// list, the partial of its messages in that list (which starts from the
// identity and takes them in position order).  A list's partial does not
// depend on where the segment's other edges, or messages equal to the
// identity, sit in the list, so a fold that drops dead positions (K7, K8)
// gives the same bits.  No atomics touch a value: a sum repeats bit for
// bit and min is exact.  With Q <= 16 the half-warp form runs two lists a
// warp, 16 threads each, so that no thread idles in phase A.
#pragma once

#include "frr_common.cuh"

namespace frr {

constexpr int LGRP = 32;                 // lanes per lane group (a warp)
constexpr int SEG_PER_WARP = SBLK / NWARP;
static_assert(SEG_PER_WARP == 32, "a warp owns 32 segments of a block");
constexpr int GATHER_DEPTH = 8;          // gathers in flight per list

struct LaneStage {                       // one chunk's edges, staged
  int32_t key[EBLK];                     // local segment in [0, SBLK) or -1
  int32_t src[EBLK];
  float w[EBLK];
};

// Set the (SBLK, lw) accumulator to the identity (all threads call it).
template <int KIND>
__device__ __forceinline__ void clear_lane_acc(float* acc, int lw) {
  for (int t = threadIdx.x; t < SBLK * lw; t += THREADS)
    acc[t] = identity<KIND>();
}

// One position's edge, loaded into registers a cell (K3, K4) or a half
// (K7, K8) ahead of its stage: its id, source, weight and flag (`flags`:
// the mask, or the K7/K8 active flags); all zero past the edges.
struct EdgeRegs {
  int id, s;
  float w;
  bool on;
};

__device__ __forceinline__ EdgeRegs load_edge(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const uint8_t* __restrict__ flags, const int32_t* __restrict__ ids,
    int e, int num_edges) {
  EdgeRegs x{0, 0, 0.0f, false};
  if (e < num_edges) {
    x.id = __ldg(ids + e);
    x.s = __ldg(src + e);
    x.w = __ldg(w + e);
    x.on = __ldg(flags + e) != 0;
  }
  return x;
}

// Stage position k of a cell for segments [seg0, seg0 + SBLK) from its
// registers: a masked or out-of-block edge gets key -1.
__device__ __forceinline__ void stage_edge(LaneStage& st, const EdgeRegs& x,
                                           int k, int seg0) {
  const int local = x.id - seg0;
  const bool keep = x.on && local >= 0 && local < SBLK;
  st.key[k] = keep ? local : -1;
  st.src[k] = keep ? x.s : 0;
  st.w[k] = keep ? x.w : 0.0f;
}

// The run tables of one window: list l's entries are rows [l * LEN,
// (l + 1) * LEN) of `part` (lw floats a row, lw = min(Q, LGRP)), their
// segments in `key`, their count in `n[l]`: run_smem(Q) bytes.
constexpr int WINDOW = 256;               // chunk positions a window
constexpr int MAX_LISTS = 2 * NWARP;

inline __host__ __device__ size_t run_smem(int Q) {
  return (static_cast<size_t>(WINDOW) * (Q < LGRP ? Q : LGRP) + WINDOW +
          MAX_LISTS) * 4;
}

// Dynamic shared memory of a laned kernel: the (SBLK, lw) accumulator,
// then the run tables (K7 and K8 put their row buffer after them).
inline __host__ __device__ size_t lane_smem(int Q) {
  return static_cast<size_t>(SBLK) * (Q < LGRP ? Q : LGRP) * 4 +
         run_smem(Q);
}

struct Runs {
  float* part;                    // (WINDOW, lw)
  int32_t* key;                   // (WINDOW,)
  int32_t* n;                     // (MAX_LISTS,)
  int lw;
  __device__ static Runs at(void* smem, int lw) {
    float* part = static_cast<float*>(smem);
    int32_t* key = reinterpret_cast<int32_t*>(part + WINDOW * lw);
    return Runs{part, key, key + WINDOW, lw};
  }
};

struct LaneCols {                 // the lane group's columns
  int c0;                         // its first lane
  int Q;
  const uint8_t* unitw;           // (Q,) 1: add_w relaxes with weight 1.0
};

// Fold the staged positions [k_lo, k_hi) of a cell into acc, in windows
// of WINDOW positions aligned to the chunk (so any range over the same
// staged keys gives the same bits): rows(s, c) is lane column c of the
// row staged as source s.  HALVES 1: a list a warp; 2: a list a
// half-warp (for Q <= 16).  All threads call it; it ends with a barrier.
template <int RELAX, int KIND, int HALVES, class Rows>
__device__ __forceinline__ void fold_lane_runs(
    float* acc, const Runs& runs, const LaneStage& st, int k_lo,
    int k_hi, const Rows& rows, const LaneCols& lc) {
  constexpr int LISTS = HALVES * NWARP;
  constexpr int LEN = WINDOW / LISTS;     // positions a list
  constexpr int WIDTH = 32 / HALVES;      // threads a list
  static_assert(LEN <= WIDTH && LISTS <= MAX_LISTS, "list shape");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / WIDTH;
  const int col = lane % WIDTH;           // phase A: this thread's column
  const int list = warp * HALVES + sub;
  const int row0 = list * LEN;
  const unsigned sub_mask = HALVES == 1 ? 0xffffffffu
                                        : 0xffffu << (16 * sub);
  const bool on = lc.c0 + col < lc.Q;
  const bool unit = on && lc.unitw[lc.c0 + col] != 0;
  const bool own = lc.c0 + lane < lc.Q;   // phase B: column `lane`
  const int s0 = warp * SEG_PER_WARP;
  for (int wb = k_lo - k_lo % WINDOW; wb < k_hi; wb += WINDOW) {
    // Phase A: position wb + row0 + col for the list's first LEN threads.
    const int k = wb + row0 + col;
    const int key = col < LEN && k >= k_lo && k < k_hi ? st.key[k] : -1;
    const unsigned grp =
        __match_any_sync(0xffffffffu, key >= 0 ? key + sub * SBLK : -1);
    const int lead = __ffs(grp) - 1;
    const unsigned leads =
        __ballot_sync(0xffffffffu, key >= 0 && lane == lead) & sub_mask;
    const int entry = __popc(leads & ((1u << lead) - 1));
    if (key >= 0 && lane == lead) runs.key[row0 + entry] = key;
    const int n_ent = __popc(leads);
    if (col == 0) runs.n[list] = n_ent;
    if (on)
      for (int e = 0; e < n_ent; ++e)
        runs.part[(row0 + e) * runs.lw + col] = identity<KIND>();
    unsigned hits = __ballot_sync(0xffffffffu, key >= 0) & sub_mask;
    while (__any_sync(0xffffffffu, hits != 0)) {
      int ks[GATHER_DEPTH], es[GATHER_DEPTH];
      float vs[GATHER_DEPTH];
#pragma unroll
      for (int u = 0; u < GATHER_DEPTH; ++u) {
        const int l = hits ? __ffs(hits) - 1 : lane;
        const int e = __shfl_sync(0xffffffffu, entry, l);
        ks[u] = -1;
        es[u] = e;
        vs[u] = identity<KIND>();
        if (hits) {
          hits &= hits - 1;
          ks[u] = wb + row0 + l % WIDTH;
          if (on) vs[u] = rows(st.src[ks[u]], col);
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER_DEPTH; ++u) {
        if (ks[u] >= 0 && on) {
          const int kk = ks[u];
          const float m = RELAX == MUL_W
                              ? __fmul_rn(vs[u], st.w[kk])
                              : __fadd_rn(vs[u], unit ? 1.0f : st.w[kk]);
          float& a = runs.part[(row0 + es[u]) * runs.lw + col];
          a = combine<KIND>(a, m);
        }
      }
    }
    __syncthreads();
    // Phase B: the owners take their segments' entries, list by list.
    for (int l = 0; l < LISTS; ++l) {
      const int n = runs.n[l];
      const int ks = lane < n ? runs.key[l * LEN + lane] : -1;
      unsigned mine =
          __ballot_sync(0xffffffffu, ks >= s0 && ks < s0 + SEG_PER_WARP);
      while (mine) {                      // warp-uniform
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        if (own) {
          float& a = acc[runs.key[l * LEN + j] * runs.lw + lane];
          a = combine<KIND>(a, runs.part[(l * LEN + j) * runs.lw + lane]);
        }
      }
    }
    __syncthreads();
  }
}

struct TableRows {                // the lane group's columns of the table
  const float* gval;              // (V, Q)
  int Q;
  int c0;
  __device__ __forceinline__ float operator()(int s, int c) const {
    return __ldg(gval + static_cast<size_t>(s) * Q + c0 + c);
  }
};

// Finish piece k of segment block i for lane group blockIdx.y (K3, K4,
// K7, K8), as finish_piece does for K1 and K2: the inbox columns when
// the block is one piece, else the piece's (SBLK, Q) row of `split` (its
// group's columns) and, in the last piece of the block to arrive for
// this group, the rows folded in piece order.  `acc` must be whole (the
// caller syncs).
template <int KIND>
__device__ __forceinline__ void finish_lane_piece(
    const float* acc, int lw, const Pieces& pc, int k, int i,
    int num_segments, int Q, float* __restrict__ out,
    float* __restrict__ split) {
  const int seg0 = i * SBLK;
  const int c0 = blockIdx.y * LGRP;
  const int slot = pc.piece_slot[k];
  const size_t row = static_cast<size_t>(SBLK) * Q;
  if (slot < 0) {
    for (int t = threadIdx.x; t < SBLK * lw; t += THREADS) {
      const int d = seg0 + t / lw;
      const int q = c0 + t % lw;
      if (d < num_segments && q < Q)
        out[static_cast<size_t>(d) * Q + q] = acc[t];
    }
    return;
  }
  for (int t = threadIdx.x; t < SBLK * lw; t += THREADS) {
    const int q = c0 + t % lw;
    if (q < Q)
      split[slot * row + static_cast<size_t>(t / lw) * Q + q] = acc[t];
  }
  const int k0 = pc.blk_piece[i];
  const int n = pc.blk_piece[i + 1] - k0;
  if (!arrive_last(pc.tickets + static_cast<size_t>(i) * gridDim.y +
                       blockIdx.y, n))
    return;
  const float* rows = split + pc.piece_slot[k0] * row;
  for (int t = threadIdx.x; t < SBLK * lw; t += THREADS) {
    const int d = seg0 + t / lw;
    const int q = c0 + t % lw;
    if (d >= num_segments || q >= Q) continue;
    const size_t at = static_cast<size_t>(t / lw) * Q + q;
    float r = __ldcg(rows + at);
    for (int s = 1; s < n; ++s)
      r = combine<KIND>(r, __ldcg(rows + s * row + at));
    out[static_cast<size_t>(d) * Q + q] = r;
  }
}

}  // namespace frr
