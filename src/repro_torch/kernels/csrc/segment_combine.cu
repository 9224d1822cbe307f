// Blocked semiring segment reduce for Hopper (sm_90a): kernel K9.
//
// Replaces the TPU kernel `_kernel` launched by `segment_combine_pallas`
// in src/repro/kernels/rhizome_segment_reduce.py, the standalone reduce of
// the engine's pallas_mode='reduce' composition (plain relax ops, then
// this kernel).  For every segment d:
//
//   out[d] = (+) over edges e with ids[e] == d of data[e]
//
// where (+) is min or sum; empty segments hold the identity.  `data` is
// float32 or bfloat16; the kernel accumulates in float32 and writes the
// input type (one rounding per segment).
//
// Launch shape: the piece launch of K1-K8 (frr_common.cuh).  A thread
// block of NW = 4 warps takes a piece of at most PIECE_CELLS (24, K9's
// own cut in rhizome_segment_reduce.py) planned cells of one segment block
// (the chunks, ascending, whose valid-edge id range meets it) and runs
// every one: there is no frontier skip, the messages are already
// relaxed and masked.  A cell reads only its batch range, the 32-edge
// batches of its chunk that hold a valid edge of its block (an edge
// outside the range, masked, carries the identity and is not read).  The
// pieces of a split block combine in piece order through the split buffer
// and an arrival ticket (finish_piece), rounding once.  `dbg`, when
// given, counts the (block, chunk) cells walked, the pieces run and the
// edges the warps load.
//
// The cell.  A cell's range is cut into units of UNIT = 128 edges from
// its first batch; the piece's units, counted over its cells in order, go
// to warps u % NW, so a warp takes at most one unit of a cell.  Each warp
// reads 32 cells' chunks and ranges at once, a lane a cell, lists its own
// units with a ballot and issues the next unit's loads before it folds
// the current one.  A lane loads four consecutive ids and messages with
// one 16-byte load each (8 bytes of bfloat16; the wrapper checks the
// alignment), so a unit is four batches.  Ids are sorted within each
// shard's run, so a unit is almost always a few runs of equal ids: when
// its keys do not decrease (one warp vote), each lane folds its runs in
// order, a shuffle segmented scan over the lanes' last runs carries a
// run across lanes in log2(32) steps, and the lane that ends a run
// combines it into the warp's (SBLK,) accumulator.  Other units (unsorted
// input, the boundary between two shards' runs) take the lane-order fold
// of frr_common.cuh, one of the lanes' four edges at a time.  No atomics
// touch a value, so a sum repeats bit for bit and a min is exact;
// `ref.segment_combine_order` replays the order.
//
// The cut, the block and the fold were swept on the H100 (PERF.md): 4
// to 32 cells a piece, 8 and 4 warps a block, and a fold that loads
// each unit only once the previous one is folded.  Four warps, 24
// cells and the loads ahead won on the heaviest RMAT-18 reduce round and
// summed over its 13 rounds: eight warps clear and fold twice the
// accumulators for half the units a warp, and a warp's next loads hide
// behind its fold.
//
// Bound.  Bytes: every edge's message and id read once and the out vector
// written once (RMAT-18: 4.19 M edges x 8 B = 34 MB, about 10 us at
// 3.35 TB/s); one combine per edge.  A chunk meets 4.9 segment blocks on
// the RMAT-18 partition; the batch ranges keep its re-reads near one.

#include <limits.h>

#include "frr_common.cuh"

namespace {

using namespace frr;

constexpr int UNIT = 128;                 // edges a warp folds at once
constexpr int NW = 4;                     // warps a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive messages as float32: one 16-byte load (float32) or
// one 8-byte load (bfloat16); `p` is aligned to it.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

// An id's key in the block at seg0: its segment there, -1 below the
// block, SBLK above it (keys outside [0, SBLK) never contribute).
__device__ __forceinline__ int seg_key(int id, int seg0) {
  const int local = id - seg0;
  return local < 0 ? -1 : (local < SBLK ? local : SBLK);
}

template <int KIND>
__device__ __forceinline__ void take(float* a, float x) {
  *a = combine<KIND>(*a, x);
}

// Load this lane's four edges of the unit [e_unit, e_unit + UNIT) that
// lie before e_end: lane l holds edges e_unit + 4l .. + 3 (an id of
// INT_MAX and the identity past e_end).
template <typename T, int KIND>
__device__ __forceinline__ void load_unit(int (&id)[4], float (&m)[4],
                                          const T* __restrict__ data,
                                          const int32_t* __restrict__ ids,
                                          int e_unit, int e_end) {
  const int e = e_unit + 4 * (threadIdx.x & 31);
  if (e + 4 <= e_end) {
    const int4 d = __ldg(reinterpret_cast<const int4*>(ids + e));
    load4(data + e, m);
    id[0] = d.x;
    id[1] = d.y;
    id[2] = d.z;
    id[3] = d.w;
  } else {                                // the unit's tail, or the edges'
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool in = e + t < e_end;
      id[t] = in ? __ldg(ids + e + t) : INT_MAX;
      m[t] = in ? to_float(data[e + t]) : identity<KIND>();
    }
  }
}

// With `dbg`: add the edges this warp loads of the unit [e_unit, e_unit
// + UNIT) before e_end to dbg[2], each lane counting its own four.
__device__ __forceinline__ void count_loaded(int32_t* dbg, int e_unit,
                                             int e_end) {
  const int n = min(max(e_end - e_unit - 4 * static_cast<int>(
                                             threadIdx.x & 31), 0), 4);
  const int total = __reduce_add_sync(FULL, n);
  if ((threadIdx.x & 31) == 0) atomicAdd(dbg + 2, total);
}

// Fold a loaded unit into this warp's accumulator `acc` (SBLK floats);
// `stage` is the warp's 32 floats of scratch.
template <int KIND>
__device__ __forceinline__ void fold_loaded(float* acc, float* stage,
                                            const int (&id)[4],
                                            const float (&m)[4], int seg0) {
  const int lane = threadIdx.x & 31;
  int key[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) key[t] = seg_key(id[t], seg0);
  bool up = key[0] <= key[1] && key[1] <= key[2] && key[2] <= key[3];
  const int prev3 = __shfl_up_sync(FULL, key[3], 1);
  if (lane > 0) up = up && prev3 <= key[0];
  if (__all_sync(FULL, up)) {
    // the lane's runs in order: a run that starts and ends in the lane is
    // whole; the first (`head`) and the last (`r`) may span lanes
    float r = m[0], head = m[0];
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      if (key[t] == key[t - 1]) {
        r = combine<KIND>(r, m[t]);
      } else {
        if (key[t - 1] == key[0])
          head = r;
        else if (static_cast<unsigned>(key[t - 1]) < SBLK)
          take<KIND>(acc + key[t - 1], r);
        r = m[t];
      }
    }
    // segmented inclusive scan of the lanes' last runs: s folds the run
    // that ends this lane from the lane where it starts
    float s = r;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float su = __shfl_up_sync(FULL, s, d);
      const int ku = __shfl_up_sync(FULL, key[3], d);
      if (lane >= d && ku == key[3]) s = combine<KIND>(su, s);
    }
    const float s_prev = __shfl_up_sync(FULL, s, 1);
    const int next0 = __shfl_down_sync(FULL, key[0], 1);
    if (key[0] != key[3] && static_cast<unsigned>(key[0]) < SBLK)
      take<KIND>(acc + key[0], lane > 0 && prev3 == key[0]
                                   ? combine<KIND>(s_prev, head) : head);
    if ((lane == 31 || next0 != key[3])
        && static_cast<unsigned>(key[3]) < SBLK)
      take<KIND>(acc + key[3], s);
  } else {
    // the lane-order fold, one of the lanes' four edges at a time
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = static_cast<unsigned>(key[t]) < SBLK ? key[t] : SBLK;
      stage[lane] = m[t];
      __syncwarp();
      const unsigned grp = __match_any_sync(FULL, k);
      if (k < SBLK && lane == __ffs(grp) - 1) {
        float g = m[t];
        for (unsigned rest = grp & (grp - 1); rest; rest &= rest - 1)
          g = combine<KIND>(g, stage[__ffs(rest) - 1]);
        take<KIND>(acc + k, g);
      }
      __syncwarp();
    }
  }
  __syncwarp();                           // the next unit reads acc
}

// A cell holds at most BATCHES / 4 units, so a warp folds at most one
// unit of each cell.
static_assert(BATCHES / 4 <= NW, "a warp takes one unit of a cell");

// Fold every cell of positions [p0, p1) of the block at seg0, a warp's
// units in order with the next unit's loads issued before the current
// unit folds: lane c of each warp holds cell g + c, 32 cells at a time,
// and a ballot lists the cells that hold one of the warp's units.
template <typename T, int KIND>
__device__ __forceinline__ void fold_piece(
    float (*acc)[SBLK], float (*stage)[32], const Pieces& pc,
    const T* __restrict__ data, const int32_t* __restrict__ ids, int p0,
    int p1, int num_edges, int seg0, int32_t* dbg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int u0 = 0;                             // units of the earlier groups
  for (int g = p0; g < p1; g += 32) {
    int units = 0, e_unit = 0, e_end = 0;
    if (g + lane < p1) {
      const int e0 = pc.blk_chunk[g + lane] * EBLK;
      const int lo = pc.batch_lo(g + lane), hi = pc.batch_hi(g + lane);
      units = (hi - lo + 3) >> 2;
      e_unit = e0 + 32 * lo;
      e_end = min(e0 + 32 * hi, num_edges);
    }
    int incl = units;                     // units of cells g .. g + lane
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int r = (warp - (u0 + incl - units)) & (NW - 1);
    e_unit += r * UNIT;
    unsigned mine = __ballot_sync(FULL, r < units);
    u0 += __shfl_sync(FULL, incl, 31);
    if (mine == 0) continue;
    int id[4], id_next[4];
    float m[4], m_next[4];
    int c = __ffs(mine) - 1;
    int eu = __shfl_sync(FULL, e_unit, c), ee = __shfl_sync(FULL, e_end, c);
    load_unit<T, KIND>(id, m, data, ids, eu, ee);
    if (dbg != nullptr) count_loaded(dbg, eu, ee);
    while (true) {
      mine &= mine - 1;
      if (mine != 0) {
        c = __ffs(mine) - 1;
        eu = __shfl_sync(FULL, e_unit, c);
        ee = __shfl_sync(FULL, e_end, c);
        load_unit<T, KIND>(id_next, m_next, data, ids, eu, ee);
        if (dbg != nullptr) count_loaded(dbg, eu, ee);
      }
      fold_loaded<KIND>(acc[warp], stage[warp], id, m, seg0);
      if (mine == 0) break;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        id[t] = id_next[t];
        m[t] = m_next[t];
      }
    }
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(NW * 32)
segment_combine_kernel(const T* __restrict__ data,
                       const int32_t* __restrict__ ids, const Pieces pc,
                       int num_edges, int num_segments, T* __restrict__ out,
                       float* __restrict__ split,
                       int32_t* __restrict__ dbg) {
  __shared__ float acc[NW][SBLK];
  __shared__ float stage[NW][32];
  run_piece(pc, [&](int k, int i) {
    for (int t = threadIdx.x; t < NW * SBLK; t += NW * 32)
      (&acc[0][0])[t] = identity<KIND>();
    __syncthreads();
    const int p0 = pc.piece_lo[k], p1 = pc.piece_hi[k];
    fold_piece<T, KIND>(acc, stage, pc, data, ids, p0, p1, num_edges,
                        i * SBLK, dbg);
    if (dbg != nullptr && threadIdx.x == 0) {
      atomicAdd(dbg, p1 - p0);
      atomicAdd(dbg + 1, 1);
    }
    __syncthreads();
    finish_piece<KIND, NW>(acc, pc, k, i, num_segments, out, split);
  });
}

template <typename T>
int launch(const void* data, const int32_t* ids, const Pieces& pc,
           int num_edges, int num_segments, int num_pieces, void* out,
           float* split, int32_t* dbg, int kind, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  if (kind == KIND_MIN)
    segment_combine_kernel<T, KIND_MIN><<<num_pieces, NW * 32, 0, s>>>(
        d, ids, pc, num_edges, num_segments, o, split, dbg);
  else if (kind == KIND_SUM)
    segment_combine_kernel<T, KIND_SUM><<<num_pieces, NW * 32, 0, s>>>(
        d, ids, pc, num_edges, num_segments, o, split, dbg);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  kind: 0 min, 1 sum;
// dtype: 0 float32, 1 bfloat16 (data and out alike).  The Pieces come as
// ten pointers (FRR_PIECE_PARAMS; `flags` and `chunk_act` null: every
// cell runs); one block per piece; `split` has a row of SBLK floats per
// piece of a split block; `dbg` is null or (3,) zeros: [cells walked,
// pieces run, edges loaded].  `data` and `ids` must be
// aligned to their vector loads.
extern "C" int segment_combine_launch(const void* data, const int32_t* ids,
                                      FRR_PIECE_PARAMS, int num_edges,
                                      int num_segments, int num_pieces,
                                      void* out, float* split, int32_t* dbg,
                                      int kind, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
  if (dtype == 0)
    return launch<float>(data, ids, pc, num_edges, num_segments, num_pieces,
                         out, split, dbg, kind, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(data, ids, pc, num_edges, num_segments,
                                 num_pieces, out, split, dbg, kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
