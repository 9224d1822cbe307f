// Lane-batched tiled piece launch of the fused frontier relax + segment
// reduce for Hopper (sm_90a): kernels K7 (dense) and K8 (worklist).
//
// Replaces the TPU kernels `_kernel_tiled_lanes` launched by
// `_fused_lanes_tiled` (K7) and `_kernel_wl_tiled_lanes` launched by
// `_fused_lanes_tiled_wl` (K8) in src/repro/kernels/fused_relax_reduce.py.
// K7 and K8 are the tiled twins of K3 and K4
// (fused_relax_reduce_wl_lanes.cu): their launch (a thread block per
// (piece, 32-lane group), the cells whose chunk bit is set (K7) or that
// the worklist lists (K8), a split block's pieces combined in piece order
// through the split buffer and an arrival ticket per (block, lane group))
// with a cell that stages rows.
//
// The copy unit.  The TPU kernels copy the (vblk, Q) slot tiles that a
// cell's sources active in some lane fall in (at RMAT-18 and Q = 16 a
// cell copied most of the table's 348 tiles).  Here a cell copies what
// it reads (frr_tiles.cuh).  It runs in two halves of EBLK / 2
// positions; a half is staged as K3 stages a chunk, with a position dead
// in every lane dropped, and the block copies its lane group's columns
// of each kept row (16-byte pieces when Q % 4 == 0, else 4-byte ones)
// into the half's part of a row buffer.  The fold is K3's fold_lane_runs
// over the half's positions, in K3's windows (a half is two of them),
// into the piece's (SBLK, LGRP) accumulator; a list's partial does not
// depend on the dropped positions, so each (segment, lane) combines the
// same partials in the same order as K3/K4, and K7's inbox is K3's and
// K8's is K4's bit for bit, sum included.  A half that keeps no row
// copies and folds nothing.
//
// A block walks the halves of its piece's run cells in a pipeline: while
// half h is folded, half h+1's rows are in flight (one commit group a
// half) and half h+2's edges are loaded into registers.  Shared memory:
// K3's 6 KB stage, the 2 KB row_src, the (SBLK, min(Q, 32)) accumulator
// and the run tables (lane_smem) and a row buffer of 2 * 256 * min(Q, 32)
// floats: 74 KB at Q = 16, three blocks an SM.  `dbg`
// counts [cells, staged rows] once per (cell, row), whatever the lane
// groups; the bytes are rows * Q * 4.
//
// Bound: K3's (each edge's source id and mask, each edge active in some
// lane's id and weight, the (V, Q) table, the inbox).  The staged bytes
// are the gathered bytes.

#include "frr_tiles.cuh"

namespace {

using namespace frr;

template <int RELAX, int KIND, int HALVES>
__global__ void __launch_bounds__(THREADS)
frr_wl_tiled_lanes_kernel(const float* __restrict__ gval,
                          const int32_t* __restrict__ src,
                          const float* __restrict__ w,
                          const int32_t* __restrict__ ids,
                          const uint8_t* __restrict__ act,
                          const uint8_t* __restrict__ unitw, const Pieces pc,
                          int num_edges, int num_segments, int num_slots,
                          int Q, float* __restrict__ out,
                          float* __restrict__ split,
                          int32_t* __restrict__ dbg) {
  __shared__ LaneStage st;                // half h in positions h * HALF..
  __shared__ int32_t row_src[EBLK];
  extern __shared__ __align__(16) float dyn[];
  const int t = threadIdx.x & 31;
  const int c0 = blockIdx.y * LGRP;
  const int lw = min(Q, LGRP);
  const int gw = min(LGRP, Q - c0);
  const LaneCols lc{c0, Q, unitw};
  float* acc = dyn;                                   // (SBLK, lw)
  const Runs runs = Runs::at(dyn + SBLK * lw, lw);
  float* row_s = dyn + lane_smem(Q) / sizeof(float);  // [2][HALF][lw]
  run_piece(pc, [&](int k, int i) {
    clear_lane_acc<KIND>(acc, lw);

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
    // The block walks halves (cell p, half h) in order.  At each step the
    // current half's rows are in flight, the next half is staged from
    // registers and its row copies committed, and the half after it is
    // loaded into registers, before the current half is folded.
    auto load = [&](int p, int h) {
      return p < p1 ? load_edge(src, w, act, ids,
                                pc.blk_chunk[p] * EBLK + h * HALF +
                                    threadIdx.x,
                                num_edges)
                    : EdgeRegs{0, 0, 0.0f, false};
    };
    auto advance = [&](int& p, int& h) {
      if (h == 0) {
        h = 1;
      } else {
        h = 0;
        p = next_live(p + 1);
      }
    };
    auto stage = [&](int p, int h, const EdgeRegs& x) {  // returns the rows
      const int n = p < p1 ? stage_position(st, row_src, x,
                                            h * HALF + threadIdx.x, num_slots,
                                            seg0)
                           : 0;
      const bool any = __syncthreads_or(n);
      if (any)
        copy_rows(row_s + h * HALF * lw, st, row_src, gval, h * HALF, Q, c0,
                  gw, lw);
      cp_async_commit();
      return any ? n : -1;
    };

    int rows = 0, cells = 0;
    int cp = next_live(pc.piece_lo[k]), ch = 0;       // the current half
    int np = cp, nh = ch;                              // the next half
    advance(np, nh);
    EdgeRegs x = load(cp, ch);
    const EdgeRegs x1 = load(np, nh);
    int n_cur = stage(cp, ch, x);           // the clear is ordered here too
    x = x1;
    while (cp < p1) {
      int qp = np, qh = nh;                 // the half after the next
      advance(qp, qh);
      const EdgeRegs xq = load(qp, qh);
      const int n_next = stage(np, nh, x);
      x = xq;
      cp_async_wait_prev();                 // the current half has landed
      if (n_cur >= 0) {
        rows += n_cur;
        fold_lane_runs<RELAX, KIND, HALVES>(
            acc, runs, st, ch * HALF, ch * HALF + HALF,
            StagedRows{row_s + ch * HALF * lw, ch * HALF, lw}, lc);
      }
      cells += ch == 0;
      __syncthreads();                      // the half is read before reuse
      cp = np;
      ch = nh;
      np = qp;
      nh = qh;
      n_cur = n_next;
    }

    cells += empty;
    if (dbg != nullptr && blockIdx.y == 0) {
      rows = __reduce_add_sync(0xffffffffu, rows);
      if (t == 0 && rows) atomicAdd(dbg + 1, rows);
      if (threadIdx.x == 0 && cells) atomicAdd(dbg, cells);
    }
    finish_lane_piece<KIND>(acc, lw, pc, k, i, num_segments, Q, out,
                            split);
  });
}

template <int RELAX, int KIND>
int launch(int halves, int num_pieces, int Q, cudaStream_t s,
           const float* gval, const int32_t* src,
           const float* w, const int32_t* ids, const uint8_t* act,
           const uint8_t* unitw, const Pieces& pc, int num_edges,
           int num_segments, int num_slots, float* out, float* split,
           int32_t* dbg) {
  const int groups = (Q + LGRP - 1) / LGRP;
  const size_t smem = lane_smem(Q) + lane_row_smem(Q);
  if (halves == 2)
    return launch_pieces(frr_wl_tiled_lanes_kernel<RELAX, KIND, 2>,
                         num_pieces, groups, smem, s, gval, src, w, ids, act,
                         unitw, pc, num_edges, num_segments, num_slots, Q,
                         out, split, dbg);
  return launch_pieces(frr_wl_tiled_lanes_kernel<RELAX, KIND, 1>,
                       num_pieces, groups, smem, s, gval, src, w, ids, act,
                       unitw, pc, num_edges, num_segments, num_slots, Q, out,
                       split, dbg);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  relax: 0 add_w,
// 2 mul_w; kind: 0 min, 1 sum; the (relax, kind) pairing must be
// absorbing, which the caller checks.  `act` is the (E,) uint8 flags of
// valid edges active in some lane (they stand in for the mask), `unitw`
// (Q,) uint8; the Pieces come as ten pointers (FRR_PIECE_PARAMS; `flags`
// null for a dense launch or a device plan, `tickets` one per (block,
// lane group)); `split` has SBLK * Q floats per piece of a split block;
// `dbg` ((2,) int32) may be null.  The table must be 16-byte aligned.
// `halves` as for frr_wl_lanes_launch.
extern "C" int frr_wl_tiled_lanes_launch(
    const float* gval, const int32_t* src, const float* w,
    const int32_t* ids, const uint8_t* act, const uint8_t* unitw,
    FRR_PIECE_PARAMS, int num_edges, int num_segments, int num_pieces,
    int num_slots, int Q, float* out, float* split, int32_t* dbg,
    int relax, int kind, int halves, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_pieces < 1 || Q < 1 || (halves != 1 && halves != 2) ||
      (halves == 2 && Q > 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc = FRR_PIECES;
#define FRR_WLTL_ARGS halves, num_pieces, Q, s, gval, src, w, ids, act, \
                      unitw, pc, num_edges, num_segments, num_slots, out,   \
                      split, dbg
  if (relax == ADD_W && kind == KIND_MIN)
    return launch<ADD_W, KIND_MIN>(FRR_WLTL_ARGS);
  if (relax == MUL_W && kind == KIND_SUM)
    return launch<MUL_W, KIND_SUM>(FRR_WLTL_ARGS);
#undef FRR_WLTL_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the (add_w, min) kernel resident on one SM at Q lanes, or
// -cudaError_t.
extern "C" int frr_wl_tiled_lanes_blocks_per_sm(int Q, int halves) {
  const size_t smem = lane_smem(Q) + lane_row_smem(Q);
  return halves == 2
             ? blocks_per_sm(frr_wl_tiled_lanes_kernel<ADD_W, KIND_MIN, 2>,
                             smem)
             : blocks_per_sm(frr_wl_tiled_lanes_kernel<ADD_W, KIND_MIN, 1>,
                             smem);
}
