"""RPVO + Rhizome partitioning (paper §3, §6.1 "Graph Construction").

Maps a COO graph onto S shards (compute cells in the AM-CCA cost model,
devices in the engine):

* **RPVO (out-degree)** — each vertex's out-edges are chunked into
  ``local_edge_list_size`` ghost chunks; chunks are placed by an allocator
  (home / vicinity / random / balanced).  With ``ghost_alloc="home"`` all
  chunks stay at the root's shard — the paper's Fig 2a "simple vertex"
  baseline, whose padded per-shard edge width inflates with out-degree skew.
* **Rhizome (in-degree)** — Eq. 1: ``cutoff_chunk = indegree_max /
  rpvo_max``; every ``cutoff_chunk`` in-edges of a vertex are pointed at
  the next replica (cycling), so a hub's inbox is spread over up to
  ``rpvo_max`` replica slots on distinct shards.  Replicas are allocated
  by the *random* allocator (paper §6.1, Fig 4c).

Placement is **counter-based**: every random draw (root home, replica
home, ghost-chunk home, vicinity offset) is a splitmix64 hash of
``(cfg.seed, entity id)`` rather than a sequential RNG stream.  A
vertex's placement therefore never depends on how many *other* vertices
or edges exist, which is what makes `splice_partition` exact: rebuilding
only the shards a mutation batch touched yields, field for field, the
same `Partition` as `build_partition` on the post-mutation graph.

The result is a set of static, padded arrays directly consumable by the
engine (`repro_torch.core.engine`).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch import obs
from repro_torch.graph.graph import COOGraph


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    num_shards: int
    local_edge_list_size: int = 32
    rpvo_max: int = 1                 # 1 => plain RPVO (no rhizomes)
    ghost_alloc: str = "balanced"     # 'home' | 'vicinity' | 'random' | 'balanced'
    mesh_dims: tuple[int, int] | None = None  # (X, Y); default near-square
    torus: bool = True
    seed: int = 0
    # Eq. 1 cutoff override.  None derives ``ceil(indeg_max / rpvo_max)``
    # from the graph at build time; streaming pins it to the initial
    # graph's value (the CCA exemplars' fixed RHIZOME_INDEGREE_CUTOFF)
    # so replica counts depend only on each vertex's own in-degree.
    indegree_cutoff: int | None = None

    def dims(self) -> tuple[int, int]:
        if self.mesh_dims is not None:
            assert self.mesh_dims[0] * self.mesh_dims[1] == self.num_shards
            return self.mesh_dims
        x = int(np.floor(np.sqrt(self.num_shards)))
        while self.num_shards % x:
            x -= 1
        return (self.num_shards // x, x)


@dataclasses.dataclass
class Partition:
    """Sharded RPVO/Rhizome layout. ``flat`` replica id = shard * R_max + slot."""

    cfg: PartitionConfig
    n: int
    num_edges: int
    S: int
    E_max: int                      # padded edges per shard
    R_max: int                      # padded replica slots per shard
    num_replicas_total: int

    # --- per-edge, per-shard arrays, all shaped (S, E_max) ---
    edge_src_root_flat: np.ndarray  # flat id of src vertex's ROOT replica
    edge_dst_flat: np.ndarray       # flat id of the dst REPLICA this edge feeds
    edge_w: np.ndarray              # float32 weights
    edge_mask: np.ndarray           # bool, False on padding
    edge_src_vertex: np.ndarray     # int32 global src vertex (cost model)
    edge_dst_vertex: np.ndarray     # int32 global dst vertex (cost model)
    edge_owner_cc: np.ndarray       # int32 CC owning the ghost chunk (== shard)

    # --- per-slot tables, shaped (S, R_max) ---
    slot_vertex: np.ndarray         # vertex id of replica at slot (-1 pad)
    slot_is_root: np.ndarray        # bool
    sibling_flat: np.ndarray        # (S, R_max, rpvo_max) flat ids of ALL
    sibling_mask: np.ndarray        # replicas of the slot's vertex (+mask)

    # --- per-vertex tables ---
    root_flat: np.ndarray           # (n,) flat id of root replica
    num_replicas: np.ndarray        # (n,)
    out_deg: np.ndarray             # (n,) int64
    in_deg: np.ndarray              # (n,) int64

    # --- compact targeted-exchange plan (§Perf; message-driven semantics:
    #     contributions travel only to the replica's owner shard) ---
    P_t: int                        # padded distinct-dst slots per (src,tgt)
    edge_dst_compact: np.ndarray    # (S, E_max) int32 -> [0, S*P_t)
    inbox_slot_map: np.ndarray      # (S_tgt, S_src, P_t) local slot or R_max
    R_rz_max: int                   # padded rhizome slots per shard
    rz_local: np.ndarray            # (S, R_rz_max) local slot ids (R_max pad)
    rz_sibling_idx: np.ndarray      # (S, R_rz_max, K) global rz-compact ids
    rz_sibling_mask: np.ndarray     # (S, R_rz_max, K)

    # --- metrics (recorded for roofline / paper figures) ---
    metrics: dict

    def replica_shards_of(self, v: int) -> list[int]:
        sib = self.sibling_flat[self.root_flat[v] // self.R_max,
                                self.root_flat[v] % self.R_max]
        msk = self.sibling_mask[self.root_flat[v] // self.R_max,
                                self.root_flat[v] % self.R_max]
        return sorted({int(f) // self.R_max for f, m in zip(sib, msk) if m})


@dataclasses.dataclass
class SpliceInfo:
    """What `splice_partition` actually did (obs gauges + tests)."""

    shards_rebuilt: int
    shards_total: int
    rebuilt_ids: list
    replicas_added: int
    replicas_removed: int
    replicas_moved: int
    affected_edges: int
    full_rebuild: bool
    r_max_changed: bool
    e_max_changed: bool


def _vicinity_order(cfg: PartitionConfig) -> np.ndarray:
    """CC offsets sorted by Manhattan distance from origin (torus-aware)."""
    X, Y = cfg.dims()
    xs, ys = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    dx, dy = xs.ravel(), ys.ravel()
    if cfg.torus:
        ddx = np.minimum(dx, X - dx)
        ddy = np.minimum(dy, Y - dy)
    else:
        ddx, ddy = dx, dy
    order = np.argsort(ddx + ddy, kind="stable")
    return (dy[order] * X + dx[order]).astype(np.int64)  # cc ids by distance


# ---------------------------------------------------------------------------
# counter-based placement hashing (splitmix64)
# ---------------------------------------------------------------------------

_TAG_ROOT, _TAG_REPLICA, _TAG_CHUNK, _TAG_VICINITY = 1, 2, 3, 4
_MASK64 = (1 << 64) - 1


def _mix64(x: np.ndarray) -> np.ndarray:
    z = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _hash_mod(seed: int, tag: int, key, sub, mod: int) -> np.ndarray:
    """Vectorized draw in [0, mod) as a pure function of (seed, tag, key, sub)."""
    base = np.uint64((seed * 0x9E3779B1 + tag * 0x85EBCA77) & _MASK64)
    a = _mix64(np.asarray(key, dtype=np.uint64) ^ base)
    h = _mix64(a ^ (np.asarray(sub, dtype=np.uint64) << np.uint64(1)))
    return (h % np.uint64(max(mod, 1))).astype(np.int64)


def _stable_argsort(keys: np.ndarray, bound: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for integer keys in
    ``[0, bound)``, the same permutation, by 16-bit passes least
    significant first (numpy sorts 8- and 16-bit keys stably by radix)."""
    keys = np.asarray(keys)
    if bound <= 1 << 8:
        return np.argsort(keys.astype(np.uint8), kind="stable")
    if bound <= 1 << 16:
        return np.argsort(keys.astype(np.uint16), kind="stable")
    if bound > 1 << 32:
        return np.argsort(keys, kind="stable")
    order = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    return order[np.argsort((keys[order] >> 16).astype(np.uint16),
                            kind="stable")]


# ---------------------------------------------------------------------------
# placement: global assignment arrays (pure, vectorized)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Placement:
    S: int
    n: int
    E: int
    cutoff_chunk: int
    in_deg: np.ndarray
    out_deg: np.ndarray
    root_shard: np.ndarray
    num_replicas: np.ndarray
    R_total: int
    first_rid: np.ndarray           # (n+1,)
    rep_vertex: np.ndarray          # (R_total,)
    rep_index: np.ndarray
    rep_shard: np.ndarray
    rep_slot: np.ndarray
    rep_flat: np.ndarray
    R_max: int
    root_flat: np.ndarray           # (n,)
    edge_dst_rid: np.ndarray        # (E,) global replica id each edge feeds
    edge_shard: np.ndarray          # (E,)
    e_counts: np.ndarray            # (S,)
    e_starts: np.ndarray            # (S+1,)
    shard_sort: np.ndarray          # (E,) stable argsort of edge_shard
    E_max: int


def _placement(g: COOGraph, cfg: PartitionConfig) -> _Placement:
    S = cfg.num_shards
    n, E = g.n, g.num_edges
    in_deg = g.in_degrees()
    out_deg = g.out_degrees()

    # ---- 1. root homes: random allocation across the chip (paper §6.1) ----
    vids = np.arange(n, dtype=np.int64)
    root_shard = _hash_mod(cfg.seed, _TAG_ROOT, vids, 0, S)

    # ---- 2. rhizome replicas (Eq. 1) ----
    if cfg.indegree_cutoff is not None:
        cutoff_chunk = max(int(cfg.indegree_cutoff), 1)
    else:
        indeg_max = max(int(in_deg.max()) if n else 1, 1)
        cutoff_chunk = max(int(np.ceil(indeg_max / cfg.rpvo_max)), 1)
    num_replicas = np.minimum(
        cfg.rpvo_max, np.maximum(1, np.ceil(in_deg / cutoff_chunk).astype(np.int64))
    )
    R_total = int(num_replicas.sum())
    first_rid = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(num_replicas, out=first_rid[1:])

    # replica r of vertex v -> shard: r=0 at root home; r>0 random (paper)
    rep_vertex = np.repeat(vids, num_replicas)
    rep_index = np.arange(R_total, dtype=np.int64) - first_rid[rep_vertex]
    rep_shard = np.where(
        rep_index == 0,
        root_shard[rep_vertex],
        _hash_mod(cfg.seed, _TAG_REPLICA, rep_vertex, rep_index, S),
    ).astype(np.int64)

    # slots: order replicas per shard
    order = _stable_argsort(rep_shard, S)
    rep_slot = np.zeros(R_total, dtype=np.int64)
    counts = np.bincount(rep_shard, minlength=S)
    starts = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rep_slot[order] = np.arange(R_total, dtype=np.int64) - starts[rep_shard[order]]
    R_max = max(int(counts.max()) if R_total else 1, 1)
    rep_flat = rep_shard * R_max + rep_slot
    root_flat = rep_flat[first_rid[:-1]] if n else np.zeros(0, np.int64)

    # ---- 3. in-edge -> replica assignment (cycling every cutoff_chunk) ----
    dst_order = _stable_argsort(g.dst, n)
    in_rank = np.zeros(E, dtype=np.int64)
    dst_counts = np.bincount(g.dst, minlength=n)
    dst_starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(dst_counts, out=dst_starts[1:])
    in_rank[dst_order] = np.arange(E, dtype=np.int64) - dst_starts[g.dst[dst_order]]
    dst_rep_index = (in_rank // cutoff_chunk) % np.maximum(num_replicas[g.dst], 1)
    edge_dst_rid = first_rid[g.dst] + dst_rep_index  # global replica id per edge

    # ---- 4. out-edge chunking (RPVO ghosts) + allocation ----
    src_order = _stable_argsort(g.src, n)
    out_rank = np.zeros(E, dtype=np.int64)
    src_counts = np.bincount(g.src, minlength=n)
    src_starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(src_counts, out=src_starts[1:])
    out_rank[src_order] = np.arange(E, dtype=np.int64) - src_starts[g.src[src_order]]
    chunk_of_edge = out_rank // max(cfg.local_edge_list_size, 1)

    # allocate chunks -> shards
    # chunk key: (src vertex, chunk index); dedupe to one placement per chunk
    chunk_key = g.src.astype(np.int64) * (np.int64(E) + 1) + chunk_of_edge
    uniq_keys, chunk_id_of_edge = np.unique(chunk_key, return_inverse=True)
    n_chunks = uniq_keys.size
    chunk_vertex = (uniq_keys // (E + 1)).astype(np.int64)
    chunk_index = (uniq_keys % (E + 1)).astype(np.int64)

    if cfg.ghost_alloc == "home":
        chunk_shard = root_shard[chunk_vertex]
    elif cfg.ghost_alloc == "random":
        chunk_shard = np.where(
            chunk_index == 0,
            root_shard[chunk_vertex],
            _hash_mod(cfg.seed, _TAG_CHUNK, chunk_vertex, chunk_index, S),
        )
    elif cfg.ghost_alloc == "vicinity":
        vic = _vicinity_order(cfg)
        win = min(S, 25)  # 5x5 neighborhood of the root CC
        offs = vic[1 + _hash_mod(cfg.seed, _TAG_VICINITY, chunk_vertex,
                                 chunk_index, max(win - 1, 1))]
        X, Yd = cfg.dims()
        hx, hy = root_shard[chunk_vertex] % X, root_shard[chunk_vertex] // X
        ox, oy = offs % X, offs // X
        near = ((hy + oy) % Yd) * X + (hx + ox) % X
        chunk_shard = np.where(chunk_index == 0, root_shard[chunk_vertex], near)
    elif cfg.ghost_alloc == "balanced":
        # greedy least-loaded by edges — the TPU-engine default (no NoC
        # locality to exploit under dense collectives; see DESIGN.md §2).
        # NOTE: globally load-dependent, so splice_partition falls back to
        # rebuilding every shard row under this allocator.
        chunk_sizes = np.bincount(chunk_id_of_edge, minlength=n_chunks)
        chunk_shard = np.zeros(n_chunks, dtype=np.int64)
        csort = np.argsort(-chunk_sizes, kind="stable")
        # the least-loaded shard, lowest id first on a tie (np.argmin's)
        heap = [(0, s) for s in range(S)]
        picks = []
        for size in chunk_sizes[csort].tolist():
            ld, s = heapq.heappop(heap)
            picks.append(s)
            heapq.heappush(heap, (ld + size, s))
        chunk_shard[csort] = picks
    else:
        raise ValueError(f"unknown ghost_alloc {cfg.ghost_alloc!r}")
    chunk_shard = chunk_shard.astype(np.int64)
    edge_shard = chunk_shard[chunk_id_of_edge] if E else np.zeros(0, np.int64)

    e_counts = np.bincount(edge_shard, minlength=S)
    e_starts = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(e_counts, out=e_starts[1:])
    shard_sort = _stable_argsort(edge_shard, S)
    E_max = max(int(e_counts.max()) if E else 1, 1)

    return _Placement(
        S=S, n=n, E=E, cutoff_chunk=cutoff_chunk, in_deg=in_deg,
        out_deg=out_deg, root_shard=root_shard, num_replicas=num_replicas,
        R_total=R_total, first_rid=first_rid, rep_vertex=rep_vertex,
        rep_index=rep_index, rep_shard=rep_shard, rep_slot=rep_slot,
        rep_flat=rep_flat, R_max=R_max, root_flat=root_flat,
        edge_dst_rid=edge_dst_rid, edge_shard=edge_shard,
        e_counts=e_counts, e_starts=e_starts, shard_sort=shard_sort,
        E_max=E_max,
    )


def _vr_table(pl: _Placement, K: int) -> tuple[np.ndarray, np.ndarray]:
    """(vertex, replica index) -> flat id table, shaped (n, K), plus mask."""
    rid = pl.first_rid[:-1, None] + np.arange(K, dtype=np.int64)[None, :]
    mask = np.arange(K, dtype=np.int64)[None, :] < pl.num_replicas[:, None]
    rid = np.minimum(rid, np.maximum(pl.first_rid[1:, None] - 1, 0))
    flat = pl.rep_flat[rid] if pl.R_total else np.zeros((pl.n, K), np.int64)
    return flat, mask


# ---------------------------------------------------------------------------
# assembly: per-shard edge rows + compact plan, fresh or copied from old
# ---------------------------------------------------------------------------


def _assemble(g: COOGraph, cfg: PartitionConfig, pl: _Placement,
              old: Partition | None = None,
              rebuild: np.ndarray | None = None) -> Partition:
    S, n, E = pl.S, pl.n, pl.E
    R_max, E_max = pl.R_max, pl.E_max
    if old is None:
        rebuild = np.ones(S, dtype=bool)
    else:
        assert rebuild is not None
        # safety: a shard we plan to copy must hold exactly the same number
        # of edges as before — if not, the diff missed something; rebuild.
        old_counts = old.edge_mask.sum(axis=1)
        rebuild = rebuild | (old_counts != pl.e_counts)

    edge_src_root_flat = np.zeros((S, E_max), dtype=np.int64)
    edge_dst_flat = np.zeros((S, E_max), dtype=np.int64)
    edge_w = np.zeros((S, E_max), dtype=np.float32)
    edge_mask = np.zeros((S, E_max), dtype=bool)
    edge_src_vertex = np.zeros((S, E_max), dtype=np.int64)
    edge_dst_vertex = np.zeros((S, E_max), dtype=np.int64)

    # ---- per-shard padded edge arrays, sorted by destination flat ----
    for s in range(S):
        k = int(pl.e_counts[s])
        if k == 0:
            continue
        if rebuild[s]:
            es = pl.shard_sort[pl.e_starts[s]: pl.e_starts[s + 1]]
            dflat = pl.rep_flat[pl.edge_dst_rid[es]]
            local_order = _stable_argsort(dflat, S * R_max)
            es = es[local_order]
            edge_src_root_flat[s, :k] = pl.root_flat[g.src[es]]
            edge_dst_flat[s, :k] = pl.rep_flat[pl.edge_dst_rid[es]]
            edge_w[s, :k] = g.weight[es]
            edge_src_vertex[s, :k] = g.src[es]
            edge_dst_vertex[s, :k] = g.dst[es]
        else:
            # unchanged content: copy the old row, re-encoding flat ids for
            # a possibly different R_max (same (shard, slot) pairs).
            om = old.edge_mask[s]
            osrf = old.edge_src_root_flat[s][om]
            odf = old.edge_dst_flat[s][om]
            edge_src_root_flat[s, :k] = (osrf // old.R_max) * R_max + osrf % old.R_max
            edge_dst_flat[s, :k] = (odf // old.R_max) * R_max + odf % old.R_max
            edge_w[s, :k] = old.edge_w[s][om]
            edge_src_vertex[s, :k] = old.edge_src_vertex[s][om]
            edge_dst_vertex[s, :k] = old.edge_dst_vertex[s][om]
        edge_mask[s, :k] = True

    edge_owner_cc = np.broadcast_to(
        np.arange(S, dtype=np.int64)[:, None], (S, E_max)
    ).copy()

    # ---- slot tables + rhizome sibling links (always fresh; cheap) ----
    slot_vertex = np.full((S, R_max), -1, dtype=np.int64)
    slot_is_root = np.zeros((S, R_max), dtype=bool)
    slot_vertex[pl.rep_shard, pl.rep_slot] = pl.rep_vertex
    slot_is_root[pl.rep_shard, pl.rep_slot] = pl.rep_index == 0

    sibling_flat = np.zeros((S, R_max, cfg.rpvo_max), dtype=np.int64)
    sibling_mask = np.zeros((S, R_max, cfg.rpvo_max), dtype=bool)
    for r in range(cfg.rpvo_max):
        has = pl.num_replicas[pl.rep_vertex] > r
        sib_rid = pl.first_rid[pl.rep_vertex] + np.minimum(
            r, pl.num_replicas[pl.rep_vertex] - 1)
        sibling_flat[pl.rep_shard, pl.rep_slot, r] = pl.rep_flat[sib_rid]
        sibling_mask[pl.rep_shard, pl.rep_slot, r] = has

    # ---- compact targeted-exchange plan ----
    # distinct destination slots per (source shard, target shard); edges are
    # already sorted by dst flat, so distinct ranks are contiguous per target
    per_st_counts = np.zeros((S, S), dtype=np.int64)
    shard_uniques: list[tuple[np.ndarray, np.ndarray] | None] = []
    for s in range(S):
        if rebuild[s]:
            dst = edge_dst_flat[s][edge_mask[s]]
            uniq, inv = np.unique(dst, return_inverse=True)
            shard_uniques.append((uniq, inv))
            per_st_counts[s] = np.bincount(uniq // R_max, minlength=S)
        else:
            shard_uniques.append(None)
            # distinct-slot counts per target are exactly the non-sentinel
            # entries of the old inbox map's source column
            per_st_counts[s] = (old.inbox_slot_map[:, s, :] != old.R_max).sum(axis=1)
    P_t = max(int(per_st_counts.max()), 1)
    edge_dst_compact = np.zeros((S, E_max), dtype=np.int64)
    inbox_slot_map = np.full((S, S, P_t), R_max, dtype=np.int64)  # pad=R_max
    for s in range(S):
        if rebuild[s]:
            uniq, inv = shard_uniques[s]
            if uniq.size == 0:
                continue
            tgt = uniq // R_max
            t_starts = np.zeros(S + 1, dtype=np.int64)
            np.cumsum(np.bincount(tgt, minlength=S), out=t_starts[1:])
            rank = np.arange(uniq.size) - t_starts[tgt]
            compact_of_uniq = tgt * P_t + rank
            edge_dst_compact[s, : inv.size] = compact_of_uniq[inv]
            inbox_slot_map[tgt, s, rank] = uniq % R_max
        else:
            k = int(pl.e_counts[s])
            om = old.edge_mask[s]
            oc = old.edge_dst_compact[s][om]
            edge_dst_compact[s, :k] = (oc // old.P_t) * P_t + oc % old.P_t
            w = min(old.P_t, P_t)
            col = old.inbox_slot_map[:, s, :w]
            inbox_slot_map[:, s, :w] = np.where(col == old.R_max, R_max, col)

    # compact rhizome-collapse tables (only slots with >1 replica collapse)
    is_rz = sibling_mask.sum(axis=-1) > 1                      # (S, R_max)
    R_rz_max = max(int(is_rz.sum(axis=1).max()), 1)
    rz_local = np.full((S, R_rz_max), R_max, dtype=np.int64)
    rz_compact_of_flat = {}
    for s in range(S):
        slots = np.nonzero(is_rz[s])[0]
        rz_local[s, : slots.size] = slots
        for k, sl in enumerate(slots):
            rz_compact_of_flat[s * R_max + sl] = s * R_rz_max + k
    rz_sibling_idx = np.zeros((S, R_rz_max, cfg.rpvo_max), dtype=np.int64)
    rz_sibling_mask = np.zeros((S, R_rz_max, cfg.rpvo_max), dtype=bool)
    for s in range(S):
        slots = np.nonzero(is_rz[s])[0]
        for k, sl in enumerate(slots):
            for r in range(cfg.rpvo_max):
                if sibling_mask[s, sl, r]:
                    f = int(sibling_flat[s, sl, r])
                    rz_sibling_idx[s, k, r] = rz_compact_of_flat.get(f, 0)
                    rz_sibling_mask[s, k, r] = f in rz_compact_of_flat

    # ---- metrics ----
    ideal = max(E / S, 1e-9)
    metrics = {
        "E_max": E_max,
        "edge_balance": E_max / ideal,            # 1.0 == perfect
        "R_max": R_max,
        "replicas_total": pl.R_total,
        "replica_overhead": pl.R_total / max(n, 1),
        "cutoff_chunk": pl.cutoff_chunk,
        "max_inbox_per_slot": int(
            np.bincount(pl.edge_dst_rid, minlength=pl.R_total).max() if E else 0
        ),
        "shard_edge_counts": pl.e_counts,
    }

    return Partition(
        cfg=cfg, n=n, num_edges=E, S=S, E_max=E_max, R_max=R_max,
        num_replicas_total=pl.R_total,
        edge_src_root_flat=edge_src_root_flat, edge_dst_flat=edge_dst_flat,
        edge_w=edge_w, edge_mask=edge_mask,
        edge_src_vertex=edge_src_vertex, edge_dst_vertex=edge_dst_vertex,
        edge_owner_cc=edge_owner_cc,
        slot_vertex=slot_vertex, slot_is_root=slot_is_root,
        sibling_flat=sibling_flat, sibling_mask=sibling_mask,
        root_flat=pl.root_flat, num_replicas=pl.num_replicas,
        out_deg=pl.out_deg, in_deg=pl.in_deg,
        P_t=P_t, edge_dst_compact=edge_dst_compact,
        inbox_slot_map=inbox_slot_map,
        R_rz_max=R_rz_max, rz_local=rz_local,
        rz_sibling_idx=rz_sibling_idx, rz_sibling_mask=rz_sibling_mask,
        metrics=metrics,
    )


def build_partition(g: COOGraph, cfg: PartitionConfig) -> Partition:
    with obs.span("partition.placement", track="partition"):
        pl = _placement(g, cfg)
    with obs.span("partition.assemble", track="partition"):
        return _assemble(g, cfg, pl)


def splice_partition(
    old: Partition,
    g: COOGraph,
    cfg: PartitionConfig,
    mutated_src: np.ndarray | None = None,
    mutated_dst: np.ndarray | None = None,
) -> tuple[Partition, SpliceInfo]:
    """Rebuild only the shard rows a mutation batch touched.

    ``g`` is the post-mutation graph; ``mutated_src`` / ``mutated_dst``
    are the endpoint vertex ids of every inserted, deleted, or
    reweighted edge (either may be None => conservative full rebuild).
    Because placement is counter-hashed, the result is field-for-field
    identical to ``build_partition(g, cfg)``: unaffected shard rows are
    copied (re-encoded for any R_max / P_t change) instead of re-sorted.

    A shard's edge row must be regenerated iff it holds — before or
    after the mutation — an edge whose src/dst was mutated, whose
    destination vertex gained/lost/moved a replica (adaptive rhizome
    growth), or whose source's root replica slot shifted.
    """
    assert old.n == g.n, "streaming splice keeps the vertex set fixed"
    assert old.cfg.rpvo_max == cfg.rpvo_max
    pl = _placement(g, cfg)
    S, n = pl.S, pl.n
    K = cfg.rpvo_max

    # old / new (vertex, replica index) -> (shard, slot)
    rows = old.root_flat // old.R_max
    cols = old.root_flat % old.R_max
    old_vr_flat = old.sibling_flat[rows, cols][:, :K]
    old_vr_mask = old.sibling_mask[rows, cols][:, :K]
    new_vr_flat, new_vr_mask = _vr_table(pl, K)

    pos_differs = (
        (old_vr_flat // old.R_max != new_vr_flat // pl.R_max)
        | (old_vr_flat % old.R_max != new_vr_flat % pl.R_max)
    )
    moved = (old_vr_mask != new_vr_mask) | (old_vr_mask & new_vr_mask & pos_differs)
    moved_any = moved.any(axis=1)
    root_moved = moved[:, 0] if K else np.zeros(n, bool)
    replicas_added = int((~old_vr_mask & new_vr_mask).sum())
    replicas_removed = int((old_vr_mask & ~new_vr_mask).sum())

    full = (
        mutated_src is None or mutated_dst is None
        or cfg.ghost_alloc == "balanced"
    )
    if full:
        rebuild = np.ones(S, dtype=bool)
        affected_edges = int(g.num_edges)
    else:
        mset = np.zeros(n, dtype=bool)
        mset[np.asarray(mutated_src, dtype=np.int64)] = True
        dset = np.zeros(n, dtype=bool)
        dset[np.asarray(mutated_dst, dtype=np.int64)] = True
        rebuild = np.zeros(S, dtype=bool)
        if g.num_edges:
            aff_new = (mset[g.src] | dset[g.dst]
                       | moved_any[g.dst] | root_moved[g.src])
            np.logical_or.at(rebuild, pl.edge_shard, aff_new)
        else:
            aff_new = np.zeros(0, bool)
        orow, _ = np.nonzero(old.edge_mask)
        osrc = old.edge_src_vertex[old.edge_mask]
        odst = old.edge_dst_vertex[old.edge_mask]
        aff_old = (mset[osrc] | dset[odst]
                   | moved_any[odst] | root_moved[osrc])
        np.logical_or.at(rebuild, orow, aff_old)
        affected_edges = int(aff_new.sum())

    part = _assemble(g, cfg, pl, old=old, rebuild=rebuild)
    info = SpliceInfo(
        shards_rebuilt=int(rebuild.sum()),
        shards_total=S,
        rebuilt_ids=np.nonzero(rebuild)[0].tolist(),
        replicas_added=replicas_added,
        replicas_removed=replicas_removed,
        replicas_moved=int(moved.sum()),
        affected_edges=affected_edges,
        full_rebuild=bool(rebuild.all()),
        r_max_changed=old.R_max != part.R_max,
        e_max_changed=old.E_max != part.E_max,
    )
    return part, info
