"""Dynamic graph mutations + incremental recompute (paper §7 future work).

"Since the data structure is flexible and can grow and shrink a logical
future direction is to design and implement dynamic graph algorithms...
an action containing new edges to be inserted... When the action finishes
modifying the graph structure it can invoke a computation, such as BFS,
that recomputes from there without starting from scratch."

Implemented on the RPVO/Rhizome layout:

* ``insert_edges`` — structural mutation; the new in-edges follow Eq. 1's
  replica-cycling rule (the partition is rebuilt with the same config —
  pointer-level in-place splicing is the AM-CCA form; here the static
  arrays are regenerated, value state migrates).
* ``bfs_incremental_insert`` — monotone warm-start: previous levels are a
  valid upper bound after inserts, so the engine restarts with the old
  values and ``changed`` seeded ONLY at the insert sources; rounds and
  messages scale with the affected region, not the graph.
* ``delete_edges`` — deletions can *raise* monotone values, which a
  min-fixpoint cannot do; the shipped strategy is delete + full recompute
  (affected-subtree invalidation is future work, as in the paper).

The fixpoints run on ``device`` (``None``: CUDA, as every entry point of
the port); the cached values are host numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import actions, engine
from repro_torch.core.partition import (Partition, PartitionConfig,
                                        build_partition)
from repro_torch.graph.graph import COOGraph


@dataclasses.dataclass
class DynamicGraph:
    """A mutable graph + its partition + last computed per-app state."""

    g: COOGraph
    part: Partition
    values: dict
    device: object = None

    @classmethod
    def build(cls, g: COOGraph, cfg: PartitionConfig,
              device=None) -> "DynamicGraph":
        return cls(g=g, part=build_partition(g, cfg), values={},
                   device=device)

    # ---------------------------------------------------------------- edits
    def insert_edges(self, src, dst, weight=None) -> np.ndarray:
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        w = (np.ones(src.shape, np.float32) if weight is None
             else np.asarray(weight, np.float32))
        self._migrate_from = self.part
        self.g = COOGraph(
            self.g.n,
            np.concatenate([self.g.src, src]),
            np.concatenate([self.g.dst, dst]),
            np.concatenate([self.g.weight, w]),
        )
        self.part = build_partition(self.g, self.part.cfg)
        return np.unique(src)

    def delete_edges(self, src, dst) -> np.ndarray:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        # vectorized membership: (src, dst) pairs keyed as src*n + dst
        kill_key = np.unique(src * self.g.n + dst)
        edge_key = self.g.src.astype(np.int64) * self.g.n \
            + self.g.dst.astype(np.int64)
        keep = ~np.isin(edge_key, kill_key)
        self.g = COOGraph(self.g.n, self.g.src[keep], self.g.dst[keep],
                          self.g.weight[keep])
        self._migrate_from = self.part
        self.part = build_partition(self.g, self.part.cfg)
        # deletions can RAISE monotone values: every cached monotone app
        # is stale, not just BFS
        for app in ("bfs", "sssp", "cc"):
            self.values.pop(app, None)
        return np.unique(dst).astype(np.int32)

    # ---------------------------------------------------- incremental apps
    def bfs_full(self, root: int, cfg=engine.EngineConfig()):
        init = engine.init_values(self.part, actions.BFS, {root: 0.0})
        val, stats = engine.run_stacked(actions.BFS, self.part, init, cfg,
                                        device=self.device)
        self.values["bfs"] = val.cpu().numpy()
        return self._levels(val), stats

    def bfs_incremental_insert(self, seeds: np.ndarray,
                               cfg=engine.EngineConfig()):
        """Warm-start BFS after ``insert_edges`` (monotone-safe)."""
        assert "bfs" in self.values, "run bfs_full first"
        old_part = self._migrate_from
        old_levels = self.values["bfs"].reshape(-1)[old_part.root_flat]
        part = self.part
        init = np.full((part.S, part.R_max), np.inf, np.float32)
        gl = init.reshape(-1)
        rows = part.root_flat // part.R_max
        cols = part.root_flat % part.R_max
        sibf = part.sibling_flat[rows, cols]          # (n, K)
        sibm = part.sibling_mask[rows, cols]
        vals = np.repeat(old_levels[:, None], sibf.shape[1], axis=1)
        gl[sibf[sibm]] = vals[sibm].astype(np.float32)

        chg = np.zeros((part.S, part.R_max), dtype=bool)
        gc = chg.reshape(-1)
        finite_seeds = [int(v) for v in seeds
                        if np.isfinite(old_levels[int(v)])]
        for v in finite_seeds:
            gc[int(part.root_flat[v])] = True
        val, stats = engine.run_stacked(actions.BFS, part, init, cfg,
                                        init_changed=chg, device=self.device)
        self.values["bfs"] = val.cpu().numpy()
        return self._levels(val), stats

    def _levels(self, val):
        lv = engine.vertex_values(self.part, val)
        out = np.where(np.isfinite(lv), lv, 0).astype(np.int64)
        out[~np.isfinite(lv)] = np.iinfo(np.int32).max
        return out
