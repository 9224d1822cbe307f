"""The system under test: the calls the benchmark makes into
``repro_torch``, and the counter it reads.  No other module of the
harness imports the port, and the reference imports nothing from here.
"""
from __future__ import annotations

import numpy as np
import torch

from benchlib.graphgen import Graph


def coo(g: Graph):
    """The port's host COO graph of the benchmark's graph."""
    from repro_torch.graph.graph import COOGraph
    return COOGraph(g.n, g.src.to(torch.int32).cpu().numpy(),
                    g.dst.to(torch.int32).cpu().numpy(),
                    g.weight.cpu().numpy())


def build_partition(coo_graph, partition: dict):
    from repro_torch.core.partition import PartitionConfig, build_partition
    return build_partition(coo_graph, PartitionConfig(**partition))


def engine_config(engine: dict):
    from repro_torch.core.engine import EngineConfig
    return EngineConfig(**engine)


def search(app: str, coo_graph, root: int, part, cfg, device) -> np.ndarray:
    """``apps.bfs`` (levels, int64, the int32 maximum where unreached) or
    ``apps.sssp`` (float64 distances, inf where unreached)."""
    from repro_torch import apps
    out, _, _ = getattr(apps, app)(coo_graph, root, part=part, cfg=cfg,
                                   device=device)
    return out


def pagerank(coo_graph, damping: float, iters: int, part, cfg, device,
             partition: dict):
    """``apps.pagerank``: (float64 scores, partition); ``part=None``
    builds the partition from ``partition``'s settings."""
    from repro_torch import apps
    return apps.pagerank(coo_graph, damping=damping, iters=iters, part=part,
                         cfg=cfg, device=device,
                         num_shards=partition["num_shards"],
                         rpvo_max=partition["rpvo_max"])


def server(part, opts: dict, cfg, device):
    from repro_torch.query import QueryServer
    return QueryServer(part, cfg=cfg, device=device, **opts)


def host_syncs() -> int | None:
    """The engine's ``engine_host_syncs_total`` over every run label, or
    ``None`` before any fixpoint has counted one."""
    from repro_torch import obs
    snap = obs.registry().snapshot().get("engine_host_syncs_total")
    if not snap or not snap["series"]:
        return None
    return int(sum(snap["series"].values()))
