"""Carry state between the reference package and this port.

The port never imports the reference.  A caller that holds both turns a
reference ``Partition`` into a plain dict (``dataclasses.asdict``: numpy
arrays, scalars and the config as a nested dict) and hands it to
``partition_from_dict``; (S, R_max) value and frontier tables, and
(S, R_max, Q) lane tables (``query.lanes.init_lane_values`` and
``ppr_base_table`` give both packages the same ones), cross as numpy
arrays through ``table_to_torch`` / ``table_to_numpy``; a
reference worklist plan crosses as the dict of its leaves
(``vars(worklist)``) through ``worklist_from_dict``.  With these a test
runs both packages on the very same partition and launch plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import Partition, PartitionConfig
from repro_torch.kernels.fused_relax_reduce import Worklist, tile_schedule


def partition_from_dict(d: dict) -> Partition:
    """The port's ``Partition`` from ``dataclasses.asdict`` of either
    package's ``Partition``."""
    fields = {f.name for f in dataclasses.fields(Partition)}
    if set(d) != fields:
        raise ValueError(f"partition dict fields differ: "
                         f"{sorted(set(d) ^ fields)}")
    cfg = d["cfg"]
    if isinstance(cfg, dict):
        cfg = dict(cfg)
        if cfg.get("mesh_dims") is not None:
            cfg["mesh_dims"] = tuple(cfg["mesh_dims"])
        cfg = PartitionConfig(**cfg)
    return Partition(**{**d, "cfg": cfg})


def table_to_torch(table, device, dtype=None) -> torch.Tensor:
    """An (S, R_max[, Q]) numpy value or frontier table as a tensor."""
    return torch.as_tensor(np.ascontiguousarray(table), dtype=dtype,
                           device=device)


def table_to_numpy(table) -> np.ndarray:
    """An (S, R_max[, Q]) tensor (any device) as a numpy array."""
    return torch.as_tensor(table).detach().cpu().numpy()


def worklist_from_dict(d: dict) -> Worklist:
    """The port's ``Worklist`` from the leaves of a reference worklist
    (``vars(worklist)``: ``wl_i``, ``wl_j``, ``nlive`` as arrays, and its
    ``path`` and ``vblk``).  A tiled host plan keeps its cells' tile
    lists, the reference's accounting, which no launch reads; its copy
    schedule is made anew with the port's mirror rule (``tile_schedule``,
    restarted at each run of cells sharing a chunk)."""
    def arr(k):
        return np.array(d[k], dtype=np.int32)

    wl_i, wl_j, nlive = (arr(k) for k in ("wl_i", "wl_j", "nlive"))
    path = d.get("path", "pinned")
    if path == "pinned":
        return Worklist(*map(torch.as_tensor, (wl_i, wl_j, nlive)))
    ntiles, tiles = arr("cell_ntiles"), arr("cell_tile")
    n = int(nlive[0])
    slot, fetch, _ = tile_schedule(wl_j, n, ntiles, tiles)
    return Worklist(*map(torch.as_tensor, (wl_i, wl_j, nlive, ntiles, tiles,
                                           slot, fetch)),
                    path=path, vblk=int(d["vblk"]))
