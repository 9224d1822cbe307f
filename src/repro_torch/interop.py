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
runs both packages on the very same partition and launch plan.  LM
weights cross as numpy trees (``lm_params_from_numpy`` and its inverse
``lm_params_to_numpy``), and a reference ``OptState`` through
``opt_state_from_numpy``.
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


def _leaf_to_torch(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        return torch.as_tensor(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def lm_params_from_numpy(cfg, params: dict) -> dict:
    """The port's ``lm.models.Model`` state (``load_state_dict`` form:
    dotted names -> CPU tensors) from the reference's ``Model.init``
    params with numpy leaves (``jax.tree.map(np.asarray, params)``; each
    stage stacked on a leading ``layers`` axis, bfloat16 kept).  Names
    and shapes are checked against the port's model of ``cfg``."""
    from repro_torch.lm.models.model import Model, _flatten
    state = {k: _leaf_to_torch(v) for k, v in _flatten(params).items()}
    want = Model(cfg, device="meta").state_dict()
    if set(state) != set(want):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(state) ^ set(want))}")
    for k, t in state.items():
        if t.shape != want[k].shape or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: {tuple(t.shape)} {t.dtype}, the port "
                             f"wants {tuple(want[k].shape)} {want[k].dtype}")
    return state


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    from repro_torch.sharding.specs import gathered
    t = gathered(t).detach().cpu()   # a DTensor: every rank calls this
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def lm_params_to_numpy(params: dict) -> dict:
    """The reference's nested params dict with numpy leaves from the
    port's parameter tree (``model.param_tree()``, or any tree of
    tensors of its shape, such as optimizer moments).  A bfloat16 leaf
    comes back as float32, exactly; a ``DTensor`` leaf comes back whole
    (every rank of its mesh calls this)."""
    if isinstance(params, dict):
        return {k: lm_params_to_numpy(v) for k, v in params.items()}
    return _tensor_to_numpy(params)


def opt_state_from_numpy(state, device, ctx=None, axes=None):
    """The port's ``lm.train.OptState`` on ``device`` from a reference
    ``OptState`` with numpy leaves (``jax.tree.map(np.asarray, state)``:
    ``step``, and ``mu``/``nu`` as nested dicts of float32 arrays).  With
    a bound ``ctx`` the moments are placed on its mesh by ``axes`` (the
    model's ``_axes_tree``), as their parameters are."""
    from repro_torch.lm.train.optimizer import OptState
    from repro_torch.sharding.specs import place

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.as_tensor(np.array(t, dtype=np.float32), device=device)
    mu, nu = walk(state.mu), walk(state.nu)
    if ctx is not None and ctx.mesh is not None:
        mu, nu = place(mu, axes, ctx), place(nu, axes, ctx)
    return OptState(step=torch.as_tensor(np.int32(state.step),
                                         device=device), mu=mu, nu=nu)
