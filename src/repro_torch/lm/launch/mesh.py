"""Mesh construction over the initialised ``torch.distributed`` world.

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group): 16×16 = 256 ranks a pod, 2 pods = 512 ranks multi-pod.
``make_test_mesh`` lays a small mesh over the first ranks of the world.
The device type is CUDA unless ``device`` names another; each rank's
tensors live on its own device (``cuda:LOCAL_RANK`` under NCCL, the one
card the ranks share under gloo; a gloo world on CUDA routes ``DTensor``'s
all-gathers through ``collectives.route_gloo_cuda_gathers``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.exchange import collectives
from repro_torch.sharding.specs import ShardCtx, mesh_axis_sizes


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def _mesh(shape, axes, device):
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(
            f"need {n} ranks, have {_world()} — initialise a process group "
            f"of at least {n} ranks first (torchrun --nproc-per-node {n})")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        collectives.route_gloo_cuda_gathers()
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_ctx(mesh, rules: str = "default") -> ShardCtx:
    """Bind the ruleset's dp/tp roles to this mesh's axes."""
    names = tuple(mesh_axis_sizes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    return ShardCtx(mesh=mesh, rules=rules, dp=dp, tp=tp)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    return _mesh(tuple(shape), axes, device)
