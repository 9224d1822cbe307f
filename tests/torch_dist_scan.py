"""Ranks of the port's recurrences on a (2, 2) CPU mesh (gloo).

    python tests/torch_dist_scan.py OUT.npz

starts 4 gloo ranks (``spawn``, a ``FileStore`` beside OUT) over a
``DeviceMesh("cpu", (2, 2), ("data", "model"))``.  Every rank runs
``apply_mamba`` (reduced jamba), ``apply_mlstm`` and ``apply_slstm``
(reduced xlstm) twice on the same weights and input, drawn from a seed:
whole, and on the mesh with the weights and the input placed; each run
takes the gradient of ``sum(out * w)`` with respect to the input and
every weight.  A dispatch mode counts the ``DTensor`` ops issued while a
scan's trip runs (forward and backward).  Rank 0 writes both runs'
outputs, final states and gradients, and the counts, to OUT.npz.  The
children import ``repro_torch`` only — never JAX or the JAX package.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

B, S = 4, 40          # the batch over data (2); S: the mLSTM pads a chunk
BLOCKS = (("mamba", "jamba-v0.1-52b", "_mamba_trip"),
          ("mlstm", "xlstm-125m", "_mlstm_trip"),
          ("slstm", "xlstm-125m", "_slstm_trip"))


class TripOps(TorchDispatchMode):
    """Counts the trips run (``within``) and the ``DTensor`` ops issued
    inside them."""

    def __init__(self):
        super().__init__()
        self.depth = self.trips = self.dtensor_ops = 0

    def within(self, step):
        def trip(*args):
            self.depth += 1
            self.trips += 1
            try:
                return step(*args)
            finally:
                self.depth -= 1
        return trip

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if self.depth and any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 1
        return func(*args, **(kwargs or {}))


def _whole(t):
    """A ``DTensor``'s whole value with its gradient path kept."""
    from repro_torch.sharding.specs import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _run(block, arch, ctx, seed):
    """(out, state, grads) of one block's sequence form; on ``ctx``'s
    mesh with the weights and input placed, else whole."""
    from repro_torch.lm.configs import ARCHS
    from repro_torch.lm.models import layers as L
    from repro_torch.lm.models import ssm
    from repro_torch.sharding.specs import gathered, place, spmd
    cfg = ARCHS[arch].reduced()
    gen = torch.Generator().manual_seed(seed)
    params, axes = L.split_tree(getattr(ssm, f"init_{block}")(
        L.Draw(gen), cfg, torch.float32))
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    w = torch.randn((B, S, cfg.d_model), generator=gen)
    with spmd(ctx):
        leaves = {k: place(v, axes[k], ctx) for k, v in params.items()}
        xin = place(x, ("act_batch", None, None), ctx)
        for t in (*leaves.values(), xin):
            t.requires_grad_(True)
        out, state = getattr(ssm, f"apply_{block}")(leaves, cfg, xin, ctx)
        (_whole(out) * w).sum().backward()
    grads = {"x": gathered(xin.grad)}
    grads.update({k: gathered(v.grad) for k, v in leaves.items()})
    return (gathered(out.detach()),
            {k: gathered(v.detach()) for k, v in state.items()}, grads)


def _rank(rank, world, store, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.lm.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.lm.models import ssm
    ctx = make_ctx(make_test_mesh((2, 2), device="cpu"))
    counter = TripOps()
    for _, _, name in BLOCKS:
        setattr(ssm, name, counter.within(getattr(ssm, name)))
    results = {}
    for i, (block, arch, _) in enumerate(BLOCKS):
        for tag, c in (("whole", None), ("mesh", ctx)):
            trips, ops = counter.trips, counter.dtensor_ops
            with counter:
                out, state, grads = _run(block, arch, c, seed=i)
            results[f"{block}_{tag}_out"] = out.numpy()
            for k, v in state.items():
                results[f"{block}_{tag}_state_{k}"] = v.numpy()
            for k, v in grads.items():
                results[f"{block}_{tag}_grad_{k}"] = v.numpy()
            results[f"{block}_{tag}_trips"] = np.asarray(counter.trips - trips)
            results[f"{block}_{tag}_dtensor_ops"] = np.asarray(
                counter.dtensor_ops - ops)
    if rank == 0:
        np.savez(out_path, **results)
    dist.barrier()
    dist.destroy_process_group()


def main(argv):
    import torch.multiprocessing as mp
    out_path = argv[0]
    store = out_path + ".store"
    if os.path.exists(store):
        os.remove(store)        # a stale store file hangs gloo
    mp.spawn(_rank, args=(4, store, out_path), nprocs=4)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])
