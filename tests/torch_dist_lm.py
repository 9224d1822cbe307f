"""Ranks of the port's sharded LM on a (2, 2) CPU mesh (gloo).

    python tests/torch_dist_lm.py IN_DIR OUT.npz
    python tests/torch_dist_lm.py pipeline IN.npz OUT.npz placed|whole

starts 4 gloo ranks (``spawn``, a ``FileStore`` beside OUT), lays a
``DeviceMesh("cpu", (2, 2), ("data", "model"))`` over them and runs every
case of ``CASES`` on every rank, each rank making the same sharded
calls; rank 0 writes what the cases return to OUT.npz (a case's keys
prefixed with its name).  The weights and batches come from IN_DIR:
``w_<arch>.npz`` (the reference's ``Model.init`` params, flattened by
dotted name) and ``inputs.npz``.  The children import ``repro_torch``
only — never JAX or the JAX package.

The ``pipeline`` form runs ``sharding.pipeline.pipeline_apply`` on 2
ranks of a ``("pod",)`` mesh: the stacked weights placed over pod
(``stage_shardings``) or whole on each rank, the output and the gradient
of ``sum(y²)`` written by rank 0.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

CPU = "cpu"
ARCHS = ("paligemma-3b", "whisper-medium", "granite-moe-1b-a400m",
         "deepseek-moe-16b", "command-r-35b", "minitron-4b", "qwen3-32b",
         "phi3-medium-14b", "xlstm-125m", "jamba-v0.1-52b")
STEP_ARCHS = ("minitron-4b", "granite-moe-1b-a400m")
LR = 1e-2


def cfg_for(arch: str, shardmap: bool = False):
    """The reduced config a case runs: granite with ``moe_shardmap``
    where asked (the same helper builds the reference's)."""
    from repro_torch.lm.configs import ARCHS as CFGS
    cfg = CFGS[arch].reduced()
    if shardmap:
        cfg = dataclasses.replace(cfg, opts=("moe_shardmap",))
    return cfg


def _weights(inp, arch):
    with np.load(os.path.join(inp, f"w_{arch}.npz")) as z:
        return {k: torch.as_tensor(z[k]) for k in z.files}


def _model(inp, arch, ctx, shardmap=False):
    """The port's model on the mesh, loaded with the reference's
    weights (each rank keeping its shards)."""
    from repro_torch.lm.models.model import Model
    from repro_torch.sharding.specs import spmd
    cfg = cfg_for(arch, shardmap)
    model = Model(cfg, device=CPU, ctx=ctx)
    with spmd(ctx):
        model.load_state_dict(_weights(inp, arch))
    return model


def _batch(z, arch, key="train"):
    b = {"tokens": torch.as_tensor(z[f"{key}_tokens"])}
    if key == "train":
        b["labels"] = torch.as_tensor(z[f"{key}_labels"])
    if arch == "paligemma-3b":
        b["patch_embeds"] = torch.as_tensor(z["patch_embeds"])
    if arch == "whisper-medium":
        b["frames"] = torch.as_tensor(z["frames"])
    return b


def _flat_np(tree):
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.lm.models.model import _flatten
    return _flatten(lm_params_to_numpy(tree))


def case_loss(ctx, inp, z, out):
    """Every arch's ``Model.loss`` on the mesh."""
    for arch in ARCHS:
        model = _model(inp, arch, ctx)
        loss, metrics = model.loss(model.param_tree(), _batch(z, arch), ctx)
        out[arch] = np.float64(loss)
        for k, v in metrics.items():
            out[f"{arch}_{k}"] = np.float64(v)


def case_step(ctx, inp, z, out):
    """One ``make_train_step`` step on the mesh (granite with
    ``moe_shardmap``): metrics and every updated leaf."""
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.train_step import TrainState
    for arch in STEP_ARCHS:
        model = _model(inp, arch, ctx, shardmap=arch.startswith("granite"))
        opt = AdamW(lr=LR, weight_decay=0.0)
        params = model.param_tree()
        step = make_train_step(model, opt, ctx)
        state, m = step(TrainState(params, opt.init(params), None),
                        _batch(z, arch))
        for k, v in m.items():
            out[f"{arch}_m_{k}"] = np.float64(v)
        for k, v in _flat_np(state.params).items():
            out[f"{arch}_p_{k}"] = v
        out[f"{arch}_grads_left"] = np.asarray(
            sum(p.grad is not None for p in model.parameters()))


def case_variants(ctx, inp, z, out):
    """minitron's step with ``accum_steps=2`` and with int8 gradient
    compression on the mesh, and (rank 0) the same steps unsharded; the
    reference's moments carried onto the mesh (``opt_state_from_numpy``
    with a ctx)."""
    from repro_torch.interop import opt_state_from_numpy
    from repro_torch.lm.models.model import _flatten, _map
    from repro_torch.lm.train import AdamW, make_train_step
    from repro_torch.lm.train.train_step import TrainState
    from repro_torch.sharding import compression
    from repro_torch.sharding.specs import gathered
    arch = "minitron-4b"
    batch = _batch(z, arch)
    for kind, kw in (("accum2", {"accum_steps": 2}),
                     ("compress", {"compress_grads": True})):
        for tag, c in (("mesh", ctx), ("plain", None)):
            if c is None and dist.get_rank() != 0:
                continue
            model = _model(inp, arch, c)
            opt = AdamW(lr=LR, weight_decay=0.0)
            params = model.param_tree()
            res = (compression.init_residuals(params)
                   if kw.get("compress_grads") else None)
            state, m = make_train_step(model, opt, c, **kw)(
                TrainState(params, opt.init(params), res), batch)
            for k, v in m.items():
                out[f"{kind}_{tag}_m_{k}"] = np.float64(v)
            for k, v in _flat_np(state.params).items():
                out[f"{kind}_{tag}_p_{k}"] = v
            for k, v in _flat_np(state.opt.mu).items():
                out[f"{kind}_{tag}_mu_{k}"] = v
    model = _model(inp, arch, ctx)
    mu = _map(lambda t: np.full(t.shape, 0.5, np.float32),
              model.param_tree())
    st = opt_state_from_numpy(types.SimpleNamespace(step=3, mu=mu, nu=mu),
                              CPU, ctx, model._axes_tree)
    leaf = _flatten(st.mu)["stage0.mlp.wi"]
    out["interop_placements"] = np.asarray([str(q) for q in leaf.placements])
    out["interop_ok"] = np.asarray(all(
        bool((gathered(t) == 0.5).all()) for t in _flatten(st.nu).values()))


def case_moe(ctx, inp, z, out):
    """``apply_moe_shardmap`` alone on granite's first MoE layer, with
    its collectives counted (forward, then backward)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.exchange import collectives as C
    from repro_torch.lm.models import moe
    from repro_torch.lm.models.model import _map
    from repro_torch.sharding.specs import gathered, place, spmd
    cfg = cfg_for("granite-moe-1b-a400m", shardmap=True)
    model = _model(inp, "granite-moe-1b-a400m", ctx, shardmap=True)
    p = _map(lambda t: t.detach(), model.param_tree()["stage0"]["moe"])
    axes = model._axes_tree["stage0"]["moe"]
    p = _map(lambda t, a: place(gathered(t)[0], a[1:], ctx), p, axes)
    x = torch.as_tensor(z["moe_x"])
    C.reset_counters()
    with spmd(ctx), CommDebugMode() as comm:
        xs = place(x, ("act_batch", "act_seq", None), ctx)
        o, aux = moe.apply_moe_shardmap(p, cfg, xs, ctx)
    out["calls_gather"] = np.asarray(C.calls["all_gather_dim"])
    out["calls_psum"] = np.asarray(C.calls["psum_replicated"])
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["comm_allreduce"] = np.asarray(sum(
        v for k, v in counts.items() if "allreduce" in k
        or "all_reduce" in k))
    out["out"] = gathered(o).numpy()
    for k, v in aux.items():
        out[f"aux_{k}"] = np.float64(gathered(v))


def case_serve(ctx, inp, z, out):
    """``make_serve_steps`` under the "opt" rules (the KV sequence over
    model): prefill logits and 8 greedy decode steps."""
    from repro_torch.lm.launch.mesh import make_ctx
    from repro_torch.lm.train.train_step import make_serve_steps
    octx = make_ctx(ctx.mesh, "opt")
    for arch in STEP_ARCHS:
        model = _model(inp, arch, octx, shardmap=arch.startswith("granite"))
        pre, dec = make_serve_steps(model, octx)
        prompt = torch.as_tensor(z["prompt"])
        B, P = prompt.shape
        caches = model.init_cache(B, P + 8)
        logits, caches = pre(model.param_tree(), {"tokens": prompt}, caches)
        out[f"{arch}_prefill"] = logits.numpy()
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for t in range(8):
            logits, caches = dec(model.param_tree(), tok[:, None], caches,
                                 P + t)
            tok = logits[:, -1].argmax(-1)
            toks.append(tok)
        out[f"{arch}_tokens"] = torch.stack(toks, 1).numpy()
        out[f"{arch}_kv_placed"] = np.asarray(
            [str(q) for q in caches["stage0"]["k"].placements])


def case_abstract(ctx, inp, z, out):
    """Every leaf's local shape of the abstract params, optimizer state
    and caches."""
    from repro_torch.lm.configs import ARCHS as CFGS
    from repro_torch.lm.launch import specs
    from repro_torch.lm.models.model import Model, _flatten
    from repro_torch.lm.train import AdamW
    for arch in ARCHS:
        model = Model(CFGS[arch], device="meta")
        ps, axes = specs.abstract_params(model, ctx)
        st = specs.abstract_opt_state(AdamW(), ps, axes, ctx)
        cs, _ = specs.abstract_caches(model, 8, 64, ctx)
        for tag, tree in (("p", ps), ("mu", st.mu), ("c", cs)):
            for k, v in _flatten(tree).items():
                out[f"{arch}_{tag}_{k}"] = np.asarray(specs.local_shape(v))


def case_trainer(ctx, inp, z, out, tmp):
    """A sharded ``Trainer`` of 3 steps, the same killed after its
    step-2 checkpoint and resumed, and (rank 0) the unsharded run."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.lm.models.model import Model
    from repro_torch.lm.train import AdamW
    from repro_torch.lm.train.trainer import (SimulatedFailure, Trainer,
                                              TrainerConfig)
    cfg = cfg_for("minitron-4b")

    def trainer(tag, c, ckpt_every=2):
        tc = TrainerConfig(steps=3, ckpt_every=ckpt_every, log_every=1,
                           ckpt_dir=os.path.join(tmp, tag))
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4,
                             seed=3)
        return Trainer(Model(cfg, device=CPU), AdamW(lr=LR), pipe, tc, c)

    def hist(t):
        return np.asarray([[r[k] for k in sorted(r)] for r in t.history])

    # host copies made by the checkpoint writes, counted on each rank
    from repro_torch.checkpoint import manager
    host, copies = manager._host, [0]

    def counted(leaf):
        copies[0] += 1
        return host(leaf)
    manager._host = counted
    try:
        t = trainer("sharded", ctx, ckpt_every=1)
        state = t.run(t.init_state(5))
    finally:
        manager._host = host
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, copies[0])
    out["host_copies"] = np.asarray(counts)
    out["sharded"] = hist(t)
    out["sharded_params"] = _flat_np(state.params)["stage0.mlp.wi"]

    def boom(step):
        if step == 2:
            raise SimulatedFailure("killed")
    t = trainer("resumed", ctx)
    try:
        t.run(t.init_state(5), failure_hook=boom)
    except SimulatedFailure:
        t.ckpt.wait()       # the step-2 write lands before anyone resumes
    t2 = trainer("resumed", ctx)
    state = t2.run(t2.init_state(99))
    out["resumed"] = hist(t2)
    out["resumed_params"] = _flat_np(state.params)["stage0.mlp.wi"]
    if dist.get_rank() == 0:
        t = trainer("plain", None)
        state = t.run(t.init_state(5))
        out["plain"] = hist(t)
        out["plain_params"] = _flat_np(state.params)["stage0.mlp.wi"]
        out["keys"] = np.asarray(sorted(t.history[0]))


CASES = {"loss": case_loss, "step": case_step, "variants": case_variants,
         "moe": case_moe,
         "serve": case_serve, "abstract": case_abstract,
         "trainer": case_trainer}


def _rank(rank, world, store, inp, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.lm.launch.mesh import make_ctx, make_test_mesh
    ctx = make_ctx(make_test_mesh((2, 2), device=CPU))
    tmp = os.path.dirname(out_path)
    results = {}
    with np.load(os.path.join(inp, "inputs.npz")) as z:
        z = dict(z)
    for name, fn in CASES.items():
        out = {}
        args = (ctx, inp, z, out) + ((tmp,) if name == "trainer" else ())
        fn(*args)
        results.update({f"{name}_{k}": v for k, v in out.items()})
    if rank == 0:
        np.savez(out_path, **results)
    dist.barrier()
    dist.destroy_process_group()


def _pipeline_rank(rank, store, inp, out, stacked):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.pipeline import pipeline_apply, stage_shardings
    from repro_torch.sharding.specs import gathered
    z = np.load(inp)
    w, x = torch.as_tensor(z["w"]), torch.as_tensor(z["x"])
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("pod",))
    if stacked == "placed":
        m, pl = stage_shardings(mesh, {"w": w})["w"]
        w = distribute_tensor(w, m, pl, src_data_rank=None)
    w.requires_grad_(True)
    fn = pipeline_apply(lambda wp, v: torch.tanh(v @ wp), 2, x.shape[0],
                        mesh)
    y = fn(w, x)
    torch.sum(y ** 2).backward()
    g = gathered(w.grad).clone()
    if stacked == "whole":
        dist.all_reduce(g)      # each rank holds its own stage's rows
    if rank == 0:
        np.savez(out, y=y.detach().numpy(), g=g.numpy())
    dist.destroy_process_group()


def _spawn(fn, world, out_path, *args):
    import torch.multiprocessing as mp
    store = out_path + ".store"
    if os.path.exists(store):
        os.remove(store)        # a stale store file hangs gloo
    mp.spawn(fn, args=(world, store) + args if fn is _rank
             else (store,) + args, nprocs=world)


def main(argv):
    if argv[0] == "pipeline":
        inp, out_path, stacked = argv[1:4]
        _spawn(_pipeline_rank, 2, out_path, inp, out_path, stacked)
    else:
        inp, out_path = argv[:2]
        _spawn(_rank, 4, out_path, inp, out_path)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1:])
