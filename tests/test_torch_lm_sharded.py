"""The port's sharded LM on a (2, 2) ``("data", "model")`` mesh against
the reference's, on the CPU.

Two processes of work, started once for the module from the same numpy
weights (the reference's ``Model.init`` at each arch's ``reduced()``
width, carried across by ``interop.lm_params_from_numpy``) and batches:

* the reference's jitted mesh runs on 4 XLA host devices (its
  ``make_ctx(make_test_mesh((2, 2)))``), in one JAX subprocess
  (``JAX_PLATFORMS=cpu``,
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
* the port's: 4 spawned gloo ranks on a ``DeviceMesh("cpu", (2, 2))``
  (``tests/torch_dist_lm.py``; the children never import JAX).

Cases: every arch's ``Model.loss`` (rtol 1e-5); one ``make_train_step``
step of minitron and of granite with ``moe_shardmap`` (loss and metrics
rtol 1e-5, every updated leaf to ``tests/test_grad_accum.py``'s
tolerance with the Adam-eps clause); ``apply_moe_shardmap`` alone
(output and aux rtol 1e-5, its collectives counted); ``make_serve_steps``
under "opt" (prefill logits within 1e-4, 8 greedy tokens equal); the
abstract state's local shapes against ``NamedSharding.shard_shape``; a
sharded ``Trainer`` against the unsharded one, a sharded kill-and-resume,
and a sharded checkpoint restored unsharded in both packages.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402,E501
from repro.lm.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro.lm.train import optimizer as ref_opt  # noqa: E402
from repro.lm.train import train_step as ref_ts  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten as ckpt_leaves  # noqa: E402,E501
from repro_torch.lm.configs import ARCHS  # noqa: E402
from repro_torch.lm.models.model import Model, _flatten  # noqa: E402
from repro_torch.lm.train import AdamW  # noqa: E402
from repro_torch.lm.train.train_step import TrainState  # noqa: E402
from repro_torch.sharding.specs import placements_for  # noqa: E402

from torch_dist_lm import ARCHS as CASE_ARCHS, LR, STEP_ARCHS  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
B, S, P = 4, 16, 16

REF_CHILD = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.lm.configs import ARCHS
    from repro.lm.launch import specs
    from repro.lm.launch.mesh import make_ctx, make_test_mesh
    from repro.lm.models import moe
    from repro.lm.models.model import Model
    from repro.lm.train import optimizer, train_step as ts

    inp, out_path = sys.argv[1], sys.argv[2]
    z = dict(np.load(os.path.join(inp, "inputs.npz")))
    ctx = make_ctx(make_test_mesh((2, 2)))
    octx = make_ctx(make_test_mesh((2, 2)), "opt")
    out = {}

    def cfg_for(arch, shardmap=False):
        cfg = ARCHS[arch].reduced()
        return dataclasses.replace(cfg, opts=("moe_shardmap",)) \\
            if shardmap else cfg

    def params(arch):
        tree = {}
        with np.load(os.path.join(inp, f"w_{arch}.npz")) as w:
            for name in w.files:
                *path, leaf = name.split(".")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(w[name])
        tree.setdefault("unembed", {})     # tied: an empty node
        return tree

    def batch(arch, key="train"):
        b = {"tokens": jnp.asarray(z[key + "_tokens"])}
        if key == "train":
            b["labels"] = jnp.asarray(z[key + "_labels"])
        if arch == "paligemma-3b":
            b["patch_embeds"] = jnp.asarray(z["patch_embeds"])
        if arch == "whisper-medium":
            b["frames"] = jnp.asarray(z["frames"])
        return b

    def flat(tree, prefix=""):
        res = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                res.update(flat(v, prefix + k + "."))
            else:
                res[prefix + k] = np.asarray(v, np.float32)
        return res

    for arch in sys.argv[3].split(","):
        m = Model(cfg_for(arch))
        loss, metrics = jax.jit(lambda p, b: m.loss(p, b, ctx))(
            params(arch), batch(arch))
        out["loss_" + arch] = np.float64(loss)
        for k, v in metrics.items():
            out[f"loss_{arch}_{k}"] = np.float64(v)
    for arch in sys.argv[4].split(","):
        m = Model(cfg_for(arch, arch.startswith("granite")))
        opt = optimizer.AdamW(lr=float(sys.argv[5]), weight_decay=0.0)
        p = params(arch)
        st, met = jax.jit(ts.make_train_step(m, opt, ctx))(
            ts.TrainState(p, opt.init(p), None), batch(arch))
        for k, v in met.items():
            out[f"step_{arch}_m_{k}"] = np.float64(v)
        for k, v in flat(st.params).items():
            out[f"step_{arch}_p_{k}"] = v
        for k, v in flat(st.opt.mu).items():
            out[f"step_{arch}_mu_{k}"] = v
        # serving under "opt": the KV sequence over model
        m = Model(cfg_for(arch, arch.startswith("granite")))
        pre, dec = ts.make_serve_steps(m, octx)
        pre, dec = jax.jit(pre), jax.jit(dec)
        prompt = jnp.asarray(z["prompt"])
        caches = m.init_cache(prompt.shape[0], prompt.shape[1] + 8)
        logits, caches = pre(p, {"tokens": prompt}, caches)
        out[f"serve_{arch}_prefill"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1], -1)
        toks = [tok]
        for t in range(8):
            logits, caches = dec(p, tok[:, None], caches,
                                 jnp.int32(prompt.shape[1] + t))
            tok = jnp.argmax(logits[:, -1], -1)
            toks.append(tok)
        out[f"serve_{arch}_tokens"] = np.asarray(jnp.stack(toks, 1))
    cfg = cfg_for("granite-moe-1b-a400m", True)
    mp = jax.tree.map(lambda t: t[0], params("granite-moe-1b-a400m")[
        "stage0"]["moe"])
    o, aux = jax.jit(lambda p, x: moe.apply_moe_shardmap(p, cfg, x, ctx))(
        mp, jnp.asarray(z["moe_x"]))
    out["moe_out"] = np.asarray(o)
    for k, v in aux.items():
        out["moe_aux_" + k] = np.float64(v)
    for arch in sys.argv[3].split(","):
        m = Model(ARCHS[arch])
        ps, axes = specs.abstract_params(m, ctx)
        st = specs.abstract_opt_state(optimizer.AdamW(), ps, axes, ctx)
        cs, _ = specs.abstract_caches(m, 8, 64, ctx)
        for tag, tree in (("p", ps), ("mu", st.mu), ("c", cs)):
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                name = ".".join(str(e.key) for e in k)
                out[f"abstract_{arch}_{tag}_{name}"] = np.asarray(
                    v.sharding.shard_shape(v.shape))
    np.savez(out_path, **out)
    print("REF_LM_SHARDED_OK")
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(TESTS)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


def _inputs(tmp):
    """The reference's weights of every reduced arch and the batches."""
    for arch in CASE_ARCHS:
        params, _ = RefModel(REF_ARCHS[arch].reduced()).init(
            jax.random.PRNGKey(0))
        np.savez(tmp / f"w_{arch}.npz",
                 **_flatten(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(11)
    cfg = ARCHS["minitron-4b"].reduced()
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    np.savez(tmp / "inputs.npz",
             train_tokens=toks[:, :-1], train_labels=toks[:, 1:],
             patch_embeds=rng.standard_normal(
                 (B, 8, cfg.d_model)).astype(np.float32),
             frames=rng.standard_normal((B, 16, cfg.d_model)
                                        ).astype(np.float32),
             moe_x=rng.standard_normal((B, S, cfg.d_model)
                                       ).astype(np.float32),
             prompt=rng.integers(0, cfg.vocab, (B, P)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{'ref': the reference's mesh runs, 'port': the port's ranks',
    'dir': the directory of the port's checkpoints}."""
    tmp = tmp_path_factory.mktemp("lm_sharded")
    _inputs(tmp)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(tmp), str(tmp / "ref.npz"),
         ",".join(CASE_ARCHS), ",".join(STEP_ARCHS), str(LR)],
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        res = subprocess.run(
            [sys.executable, str(TESTS / "torch_dist_lm.py"), str(tmp),
             str(tmp / "port.npz")],
            env=_env(), capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-6000:]
        so, se = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_LM_SHARDED_OK" in so, se[-6000:]
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "port": dict(np.load(tmp / "port.npz")), "dir": tmp}


# tests/test_grad_accum.py's tolerance, and tests/test_torch_lm_step.py's
# clause for entries whose clipped gradient is under 100 Adam eps
STEP_TOL = dict(rtol=5e-4, atol=6e-4)
EPS_REGIME = 1e-6


@pytest.mark.parametrize("arch", CASE_ARCHS)
def test_mesh_loss_equals_reference(runs, arch):
    ref, port = runs["ref"], runs["port"]
    keys = sorted(k for k in ref if k.startswith(f"loss_{arch}"))
    assert keys and keys == sorted(k for k in port
                                   if k.startswith(f"loss_{arch}"))
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_train_step_equals_reference(runs, arch):
    ref, port = runs["ref"], runs["port"]
    pre = f"step_{arch}_m_"
    mk = sorted(k for k in ref if k.startswith(pre))
    assert mk == sorted(k for k in port if k.startswith(pre))
    for k in mk:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    pre = f"step_{arch}_p_"
    pk = sorted(k for k in ref if k.startswith(pre))
    assert pk == sorted(k for k in port if k.startswith(pre))
    for k in pk:
        mu = ref[k.replace("_p_", "_mu_", 1)]
        tiny = np.abs(mu / (1 - 0.9)) < EPS_REGIME
        np.testing.assert_allclose(port[k][~tiny], ref[k][~tiny],
                                   err_msg=k, **STEP_TOL)
        assert np.all(np.abs(port[k][tiny] - ref[k][tiny]) <= LR), k
    assert port[f"step_{arch}_grads_left"] == 0


@pytest.mark.parametrize("kind", ["accum2", "compress"])
def test_mesh_step_variants_equal_unsharded(runs, kind):
    """``accum_steps`` and int8 gradient compression on ``DTensor``
    gradients: the sharded step equals the unsharded one."""
    port = runs["port"]
    pre = f"variants_{kind}_plain_"
    keys = sorted(k[len(pre):] for k in port if k.startswith(pre))
    assert keys
    for k in keys:
        got, want = port[f"variants_{kind}_mesh_{k}"], port[pre + k]
        if k.startswith("m_"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        elif k.startswith("p_"):
            mu = port[pre + "mu_" + k[2:]]
            tiny = np.abs(mu / (1 - 0.9)) < EPS_REGIME
            np.testing.assert_allclose(got[~tiny], want[~tiny], err_msg=k,
                                       **STEP_TOL)
            assert np.all(np.abs(got[tiny] - want[tiny]) <= LR), k


def test_opt_state_from_numpy_places_moments(runs):
    port = runs["port"]
    # stage0.mlp.wi: (layers, embed, mlp) -> data on dim 1, model on 2
    assert list(port["variants_interop_placements"]) == ["S(1)", "S(2)"]
    assert bool(port["variants_interop_ok"])


def test_moe_shardmap_equals_reference(runs):
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_allclose(port["moe_out"], ref["moe_out"], rtol=1e-5,
                               atol=1e-6)
    for k in ("moe_load_balance", "moe_router_z", "moe_drop_fraction"):
        np.testing.assert_allclose(port[f"moe_aux_{k}"], ref[f"moe_aux_{k}"],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_moe_shardmap_collectives(runs):
    """Module 4's schedule: the three expert weights all-gathered over
    dp and ONE all-reduce over tp finishing the combine; the other
    all-reduces are the router's replicated aux terms."""
    port = runs["port"]
    assert int(port["moe_calls_gather"]) == 3
    assert int(port["moe_calls_psum"]) == 1
    assert int(port["moe_comm_allreduce"]) >= 1


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_mesh_serve_equals_reference(runs, arch):
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_allclose(port[f"serve_{arch}_prefill"],
                               ref[f"serve_{arch}_prefill"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(port[f"serve_{arch}_tokens"],
                                  ref[f"serve_{arch}_tokens"])
    # the KV cache's sequence dim is sharded over model ("opt" rules)
    assert "S(2)" in list(port[f"serve_{arch}_kv_placed"])


@pytest.mark.parametrize("arch", CASE_ARCHS)
def test_abstract_local_shapes_equal_shard_shapes(runs, arch):
    ref, port = runs["ref"], runs["port"]
    pre = f"abstract_{arch}_"
    keys = sorted(k for k in ref if k.startswith(pre))
    assert keys and keys == sorted(k for k in port if k.startswith(pre))
    for k in keys:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_sharded_trainer_equals_unsharded(runs):
    port = runs["port"]
    np.testing.assert_allclose(port["trainer_sharded"], port["trainer_plain"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port["trainer_sharded_params"],
                               port["trainer_plain_params"], **STEP_TOL)


def test_sharded_kill_and_resume_is_exact(runs):
    port = runs["port"]
    np.testing.assert_array_equal(port["trainer_resumed"],
                                  port["trainer_sharded"][-1:])
    np.testing.assert_array_equal(port["trainer_resumed_params"],
                                  port["trainer_sharded_params"])


def test_sharded_checkpoint_host_copy_on_rank0_only(runs):
    """A sharded save gathers every leaf on every rank, but only rank 0
    copies the leaves to the host: one copy a leaf a save."""
    copies = runs["port"]["trainer_host_copies"]
    n_leaves = len(ckpt_leaves(_port_like(ARCHS["minitron-4b"].reduced())))
    assert copies[0] == 3 * n_leaves      # three saves, ckpt_every=1
    assert (copies[1:] == 0).all(), copies


def _port_like(cfg):
    model = Model(cfg, device="cpu")
    params = model.param_tree()
    return TrainState(params, AdamW().init(params), None)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_sharded_checkpoint_restores_unsharded(runs, package):
    """The sharded run's last checkpoint, written by rank 0 from the
    gathered leaves, restores into an unsharded tree."""
    path = str(runs["dir"] / "sharded")
    cfg = ARCHS["minitron-4b"].reduced()
    if package == "port":
        mgr = CheckpointManager(path)
        st = mgr.restore(mgr.latest_step(), _port_like(cfg), device="cpu")
        wi = st.params["stage0"]["mlp"]["wi"].numpy()
        step = int(st.opt.step)
    else:
        rm = RefModel(REF_ARCHS["minitron-4b"].reduced())
        rp, _ = rm.init(jax.random.PRNGKey(0))
        like = ref_ts.TrainState(rp, ref_opt.AdamW().init(rp), None)
        mgr = RefCheckpointManager(path)
        st = mgr.restore(mgr.latest_step(), like)
        wi = np.asarray(st.params["stage0"]["mlp"]["wi"])
        step = int(st.opt.step)
    assert step == 3
    np.testing.assert_array_equal(wi, runs["port"]["trainer_sharded_params"])


# --------------------------------------------------------------------------
# placements_for on the cases of tests/test_sharding_specs.py
# --------------------------------------------------------------------------

class FakeMesh:
    """A mesh's names and sizes, as ``DeviceMesh`` gives them."""

    def __init__(self, sizes: dict):
        self.shape = tuple(sizes.values())
        self.mesh_dim_names = tuple(sizes)


@pytest.mark.parametrize("spec,names,want", [
    (("data", "model"), ("data", "model"), ("S0", "S1")),
    (("data", None, None), ("data", "model"), ("S0", "R")),
    (("model", None), ("data", "model"), ("R", "S0")),
    ((("pod", "data"), None), ("pod", "data", "model"), ("S0", "S0", "R")),
    ((None, None, "model", None, None), ("data", "model"), ("R", "S2")),
    ((), ("data", "model"), ("R", "R")),
])
def test_placements_for(spec, names, want):
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({n: 2 for n in names})
    exp = tuple(Replicate() if w == "R" else Shard(int(w[1:])) for w in want)
    assert placements_for(spec, mesh) == exp


def test_placements_follow_spec_for():
    """``sharding_for``'s placements are ``spec_for``'s spec: a dim that
    does not divide stays replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.specs import ShardCtx, spec_for
    mesh = FakeMesh({"data": 16, "model": 16})
    ctx = ShardCtx(mesh=mesh)
    spec = spec_for(("embed", "kv_heads", None), ctx, (4096, 8, 128))
    assert placements_for(spec, mesh) == (Shard(0), Replicate())
    opt = ShardCtx(mesh=mesh, rules="opt")
    spec = spec_for(("layers", "act_batch", "act_kv_seq", "act_kv_heads",
                     None), opt, (40, 128, 32768, 8, 128))
    assert placements_for(spec, mesh) == (Shard(1), Shard(2))
