"""``sharding.pipeline.pipeline_apply`` (GPipe over a ``("pod",)`` mesh)
against the reference's, on the CPU.

The reference test's case (``tests/test_pipeline_pp.py``: 2 stages, 4
microbatches of 3, d 8, tanh stages) from the same numpy weights and
input: the reference's jitted pipeline and ``jax.grad`` of ``sum(y²)`` on
2 XLA host devices in one JAX subprocess, the port's on 2 spawned gloo
ranks (``tests/torch_dist_lm.py pipeline``; the children never import
JAX), the stacked weights placed over pod and whole on each rank.  Outputs within rtol 2e-5 / atol
2e-6 of the reference's and of the sequential stages, gradients within
rtol 1e-5.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
N_STAGES, N_MICRO, MB, D = 2, 4, 3, 8

REF_CHILD = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.sharding.pipeline import pipeline_apply

    z = np.load(sys.argv[1])
    w, x = jnp.asarray(z["w"]), jnp.asarray(z["x"])
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("pod",))
    fn = pipeline_apply(lambda wp, v: jnp.tanh(v @ wp), 2, x.shape[0], mesh)
    y = jax.jit(fn)(w, x)
    g = jax.grad(lambda w: jnp.sum(fn(w, x) ** 2))(w)
    np.savez(sys.argv[2], y=np.asarray(y), g=np.asarray(g))
    print("REF_PIPELINE_OK")
""")

def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    np.savez(tmp / "in.npz", w=w, x=x)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CHILD, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=_env(JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"w": w, "x": x}
    try:
        for stacked in ("placed", "whole"):
            path = tmp / f"port_{stacked}.npz"
            res = subprocess.run(
                [sys.executable, str(TESTS / "torch_dist_lm.py"), "pipeline",
                 str(tmp / "in.npz"), str(path), stacked], env=_env(),
                capture_output=True, text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-6000:]
            out[stacked] = dict(np.load(path))
        so, se = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_PIPELINE_OK" in so, se[-6000:]
    out["ref"] = dict(np.load(tmp / "ref.npz"))
    return out


def _sequential(w, x):
    y = torch.as_tensor(x)
    for s in range(N_STAGES):
        y = torch.tanh(y @ w[s])
    return y


@pytest.mark.parametrize("stacked", ["placed", "whole"])
def test_pipeline_output_equals_reference(runs, stacked):
    port = runs[stacked]
    np.testing.assert_allclose(port["y"], runs["ref"]["y"], rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(
        port["y"], _sequential(torch.as_tensor(runs["w"]), runs["x"]).numpy(),
        rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("stacked", ["placed", "whole"])
def test_pipeline_grad_equals_reference(runs, stacked):
    port = runs[stacked]
    np.testing.assert_allclose(port["g"], runs["ref"]["g"], rtol=1e-5,
                               atol=1e-7)
    w = torch.as_tensor(runs["w"]).requires_grad_(True)
    torch.sum(_sequential(w, runs["x"]) ** 2).backward()
    np.testing.assert_allclose(port["g"], w.grad.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_pipeline_needs_one_stage_a_pod():
    from repro_torch.sharding.pipeline import pipeline_apply

    class Mesh:
        mesh_dim_names = ("pod",)
        shape = (2,)
    with pytest.raises(AssertionError):
        pipeline_apply(lambda p, v: v, 4, 2, Mesh())
