"""``repro_torch.lm.launch.hlo_analysis`` and the port's
``parse_collective_bytes`` against the reference's, field for field, on
HLO text that JAX compiles on the CPU: a ``lax.scan`` of products, a
data-dependent ``while_loop``, a loop whose fusion ends in a
``dynamic-update-slice`` and a ``shard_map`` psum/all-gather over 8 host
devices.

The programs are compiled in one child process (XLA fixes the host
device count when it starts, and importing the reference's ``dryrun``
sets ``XLA_FLAGS`` for the whole process); the child also runs the
reference's two functions on each text.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CHILD = textwrap.dedent("""
    import os, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map

    assert len(jax.devices()) == 8   # before the reference's dryrun import
    from repro.lm.launch import hlo_analysis
    from repro.lm.launch.dryrun import parse_collective_bytes

    def hlo(fn, *args):
        return jax.jit(fn).lower(*args).compile().as_text()

    f32 = jnp.float32
    x = jnp.ones((8, 64), f32)
    ws = jnp.ones((6, 64, 64), f32)

    def scan(x, ws):
        return lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]

    def while_(x, w, lim):
        def body(c):
            v, n = c
            return jnp.tanh(v @ w) + 1.0, n + 1
        return lax.while_loop(lambda c: jnp.sum(c[0]) < lim, body,
                              (x, jnp.int32(0)))

    def dus(x):
        buf = jnp.zeros((5, 8, 64), f32)
        return lax.fori_loop(0, 5, lambda i, b: lax.dynamic_update_slice(
            b, (jnp.sin(x) * i)[None], (i, 0, 0)), buf)

    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))

    def body(a, w):
        wg = lax.all_gather(w, "model", axis=1, tiled=True)
        return lax.psum(a @ wg, "data")

    sm = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P("data", None), P(None, "model")),
                           out_specs=P(None, None), check_rep=False))
    texts = {
        "scan": hlo(scan, x, ws),
        "while": hlo(while_, x, ws[0], f32(1e6)),
        "dus": hlo(dus, x),
        "shard_map": sm.lower(jnp.ones((32, 64), f32),
                              jnp.ones((64, 16), f32)).compile().as_text(),
    }
    out = {}
    for k, t in texts.items():
        a = hlo_analysis.analyze(t)
        out[k] = {"hlo": t, "analyze": dataclasses.asdict(a),
                  "collective_total": a.collective_total,
                  "parse": parse_collective_bytes(t)}
    print("HLO_JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def compiled():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(s for s in res.stdout.splitlines()
                if s.startswith("HLO_JSON"))
    return json.loads(line[len("HLO_JSON"):])


@pytest.mark.parametrize("name", ["scan", "while", "dus", "shard_map"])
def test_analyze_matches_reference(compiled, name):
    from repro_torch.lm.launch import hlo_analysis
    case = compiled[name]
    got = hlo_analysis.analyze(case["hlo"])
    assert dataclasses.asdict(got) == case["analyze"]
    assert got.collective_total == case["collective_total"]


@pytest.mark.parametrize("name", ["scan", "while", "dus", "shard_map"])
def test_parse_collective_bytes_matches_reference(compiled, name):
    from repro_torch.lm.launch.dryrun import parse_collective_bytes
    assert parse_collective_bytes(compiled[name]["hlo"]) \
        == compiled[name]["parse"]


def test_programs_exercise_what_they_name(compiled):
    """Each text reaches the analysis path it is here for: trip-counted
    products in the scan, a data-dependent loop, a dynamic-update-slice
    fusion, and both collectives in the shard_map."""
    from repro_torch.lm.launch import hlo_analysis
    scan = hlo_analysis.analyze(compiled["scan"]["hlo"])
    assert scan.num_whiles == 1 and not scan.has_dynamic_loops
    assert scan.flops == 6 * 2 * 8 * 64 * 64
    loop = hlo_analysis.analyze(compiled["while"]["hlo"])
    assert loop.has_dynamic_loops and loop.flops == 2 * 8 * 64 * 64
    assert "dynamic-update-slice" in compiled["dus"]["hlo"]
    sm = compiled["shard_map"]
    assert set(sm["parse"]) >= {"all-gather", "all-reduce", "total"}
    assert sm["analyze"]["collective_bytes"]["all-gather"] == 64 * 16 * 4
