"""The port's int8 gradient compression against the reference's:
``_quantize`` gives the same ``q`` and scales (half-to-even rounding on
both sides) except in a block where the reference misses its own error
bound, ``compress_decompress`` the same gradients and residuals on
the same inputs, and the reference's own checks (``tests/
test_compression.py``) hold for the port: the error bound, error
feedback preserving the sum, the no-feedback mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro.sharding import compression as ref  # noqa: E402
from repro_torch.sharding.compression import (  # noqa: E402
    BLOCK, _dequantize, _quantize, compress_decompress, init_residuals)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-6, 1e4))
@example(seed=1312406088, scale=7.0)   # g/s rounds onto a .5 tie
@example(seed=418, scale=3.0)   # a value within an ulp of a midpoint
def test_quantization_error_bounded(seed, scale):
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.normal(0, scale, size=500).astype(np.float32))
    q, s = _quantize(g)
    deq = _dequantize(q, s, g.shape, g.numel())
    # per-block max error <= scale/2 (half a quantization step)
    err = (deq - g).abs().numpy()
    step = np.repeat(s.numpy()[:, 0], BLOCK)[: g.numel()]
    assert (err <= step / 2 + 1e-12).all()


@pytest.mark.parametrize("size", [1, 255, 256, 500, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_equals_reference(size, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 3.0, size=size).astype(np.float32)
    g[: size // 4] = np.round(g[: size // 4])       # exact .5 ties below
    rq, rs = ref._quantize(jnp.asarray(g))
    q, s = _quantize(torch.as_tensor(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize("seed,scale,repair", [(1312406088, 7.0, "step"),
                                               (418, 3.0, "scale")])
def test_quantize_departs_from_reference_only_where_it_misses(seed, scale,
                                                               repair):
    """The two inputs of ``test_quantization_error_bounded``'s examples,
    where float32 rounding puts one of the reference's dequantized values
    more than half a step from g.  The port departs from the reference
    in that block alone: ``step`` moves that one q by one toward g (the
    scales equal); ``scale`` (both neighbours miss) quantizes the block
    again with its scale times 1 + 2**-20, and every q equals the
    reference's.  Neither misses the bound."""
    g = np.random.default_rng(seed).normal(0, scale, size=500).astype(
        np.float32)
    rq, rs = map(np.asarray, ref._quantize(jnp.asarray(g)))
    q, s = (t.numpy() for t in _quantize(torch.as_tensor(g)))
    blocks = np.pad(g, (0, (-g.size) % BLOCK)).reshape(-1, BLOCK)
    ref_miss = np.argwhere(np.abs(rq * rs - blocks) > rs / 2)
    assert len(ref_miss) == 1
    b, i = ref_miss[0]
    assert not (np.abs(q * s - blocks) > s / 2).any()
    other = np.arange(len(rs)) != b
    np.testing.assert_array_equal(q[other], rq[other])
    np.testing.assert_array_equal(s[other], rs[other])
    if repair == "step":
        assert s[b, 0] == rs[b, 0]
        diff = np.argwhere(q[b] != rq[b])[:, 0].tolist()
        assert diff == [i]
        assert int(q[b, i]) - int(rq[b, i]) == -np.sign(rq[b, i] * rs[b, 0]
                                                       - blocks[b, i])
    else:
        assert s[b, 0] == np.float32(rs[b, 0] * np.float32(1 + 2.0 ** -20))
        np.testing.assert_array_equal(q[b], rq[b])


def test_half_to_even_rounding():
    """127 * (x / max) lands on k + 0.5 for these x: both packages round
    to the even neighbour."""
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, s = _quantize(g)
    assert float(s[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    rq, _ = ref._quantize(jnp.asarray(g.numpy()))
    assert np.asarray(rq)[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_compress_decompress_equals_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(3, 100)).astype(np.float32),
         "b": {"c": rng.normal(size=300).astype(np.float32)}}
    r = {"a": rng.normal(size=(3, 100)).astype(np.float32) * 1e-3,
         "b": {"c": np.zeros(300, np.float32)}}
    tt = lambda t: ({k: tt(v) for k, v in t.items()} if isinstance(t, dict)
                    else torch.as_tensor(t))
    jt = lambda t: ({k: jt(v) for k, v in t.items()} if isinstance(t, dict)
                    else jnp.asarray(t))
    for res in (r, None):
        want, wres = ref.compress_decompress(jt(g), jt(res) if res else None)
        got, gres = compress_decompress(tt(g), tt(res) if res else None)
        for path in (("a",), ("b", "c")):
            pick = lambda t: t[path[0]] if len(path) == 1 else t["b"]["c"]
            np.testing.assert_array_equal(pick(got).numpy(),
                                          np.asarray(pick(want)))
            if res is not None:
                np.testing.assert_array_equal(pick(gres).numpy(),
                                              np.asarray(pick(wres)))
        assert (gres is None) == (res is None)


def test_error_feedback_preserves_sum():
    """With feedback, the *accumulated* compressed signal converges to the
    accumulated true signal (residual stays bounded)."""
    g = {"w": torch.full((300,), 0.001)}  # tiny constant grad
    res = init_residuals(g)
    total = np.zeros(300, np.float32)
    for _ in range(50):
        out, res = compress_decompress(g, res)
        total += out["w"].numpy()
    np.testing.assert_allclose(total, 0.05, rtol=0.05)
    assert res["w"].abs().max() <= 0.001  # bounded residual


def test_no_feedback_mode():
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=100),
                              dtype=torch.float32)}
    out, res = compress_decompress(g, None)
    assert res is None
    assert out["w"].shape == (100,)


def test_bfloat16_grads_keep_their_dtype():
    g = {"w": torch.randn(600, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    out, res = compress_decompress(g, init_residuals(g))
    assert out["w"].dtype == torch.bfloat16
    assert res["w"].dtype == torch.float32
