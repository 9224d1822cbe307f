"""The port's ``TokenPipeline`` against the reference's: ``batch_at``
byte for byte (synthetic Zipf tokens, host shards, a memory-mapped token
file), and the reference's own pipeline checks (determinism, host
sharding, tokens in the vocabulary, the straggler fallback)."""
import time

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("hosts", [1, 4])
def test_batch_at_equals_reference(hosts):
    for h in range(hosts):
        kw = dict(vocab=256000, seq_len=32, global_batch=8, num_hosts=hosts,
                  host_id=h, seed=5)
        for step in (0, 1, 917):
            _equal(TokenPipeline(**kw).batch_at(step),
                   RefPipeline(**kw).batch_at(step))


def test_file_batch_equals_reference(tmp_path):
    data = (np.arange(10000, dtype=np.int64) * 7919 % 50).astype(np.int32)
    f = tmp_path / "tokens.bin"
    data.tofile(str(f))
    for hosts in (1, 2):
        for h in range(hosts):
            kw = dict(vocab=50, seq_len=8, global_batch=4, num_hosts=hosts,
                      host_id=h, token_file=str(f))
            port, ref = TokenPipeline(**kw), RefPipeline(**kw)
            for step in (0, 1, 2, 300):
                _equal(port.batch_at(step), ref.batch_at(step))
                _equal(port._file_batch(step), ref._file_batch(step))


def test_deterministic_and_resumable():
    p1 = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    p2 = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    for step in (0, 5, 917):
        _equal(p1.batch_at(step), p2.batch_at(step))
    b = p1.batch_at(0)
    assert b["tokens"].shape == (8, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_disjoint():
    hosts = [TokenPipeline(vocab=1000, seq_len=8, global_batch=16,
                           num_hosts=4, host_id=h, seed=1) for h in range(4)]
    batches = [p.batch_at(3)["tokens"] for p in hosts]
    assert all(b.shape == (4, 8) for b in batches)
    assert not np.array_equal(batches[0], batches[1])


def test_global_batch_must_split_over_hosts():
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(vocab=10, seq_len=4, global_batch=6, num_hosts=4)


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 10**6), seed=st.integers(0, 2**30))
def test_tokens_in_vocab_property(step, seed):
    p = TokenPipeline(vocab=97, seq_len=12, global_batch=4, seed=seed)
    b = p.batch_at(step)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 97
    assert b["labels"].min() >= 0 and b["labels"].max() < 97


def test_straggler_deadline_fallback():
    p = TokenPipeline(vocab=100, seq_len=8, global_batch=4, seed=1)
    timeouts = []
    real_batch_at = p.batch_at

    def slow(step):
        time.sleep(2.0)
        return real_batch_at(step)
    p.batch_at = slow

    b = p.fetch_with_deadline(0, deadline_s=0.1,
                              on_timeout=lambda s: timeouts.append(s))
    assert timeouts == [0]
    # the fallback batch is the reference's: seed + 993
    _equal(b, RefPipeline(vocab=100, seq_len=8, global_batch=4,
                          seed=994).batch_at(0))


def test_fetch_within_deadline_is_batch_at():
    p = TokenPipeline(vocab=100, seq_len=8, global_batch=4, seed=1)
    _equal(p.fetch_with_deadline(7, deadline_s=30.0), p.batch_at(7))
