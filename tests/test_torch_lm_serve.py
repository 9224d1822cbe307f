"""The port's ``ContinuousBatcher`` against the reference's on the same
requests and weights (``tests/test_serve_scheduler.py``'s setting:
``phi3-medium-14b`` reduced, and a MoE and a recurrent arch), token for
token; slot reuse, the priority prefill order with its spans and
counters, and the ``reject`` / ``shed`` / ``block`` statuses under
``max_queue``, each held to the reference's outcome.  The port runs on
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as ref_obs  # noqa: E402
from repro.lm.configs import get_config as ref_get_config  # noqa: E402
from repro.lm.models.model import Model as RefModel  # noqa: E402
from repro.serve.admission import ServeConfig as RefServeConfig  # noqa: E402
from repro.serve.scheduler import (  # noqa: E402
    ContinuousBatcher as RefBatcher, Request as RefRequest)
from repro_torch import obs  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.lm.configs import get_config  # noqa: E402
from repro_torch.lm.models.model import Model  # noqa: E402
from repro_torch.serve.admission import ServeConfig  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatcher, Request  # noqa: E402


def _models(arch, seed):
    ref = RefModel(ref_get_config(arch).reduced())
    params, _ = ref.init(jax.random.PRNGKey(seed))
    port = Model(get_config(arch).reduced(), device="cpu")
    port.load_state_dict(lm_params_from_numpy(
        port.cfg, jax.tree.map(np.asarray, params)))
    return ref, params, port


def _single_stream(model, params, prompt, n_new, max_len):
    caches = model.init_cache(1, max_len)
    logits, caches = model.prefill(params, {"tokens": prompt[None]}, caches)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, caches = model.decode_step(
            params, torch.tensor([[out[-1]]]), caches, pos)
        out.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return out


def _serve_both(arch, seed, lens, max_new, n_slots, max_len, serve=None,
                priorities=None, ticks_between=()):
    """The same stream through both batchers; returns (ref requests, port
    requests, ref batcher, port batcher, ref done, port done)."""
    ref, params, port = _models(arch, seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, port.cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    prio = priorities or [0] * len(lens)
    rb = RefBatcher(ref, params, n_slots=n_slots, max_len=max_len,
                    serve=RefServeConfig(**serve) if serve else None)
    pb = ContinuousBatcher(port, port.param_tree(), n_slots=n_slots,
                           max_len=max_len,
                           serve=ServeConfig(**serve) if serve else None)
    rr = [RefRequest(rid=i, tokens=p, max_new=max_new, priority=q)
          for i, (p, q) in enumerate(zip(prompts, prio))]
    pr = [Request(rid=i, tokens=p, max_new=max_new, priority=q)
          for i, (p, q) in enumerate(zip(prompts, prio))]
    for i, (a, b) in enumerate(zip(rr, pr)):
        rb.submit(a)
        pb.submit(b)
        if i in ticks_between:
            rb.step()
            pb.step()
    rdone, pdone = rb.run(), pb.run()
    return rr, pr, rb, pb, rdone, pdone, port, prompts


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "granite-moe-1b-a400m",
                                  "xlstm-125m"])
def test_batched_equals_reference_token_for_token(arch):
    rr, pr, rb, pb, rdone, pdone, port, prompts = _serve_both(
        arch, 0, (5, 7, 4, 9), max_new=6, n_slots=2, max_len=32)
    assert all(r.done for r in pr)
    assert [r.out for r in pr] == [r.out for r in rr]
    assert [r.rid for r in pdone] == [r.rid for r in rdone]
    assert pb.tick == rb.tick
    np.testing.assert_array_equal(pb.pos, rb.pos)
    # and each answer is its own single-stream run
    for r, p in zip(pr, prompts):
        assert r.out == _single_stream(port, port.param_tree(), p, 6, 32)


def test_slots_are_reused():
    """3 requests through 2 slots: the freed slot takes the queued one."""
    rr, pr, rb, pb, *_ = _serve_both("minitron-4b", 1, (4, 4, 4), max_new=3,
                                     n_slots=2, max_len=24)
    assert all(r.done for r in pr)
    assert all(len(r.out) == 3 for r in pr)
    assert [r.out for r in pr] == [r.out for r in rr]


def test_max_len_retires_a_sequence():
    rr, pr, *_ = _serve_both("minitron-4b", 4, (6, 3), max_new=50,
                             n_slots=2, max_len=12)
    assert [len(r.out) for r in pr] == [len(r.out) for r in rr] == [6, 9]
    assert [r.out for r in pr] == [r.out for r in rr]


def test_priority_prefill_order_and_run_returns_done():
    """High-priority prompts prefill first via the shared AdmissionQueue,
    run() returns the retired requests, and obs spans and counters keep
    the reference's names and counts."""
    ref, params, port = _models("minitron-4b", 2)
    rng = np.random.default_rng(2)
    toks = [rng.integers(0, port.cfg.vocab, size=4).astype(np.int32)
            for _ in range(3)]
    prios = [0, 5, 1]

    def run(batcher_cls, req_cls, model, p, cfg_cls, recording):
        b = batcher_cls(model, p, n_slots=1, max_len=24,
                        serve=cfg_cls(max_queue=8))
        reqs = [req_cls(rid=i, priority=q, max_new=2, tokens=t)
                for i, (q, t) in enumerate(zip(prios, toks))]
        with recording() as rec:
            for r in reqs:
                b.submit(r)
            done = b.run()
        return b, reqs, done, rec

    rb, rreqs, rdone, rrec = run(RefBatcher, RefRequest, ref, params,
                                 RefServeConfig, ref_obs.recording)
    pb, preqs, pdone, prec = run(ContinuousBatcher, Request, port,
                                 port.param_tree(), ServeConfig,
                                 obs.recording)
    assert sorted(r.rid for r in pdone) == [0, 1, 2]
    assert [r.out for r in preqs] == [r.out for r in rreqs]
    prefills = [e["args"]["rid"] for e in prec.tracer.events()
                if e["name"] == "prefill"]
    assert prefills == [1, 2, 0]                     # priority order
    assert prefills == [e["args"]["rid"] for e in rrec.tracer.events()
                        if e["name"] == "prefill"]
    want, got = rrec.registry.snapshot(), prec.registry.snapshot()
    for name in ("lm_submitted_total", "lm_admitted_total",
                 "lm_requests_total", "lm_ticks_total", "lm_queue_depth"):
        assert got[name]["series"] == want[name]["series"], name
    assert len([e for e in prec.tracer.events() if e["name"] == "tick"]) \
        == pb.tick == rb.tick


@pytest.mark.parametrize("policy", ["reject", "shed", "block"])
def test_overload_statuses_equal_reference(policy):
    """A burst over ``max_queue``: the same requests rejected, shed or
    admitted (block ticks the loop), with the reference's statuses and
    tokens."""
    rr, pr, rb, pb, rdone, pdone, *_ = _serve_both(
        "minitron-4b", 3, (4, 5, 3, 6, 4, 5), max_new=3, n_slots=1,
        max_len=24, serve=dict(max_queue=2, overload_policy=policy),
        priorities=[0, 0, 1, 3, 0, 2], ticks_between=(0,))
    assert [r.status for r in pr] == [r.status for r in rr]
    assert [r.done for r in pr] == [r.done for r in rr]
    assert [r.out for r in pr] == [r.out for r in rr]
    statuses = {r.status for r in pr}
    if policy == "reject":
        assert "rejected" in statuses
    if policy == "shed":
        assert "shed" in statuses
    assert [r.rid for r in pdone] == [r.rid for r in rdone]


def test_encoder_decoder_is_refused():
    model = Model(get_config("whisper-medium").reduced(), device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousBatcher(model, model.param_tree(), n_slots=2, max_len=8)
