"""Continuous-batching serve scheduler.

Fixed-slot batched decoding: a pool of ``n_slots`` sequence slots shares
one decode step.  Requests join free slots at any step (their prompt is
prefilled into the slot's rows of every cache); finished sequences (EOS
or max-len) free their slot immediately — no head-of-line blocking on
long generations.  One ``decode_step`` over every slot, inactive ones
included, takes a (n_slots,) tensor of per-slot positions: each slot
writes its K/V row (or its recurrent state) and masks its keys at its own
index, and routes its MoE tokens alone, as a decode of one sequence at a
time does.

This is the serving-side analog of the paper's always-keep-the-cell-busy
runtime: slots never idle waiting for the longest sequence in a batch.

Admission control is delegated to the shared ``serve.admission`` layer:
pass ``serve=ServeConfig(max_queue=..., overload_policy=...)`` to bound
the queue — an overflowing submit resolves the request with a typed
``status`` ('rejected' / 'shed') instead of growing the queue without
bound, and priority/tenant-fair ordering applies on dequeue.  The
default config keeps an unbounded FIFO.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.lm.models.model import Model
from repro_torch.serve.admission import AdmissionQueue, QueryStatus, ServeConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt ids
    max_new: int = 16
    eos_id: int = -1              # -1: never
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0             # higher = dequeued first under overload
    tenant: str = "default"       # fair-share admission id
    status: str = QueryStatus.OK  # typed outcome ('rejected'/'shed'/...)


class ContinuousBatcher:
    def __init__(self, model: Model, params, n_slots: int, max_len: int,
                 serve: ServeConfig | None = None):
        if model.cfg.family == "enc_dec":
            raise ValueError("the batcher serves decoder-only models")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.serve = serve if serve is not None else ServeConfig()
        self.caches = model.init_cache(n_slots, max_len)
        self.pos = np.zeros(n_slots, np.int32)       # next write index
        self.slot_req: list[Request | None] = [None] * n_slots
        self.queue = AdmissionQueue(
            self.serve.max_queue, self.serve.overload_policy,
            self.serve.tenant_weights)
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.tick = 0
        self._retired: list[Request] = []
        self._obs_submit_t: dict[int, float] = {}

    def _decode_step(self, params, toks, caches, positions):
        """One decode over every slot at its own position: (n_slots, 1, V)
        logits; the caches are updated in place."""
        dev = self.model.device
        return self.model.decode_step(
            params, torch.as_tensor(toks, device=dev)[:, None], caches,
            torch.as_tensor(positions, device=dev).long())

    def submit(self, req: Request):
        """Offer a request to the bounded queue.  Under overload the
        'reject'/'shed' policies resolve it (or a lower-priority queued
        victim) immediately with ``req.done=True`` and a typed
        ``req.status`` — never an exception, never unbounded growth.
        'block' ticks the decode loop until space frees."""
        rec = obs.get_recorder()
        if rec is not None:
            self._obs_submit_t[req.rid] = rec.tracer.now()
            rec.registry.counter(
                "lm_submitted_total",
                "LM requests offered to the batcher queue",
            ).labels(tenant=req.tenant).inc()
        if self.serve.overload_policy == "block":
            spins = 0
            while self.queue.full:
                if spins >= self.serve.block_max_ticks or not self.step():
                    req.done, req.status = True, QueryStatus.REJECTED
                    self._obs_request_end(req)
                    return
                spins += 1
        decision, victim = self.queue.offer(req)
        if victim is not None:
            victim.done, victim.status = True, QueryStatus.SHED
            self._obs_request_end(victim)
            self._retired.append(victim)
        if decision == "rejected":
            req.done, req.status = True, QueryStatus.REJECTED
            self._obs_request_end(req)
        elif decision == "shed_incoming":
            req.done, req.status = True, QueryStatus.SHED
            self._obs_request_end(req)

    def _obs_request_end(self, req: Request):
        rec = obs.get_recorder()
        t0 = self._obs_submit_t.pop(req.rid, None)
        if rec is None:
            return
        rec.registry.counter(
            "lm_requests_total", "LM requests resolved, by outcome",
        ).labels(status=req.status, tenant=req.tenant).inc()
        if t0 is not None:
            rec.tracer.complete("request", track="lm/requests", start=t0,
                                rid=req.rid, tenant=req.tenant,
                                status=req.status, tokens=len(req.out))

    def _in_flight(self) -> dict:
        c: dict = {}
        for r in self.slot_req:
            if r is not None:
                c[r.tenant] = c.get(r.tenant, 0) + 1
        return c

    def _admit(self):
        rec = obs.get_recorder()
        for s in range(self.n_slots):
            if self.slot_req[s] is None and len(self.queue):
                # priority / tenant-fair order comes from the shared
                # AdmissionQueue — high-priority prompts prefill first
                req = self.queue.take(in_flight=self._in_flight()).item
                self.slot_req[s] = req
                span = None
                if rec is not None:
                    rec.registry.counter(
                        "lm_admitted_total",
                        "LM requests admitted to a decode slot",
                    ).labels(tenant=req.tenant).inc()
                    span = rec.tracer.span(
                        "prefill", track="lm", rid=req.rid, slot=s,
                        priority=req.priority, prompt_len=len(req.tokens))
                # prefill the slot: a one-sequence prefill into views of
                # slot s's rows of every cache, which it writes in place
                sub_cache = _slot_views(self.caches, s)
                logits, _ = self.model.prefill(
                    self.params, {"tokens": np.asarray(req.tokens)[None]},
                    sub_cache)
                self.pos[s] = len(req.tokens)
                self.last_tok[s, 0] = int(torch.argmax(logits[0, -1]))
                req.out.append(int(self.last_tok[s, 0]))
                if span is not None:
                    span.end()

    def step(self):
        """One global decode tick: admit, decode active slots, retire."""
        rec = obs.get_recorder()
        self.tick += 1
        span = None
        if rec is not None:
            span = rec.tracer.span("tick", track="lm", tick=self.tick)
        self._admit()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            if span is not None:
                span.end(active=0, queue=len(self.queue))
            return False
        logits, self.caches = self._decode_step(
            self.params, self.last_tok[:, 0], self.caches, self.pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)
        for s in active:
            req = self.slot_req[s]
            self.pos[s] += 1
            tok = int(nxt[s])
            req.out.append(tok)
            self.last_tok[s, 0] = tok
            if (len(req.out) >= req.max_new or tok == req.eos_id
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None      # slot freed immediately
                self._obs_request_end(req)
                self._retired.append(req)
        if rec is not None:
            span.end(active=len(active), queue=len(self.queue))
            rec.registry.counter(
                "lm_ticks_total", "LM batcher decode ticks").inc()
            rec.registry.gauge(
                "lm_queue_depth", "LM batcher queue depth",
            ).set(len(self.queue))
            rec.tracer.counter("lm", {"queue_depth": len(self.queue),
                                      "active_slots": len(active)})
        return True

    def run(self, max_ticks: int = 1000) -> list[Request]:
        """Tick until the queue and all slots drain (or ``max_ticks``);
        returns the requests that reached a terminal state during the
        run — retired sequences plus any shed queue victims."""
        self._retired.clear()
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        done, self._retired = self._retired, []
        return done


def _slot_views(caches, s):
    """Views of slot ``s``'s rows (batch axis 1 of every stacked leaf)."""
    if isinstance(caches, dict):
        return {k: _slot_views(v, s) for k, v in caches.items()}
    return caches[:, s:s + 1]
