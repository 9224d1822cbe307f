"""Deterministic, resumable, host-sharded token pipeline.

``batch_at(step)`` is a pure function of (seed, step, host shard) — resume
after preemption is exact with no iterator state to persist, and every
host reads only its own slice of the global batch (data parallelism at
ingest). Sources: seeded synthetic Zipf tokens (default) or a memory-
mapped binary token file.

Straggler hook: ``fetch_with_deadline`` wraps ``batch_at`` with a timeout;
on expiry it substitutes the deterministic fallback batch and reports the
event to the elastic runtime instead of stalling the global step
(bounded-staleness ingest — see runtime/elastic.py).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    token_file: str | None = None
    zipf_a: float = 1.2

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        self.host_batch = self.global_batch // self.num_hosts
        self._mm = None
        if self.token_file:
            self._mm = np.memmap(self.token_file, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict:
        """Pure: (seed, step, host_id) -> {'tokens','labels'} int32 arrays."""
        if self._mm is not None:
            return self._file_batch(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        z = rng.zipf(self.zipf_a, size=(self.host_batch, self.seq_len + 1))
        toks = (z % (self.vocab - 1) + 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _file_batch(self, step: int) -> dict:
        need = self.host_batch * (self.seq_len + 1)
        total = self._mm.size - need - 1
        offset = ((step * self.num_hosts + self.host_id)
                  * need) % max(total, 1)
        flat = np.asarray(self._mm[offset: offset + need], dtype=np.int32)
        toks = flat.reshape(self.host_batch, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # ---------------------------------------------------------- straggler --
    def fetch_with_deadline(self, step: int, deadline_s: float = 5.0,
                            on_timeout=None) -> dict:
        """Fetch batch; on deadline expiry return the synthetic fallback and
        invoke ``on_timeout(step)`` (reported to the elastic runtime)."""
        result: dict = {}
        err: list = []

        def work():
            try:
                result.update(self.batch_at(step))
            except Exception as e:  # noqa: BLE001
                err.append(e)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(deadline_s)
        if t.is_alive() or err:
            if on_timeout is not None:
                on_timeout(step)
            fallback = TokenPipeline(
                self.vocab, self.seq_len, self.global_batch,
                self.num_hosts, self.host_id, seed=self.seed + 993)
            return fallback.batch_at(step)
        return result
