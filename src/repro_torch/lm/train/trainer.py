"""Training loop with checkpoint/restart, async saves, and elastic hooks.

The loop is deliberately boring: everything interesting lives in the
substrates it composes (train_step, CheckpointManager, TokenPipeline,
StragglerMonitor).  With a bound ``ctx`` the model's parameters are
put on its mesh (``model.place``, unless the model was built placed)
and ``init_state`` draws the weights with the same generator on every
rank, each rank keeping its shard: the sharded model equals the
unsharded one of the same seed. ``run`` resumes from the latest valid checkpoint
automatically, copying its leaves into the model's parameters and the
optimizer's moments in place; a simulated failure raised by
``failure_hook`` exercises the restore path in tests.  The step's
metrics are read to the host once a step.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import typing

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.manager import _flatten as _ckpt_leaves
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.lm.models.model import Model
from repro_torch.lm.train.optimizer import AdamW
from repro_torch.lm.train.train_step import TrainState, make_train_step
from repro_torch.runtime.elastic import StragglerMonitor
from repro_torch.sharding import compression
from repro_torch.sharding.specs import ShardCtx, is_dtensor


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    async_ckpt: bool = True
    log_every: int = 10
    compress_grads: bool = False


class Trainer:
    def __init__(self, model: Model, opt: AdamW, pipeline: TokenPipeline,
                 tcfg: TrainerConfig, ctx: ShardCtx | None = None,
                 extra_batch: typing.Callable | None = None):
        self.model = model
        self.opt = opt
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.ctx = ctx
        if ctx is not None and ctx.mesh is not None and not model.sharded:
            model.place(ctx)
        self.extra_batch = extra_batch  # vlm/enc_dec stub inputs per step
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.straggler = StragglerMonitor()
        self.step_fn = make_train_step(
            model, opt, ctx, compress_grads=tcfg.compress_grads)
        self.history: list[dict] = []

    def init_state(self, seed: int = 0) -> TrainState:
        params, _ = self.model.init(
            torch.Generator(device=self.model.device).manual_seed(seed))
        residuals = None
        if self.tcfg.compress_grads:
            residuals = compression.init_residuals(params)
        return TrainState(params, self.opt.init(params), residuals)

    @torch.no_grad()
    def _restore(self, step: int, state: TrainState):
        """Copy checkpoint ``step`` into ``state``'s tensors in place."""
        saved = self.ckpt.restore(step, state, device="cpu")
        for (_, dst), (_, src) in zip(_ckpt_leaves(state),
                                      _ckpt_leaves(saved)):
            if is_dtensor(dst):
                dst, src = dst.to_local(), src.to_local()
            dst.copy_(src)

    def run(self, state: TrainState | None = None,
            failure_hook: typing.Callable | None = None):
        if state is None:
            state = self.init_state()
        # a write still in flight from a run that failed is finished first
        self.ckpt.wait()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            start = latest
            self._restore(latest, state)
        for step in range(start, self.tcfg.steps):
            if failure_hook is not None:
                failure_hook(step)  # may raise SimulatedFailure
            batch = self.pipeline.batch_at(step)
            if self.extra_batch is not None:
                batch.update(self.extra_batch(step))
            t0 = time.time()
            state, metrics = self.step_fn(state, batch)
            values = torch.stack([v.float() for v in metrics.values()])
            metrics = dict(zip(metrics, values.tolist()))
            self.straggler.record(self.pipeline.host_id, time.time() - t0)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                self.history.append({"step": step + 1, **metrics})
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state,
                               blocking=not self.tcfg.async_ckpt)
        self.ckpt.wait()
        return state


class SimulatedFailure(RuntimeError):
    pass
