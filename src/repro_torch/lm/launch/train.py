"""Training driver.

  PYTHONPATH=src python -m repro_torch.lm.launch.train --arch minitron-4b \
      --reduced --steps 50 --global-batch 8 --seq-len 64 --device cpu

Runs on CUDA unless ``--device`` names another device.  Full configs
run at their full width on one card; ``--reduced`` runs the smoke-scale
variant.  Checkpoints/restarts, async saves, straggler monitoring and
gradient compression are all flags.  The VLM and enc-dec stub inputs are
drawn from a ``torch.Generator`` seeded by the step.

``--mesh D,M`` trains sharded over a (data=D, model=M) mesh, one rank a
mesh position, under ``torchrun`` (env://) with ``D*M`` ranks:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.lm.launch.train --mesh 2,2 --arch minitron-4b \
      --reduced --steps 2 --device cpu

The backend follows the layout (``collectives.backend_for``): NCCL when
each rank has a GPU of its own (``cuda:LOCAL_RANK``), gloo when the
ranks outnumber the visible GPUs (they share the card) or run on the
CPU.  Only rank 0 prints the history rows.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.exchange.collectives import backend_for
from repro_torch.lm.launch.mesh import make_ctx, make_test_mesh
from repro_torch.lm.configs import get_config
from repro_torch.lm.models.model import Model
from repro_torch.lm.train.optimizer import AdamW, cosine_schedule
from repro_torch.lm.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4,2' => (data=4, model=2) over 8 ranks "
                         "started by torchrun")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ctx, device = None, args.device
    if args.mesh:
        ctx, device = _init_mesh(args.mesh, args.device)
    model = Model(cfg, device=device, ctx=ctx)
    dev = model.device

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=0)

    extra = None
    if cfg.family in ("vlm", "enc_dec"):
        key, n = (("patch_embeds", cfg.n_patches) if cfg.family == "vlm"
                  else ("frames", cfg.encoder.n_frames))

        def extra(step):
            gen = torch.Generator(device=dev).manual_seed(step)
            return {key: torch.randn((args.global_batch, n, cfg.d_model),
                                     generator=gen, device=dev)}

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         compress_grads=args.compress_grads, log_every=10)
    trainer = Trainer(model, opt, pipe, tcfg, ctx, extra_batch=extra)
    trainer.run()
    if ctx is None or dist.get_rank() == 0:
        for row in trainer.history:
            print(",".join(f"{k}={v:.4g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in row.items()))
    if ctx is not None:
        dist.destroy_process_group()
    return trainer


def _init_mesh(spec: str, device):
    """Join the torchrun world and lay the (data, model) mesh over it:
    returns (ctx, this rank's device)."""
    shape = tuple(int(x) for x in spec.split(","))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if math.prod(shape) != world:
        raise ValueError(f"--mesh {spec} needs {math.prod(shape)} ranks, "
                         f"WORLD_SIZE is {world}")
    dev = resolve_device(device)
    backend = backend_for(dev.type, world)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    mesh = make_test_mesh(shape, ("data", "model"), device=dev.type)
    return make_ctx(mesh), dev


if __name__ == "__main__":
    main()
