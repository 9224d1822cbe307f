"""Training driver.

  PYTHONPATH=src python -m repro_torch.lm.launch.train --arch minitron-4b \
      --reduced --steps 50 --global-batch 8 --seq-len 64 --device cpu

Runs on CUDA unless ``--device`` names another device.  Full configs
run at their full width on one card; ``--reduced`` runs the smoke-scale
variant.  Checkpoints/restarts, async saves, straggler monitoring and
gradient compression are all flags.  ``--mesh`` (sharded training over
a device mesh) is not ported yet.  The VLM and enc-dec stub inputs are
drawn from a ``torch.Generator`` seeded by the step.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.data.pipeline import TokenPipeline
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
                    help="e.g. '4,2' => (data=4, model=2): not ported yet")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP Queue 1, item 12c: sharded "
            "LM training)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
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
    trainer = Trainer(model, opt, pipe, tcfg, extra_batch=extra)
    trainer.run()
    for row in trainer.history:
        print(",".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()))
    return trainer


if __name__ == "__main__":
    main()
