"""Batched serving from the command line: prefill a batch of prompts,
decode N tokens.

  PYTHONPATH=src python -m repro_torch.lm.launch.serve --arch minitron-4b
  PYTHONPATH=src python -m repro_torch.lm.launch.serve --arch xlstm-125m \
      --reduced --device cpu --batch 4 --prompt-len 16 --gen 8

Runs on CUDA unless ``--device`` names another device; weights and
inputs are drawn from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.lm.configs import get_config
from repro_torch.lm.models.model import Model


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params, _ = model.init(gen)

    B, S = args.batch, args.prompt_len
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    batch = {"tokens": toks}
    prefix = 0
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen, device=dev)
        prefix = cfg.n_patches
    if cfg.family == "enc_dec":
        batch["frames"] = torch.randn(
            (B, cfg.encoder.n_frames, cfg.d_model), generator=gen, device=dev)

    max_len = prefix + S + args.gen
    caches = model.init_cache(B, max_len)

    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(args.gen):
        out_tokens.append(tok[:, 0])
        logits, caches = model.decode_step(params, tok, caches, prefix + S + i)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1].float() / args.temperature, -1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen_ids = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={B} prompt={S} gen={args.gen}")
    print(f"prefill_s={t_prefill:.3f} decode_s={t_decode:.3f} "
          f"tok_per_s={B * args.gen / max(t_decode, 1e-9):.1f}")
    for b in range(min(B, 2)):
        print(f"sample[{b}] generated ids: {np.asarray(gen_ids[b]).tolist()}")


if __name__ == "__main__":
    main()
