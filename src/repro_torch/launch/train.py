"""Training launcher: single-device training on synthetic data, with
checkpointing. Port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \
        --steps 100 --batch 2 --seq 1024 --ckpt ckpt/gemma2

Prints one JSON line per logged step, then the final loss.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import lm_batches
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    data = lm_batches(cfg, args.batch, args.seq, seed=args.seed)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                      total_steps=args.steps)

    def log(step, m):
        print(json.dumps({"step": step, **m}), flush=True)

    state, history = train(
        cfg, opt, data, args.steps,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        callback=log, device=dev)
    if args.ckpt:
        ckpt.save(args.ckpt, state, step=args.steps,
                  meta={"arch": cfg.arch_id})
        print(f"checkpoint saved to {args.ckpt}")
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"(from {history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
