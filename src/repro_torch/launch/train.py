"""Training launcher (``repro/launch/train.py``'s flags, plus ``--device``).

On the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b --tiny \
      --steps 100 --batch 8 --seq 128

On the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b --tiny \
      --steps 20 --batch 4 --seq 64 --device cpu --save ckpt --history h.json

``--save`` writes a checkpoint in the reference's format
(``training/checkpoint.py``): ``repro.training.checkpoint.load`` reads it.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--history", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    """Train as the arguments say; returns the history."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, tiny=args.tiny)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    params, opt_state, history = train(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        opt_cfg=opt, seed=args.seed, device=device)
    if args.save:
        checkpoint.save(args.save, params, opt_state,
                        {"arch": args.arch, "tiny": args.tiny,
                         "steps": args.steps}, cfg=cfg)
        print(f"saved checkpoint to {args.save}")
    if args.history:
        with open(args.history, "w") as f:
            json.dump(history, f, indent=1)
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"(start {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
