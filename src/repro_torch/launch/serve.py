"""Serving launcher — M2Cache engine or ZeRO-Inference baseline, on the card.

Real tiny model on the GPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
      --tiny --gen-len 16 --batch 2

The same on the CPU (plain PyTorch versions of the kernels), for any
served config (``configs.base.SERVED``: the dense qwen2.5-14b, qwen2.5-32b,
command-r-35b, mistral-large-123b, internvl2-1b, the MoE grok-1-314b and
llama4-maverick-400b-a17b, whose routers start at zero as the reference's
do, the hybrid recurrentgemma-2b and the SSM mamba2-370m; musicgen-large
runs through ``models.transformer.forward`` only):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-large-123b \
      --tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
      --tiny --device cpu --gen-len 4 --batch 2 --dram-gb 0.5

Paper-scale analytic mode (LLaMA geometry, modeled clock):
  PYTHONPATH=src python -m repro_torch.launch.serve --paper-model llama-13b \
      --mode zero_infinity --gen-len 32
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SERVED, check_served, get_config
from repro_torch.core.engine import (PAPER_MODELS, GenerationResult,
                                     M2CacheEngine)
from repro_torch.models import transformer as T


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="a config the port serves: " + ", ".join(SERVED))
    ap.add_argument("--paper-model", default=None,
                    choices=list(PAPER_MODELS) + [None])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mode", default="m2cache",
                    choices=["m2cache", "zero_infinity"])
    ap.add_argument("--hbm-policy", default="atu",
                    choices=["atu", "lru", "none"])
    ap.add_argument("--no-ssd", action="store_true")
    ap.add_argument("--dram-gb", type=float, default=4.0)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def make_prompts(cfg, batch: int, prompt_len: int, seed: int):
    """Prompt token ids (numpy int64) from a seeded CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen).numpy()


def run(args: argparse.Namespace, *, cfg=None, params=None,
        ssd_dir: Optional[str] = None
        ) -> Tuple[dict, GenerationResult, M2CacheEngine]:
    """Build the engine the arguments describe and generate once.

    ``cfg`` and ``params`` override the config and the seeded weights (the
    params must live on ``args.device``); ``ssd_dir`` keeps the SSD tier's
    bank files in a directory the caller owns. Returns the printed summary,
    the generation result and the engine."""
    device = resolve_device(args.device)
    if args.paper_model:
        eng = M2CacheEngine(paper_model=args.paper_model, mode=args.mode,
                            hbm_policy=args.hbm_policy,
                            use_ssd=not args.no_ssd, ssd_dir=ssd_dir,
                            dram_capacity_gb=args.dram_gb, seed=args.seed)
        res = eng.generate(gen_len=args.gen_len)
    else:
        cfg = cfg if cfg is not None else get_config(args.arch, tiny=args.tiny)
        check_served(cfg)
        if params is None:
            params = T.init_params(cfg, seed=args.seed, device=device)
        eng = M2CacheEngine(cfg=cfg, params=params, mode=args.mode,
                            hbm_policy=args.hbm_policy,
                            use_ssd=not args.no_ssd, ssd_dir=ssd_dir,
                            dram_capacity_gb=args.dram_gb, seed=args.seed,
                            device=device)
        prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed)
        res = eng.generate(prompts, gen_len=args.gen_len)
    summary = {
        "tokens_per_s_modeled": res.tokens_per_s,
        "modeled_s": res.modeled_s,
        "wall_s": res.wall_s,
        "cache": res.cache_stats,
        "carbon_g": res.carbon,
    }
    return summary, res, eng


def main(argv=None):
    args = build_parser().parse_args(argv)
    summary, _, _ = run(args)
    print(json.dumps(summary, indent=1, default=float))


if __name__ == "__main__":
    main()
