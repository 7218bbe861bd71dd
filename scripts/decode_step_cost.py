#!/usr/bin/env python3
"""The decode step's attention in one tree of the port, on one GPU, so that
two trees (this checkout and an unpacked ``git archive`` of another commit)
can be compared in one call on the same card:

    python3 scripts/decode_step_cost.py --src SRC_DIR

SRC_DIR is the tree's ``src`` directory; its kernels build into that tree's
``build/kernels``. Prints one JSON line: the card's name and power limit,
the device ms per ``flash_decode`` call (torch.profiler) and the CUDA
kernels per call at each of chip_smoke.py's flash_decode rows (serve
decode, a server decode batch, 4 rows of 4 K slots, one row of 32 K), and
one ``forward(mode="decode")`` of qwen2.5-14b at full width, depth cut to
4 layers, for launch/serve's batch and for the server's rows
(chip_smoke.decode_forward_cost: kernels launched, host ms, wall ms). Run
the trees in turns (e.g. parent, change, change, parent). Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the tree to measure")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import transformer as T
    build.build_all()
    dev = torch.device("cuda")
    full = get_config("qwen2.5-14b")
    cfg = dataclasses.replace(full, num_layers=cs.FULL_LAYERS)
    hkv, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // hkv
    g = torch.Generator(device=dev).manual_seed(1234)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    kernel = {}
    for name, (S, lengths) in cs.DECODE_ROWS.items():
        q, k, v, slots, ln = cs.decode_inputs(randn, dev, S, hkv, G, D, lengths,
                                              holes=name == "flash_decode")
        prof = cs.device_profile(lambda: flash_decode(q, k, v, slots, ln))
        kernel[name] = {"device_ms": prof.get("device_ms"),
                        "kernels_per_call": prof.get("kernels_per_call"),
                        "top_kernels_ms": prof.get("top_kernels_ms")}
        del q, k, v
    params = T.init_params(cfg, seed=0, device="cuda")
    cs.draw_pred_a(params, torch.Generator(device="cuda").manual_seed(1),
                   "cuda")
    forward = {
        "full": cs.decode_forward_cost(cfg, params, [136] * 4, 145,
                                       rows=False),
        "server_full": cs.decode_forward_cost(cfg, params,
                                              cs.SERVER_DECODE_LENGTHS,
                                              cs.SERVER_BUCKET, rows=True)}
    for f in forward.values():
        f.pop("most_launched")
    cs.log({"src": str(src), "nvidia_smi": cs.nvidia_smi(),
            "flash_decode": kernel, "decode_forward": forward})


if __name__ == "__main__":
    main()
