"""Small stand-ins of the benchmark's cells for the CPU tests: the cells'
configurations at small widths, and traffic mixes of their kinds."""
from __future__ import annotations

import copy

from portbench.harness import spec as SP

#: limits for ``config(ffn=2048)`` under ``decode_traffic(sessions=8)`` and
#: ``prefill_traffic()``, between their program's readings and their
#: control's (the cells' own limits are in ``checks/<workload>.json``)
TINY = {kind: {"kv_rel": 0.03, "set_gap": 0.12, "logit_rel": 0.04,
               "logit_gap": 0.1}
        for kind in ("decode", "prefill")}


def checks(kind: str, limits: bool = True) -> dict:
    """The comparison's sample (and limits) for the small cells."""
    out = {"sample": 8, "logit_steps": 2, "logit_positions": 4}
    if limits:
        out["limits"] = TINY[kind]
    return out


def config(name: str = "qwen2.5-14b-2l-bf16", **over) -> dict:
    """A cell's configuration at d 256, heads 8 (kv 2) x 32, f 512, vocab
    512, 2 layers, predictor rank 16."""
    cfg = SP.config(SP.benchmark(), name)
    cfg.update(layers=2, d=256, heads=8, kv_heads=2, head_dim=32, ffn=512,
               vocab=512)
    cfg["m2"] = dict(cfg["m2"], predictor_rank=16)
    cfg.update(over)
    return cfg


def decode_traffic(**over) -> dict:
    t = copy.deepcopy(SP.traffic("decode-192x32k"))
    t.update(sessions=4, history=96, slots=128, reset_to=96)
    t.update(over)
    return t


def prefill_traffic(**over) -> dict:
    t = copy.deepcopy(SP.traffic("prefill-512-4k"))
    t.update(min_tokens=16, max_tokens=64, sizes=4)
    t.update(over)
    return t
