"""Offline uncertainty-guided neuron-ratio search — paper Algorithm 1
(``repro/core/ratio_search.py``).

Given a fixed weight-memory budget, sweep (r_fp16, r_int8, r_int4) splits of
the active-neuron set; for each candidate run greedy decoding on calibration
prompts and score the *decoding uncertainty*

    UQEst = - sum_{i>j} sum_k p_k^i log p_k^i        (paper Eq. 2)

(total predictive entropy over generated positions). The ratio minimising
UQEst wins. Each candidate's decoding runs ``models.transformer.forward``
with ``m2=True``: on the card its FFN goes through the qmatmul kernels, its
prompt through ``flash_attention`` and its steps through ``flash_decode``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.models import transformer as T


def uq_est(cfg, params, prompts, *, gen_len: int = 16, m2: bool = True):
    """Decoding-uncertainty score for one model configuration.

    prompts: (B, S) integer ids (a tensor or an array). Greedy-decodes
    ``gen_len`` tokens (argmax, the first index on ties) from a prefill of
    the prompts, the batch sharing each layer's active set, and sums the
    fp32 entropy of every generation step's distribution (lower = more
    confident). Runs ``gen_len`` decode forwards, as the reference's scan,
    whose last logits no entropy reads."""
    device = params["embed"].device
    prompts = torch.as_tensor(prompts, device=device)
    B, S = prompts.shape
    cache = T.init_cache(cfg, B, S + gen_len + 1, device=device)
    logits, cache, _ = T.forward(cfg, params, prompts, cache=cache,
                                 mode="prefill", m2=m2)
    last = logits[:, -1]
    ents = []
    for _ in range(gen_len):
        probs = torch.softmax(last.float(), dim=-1)
        ents.append(-(probs * torch.log(probs + 1e-20)).sum(dim=-1))
        nxt = torch.argmax(last, dim=-1)[:, None]
        logits, cache, _ = T.forward(cfg, params, nxt, cache=cache,
                                     mode="decode", m2=m2)
        last = logits[:, 0]
    return float(torch.stack(ents).sum())


def candidate_ratios(step: float = 0.25,
                     bit_ratio: int = 4) -> List[Tuple[float, float, float]]:
    """Enumerate (fp16, int8, int4) splits along Algorithm 1's search line:
    start all-int4, repeatedly move ``step`` of the set to fp16 (each fp16
    neuron costs ``bit_ratio`` int4 neurons of budget), then the uniform
    corners for Fig. 10's comparison; duplicates dropped."""
    out = []
    r16 = 0.0
    while r16 <= 0.5 + 1e-9:
        r8 = min(0.25, 1.0 - r16)
        r4 = max(1.0 - r16 - r8, 0.0)
        out.append((round(r16, 3), round(r8, 3), round(r4, 3)))
        r16 += step / 2
    out += [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
    return list(dict.fromkeys(out))


def memory_cost(cfg, ratios: Tuple[float, float, float]) -> float:
    """Relative HBM cost of the active set under a precision split
    (fp16 = 1.0 per neuron)."""
    r16, r8, r4 = ratios
    return cfg.m2_active_ratio * (r16 * 1.0 + r8 * 0.5 + r4 * 0.25)


@dataclasses.dataclass
class SearchResult:
    best_ratio: Tuple[float, float, float]
    best_uq: float
    table: List[dict]


def search(cfg, params, prompts, *, memory_budget: float,
           gen_len: int = 12) -> SearchResult:
    """Algorithm 1: scan the ratio line, keep the best UQEst under budget.

    ``memory_budget`` is the allowed active-set HBM cost relative to a
    full-precision dense FFN. ``params`` are M2Cache params (with banks);
    each candidate runs on the config rebuilt with its ratios. A candidate
    over the budget is not decoded: its ``uq`` is inf."""
    table = []
    best = (None, float("inf"))
    for r16, r8, r4 in candidate_ratios():
        cand_cfg = dataclasses.replace(
            cfg, m2_ratio_fp16=r16, m2_ratio_int8=r8, m2_ratio_int4=r4)
        cost = memory_cost(cand_cfg, (r16, r8, r4))
        feasible = cost <= memory_budget + 1e-9
        uq = uq_est(cand_cfg, params, prompts, gen_len=gen_len) \
            if feasible else float("inf")
        table.append({"ratio": (r16, r8, r4), "mem_cost": cost,
                      "feasible": feasible, "uq": uq})
        if feasible and uq < best[1]:
            best = ((r16, r8, r4), uq)
    return SearchResult(best_ratio=best[0], best_uq=best[1], table=table)
