"""Divergence-acceptance metrics: quantized-KV runs vs a full-precision
reference (``repro/eval/divergence.py``).

Mixed-precision KV tiers (``serving/kv_cache.py``) trade byte-identity
for capacity and transfer bytes, so "the tokens match" stops being the
contract. This module defines what replaces it:

* **per-step logit error** — max/mean absolute difference between the
  reference and test logits at each decode step;
* **top-k overlap** — ``|top-k(ref) ∩ top-k(test)| / k`` per step. The
  serving acceptance gate is its mean (``benchmarks/serving_mixedprec.py``
  holds top-5 overlap ≥ 0.95);
* **first-token-divergence position** — the first decode step where the
  greedy argmax differs (-1 = never), plus the overall token match rate.

:func:`kv_divergence_probe` measures all three for a given tier
precision without running the serving stack: it prefills a prompt twice,
round-trips one cache's KV through ``kv_quantize_payload`` /
``kv_dequantize_payload`` (exactly what a demotion to a quantized tier
followed by promotion does — or a cold prefix restore, the worst case:
the *whole* prefix was stored quantized), then teacher-forces both
caches through the same greedy reference continuation and compares
logits step by step. Teacher-forcing keeps the comparison well-defined
past the first divergent token — free-running logits legitimately
diverge once the inputs differ.

The model computes on the card unless the caller asks for the CPU: the
prefill runs the whole-prompt attention kernel, each decode step
``flash_decode`` and the sparse FFN's qmatmul. The tier codec is numpy on
the host, as in the reference, so the round trip copies the cache to the
host and back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kv_payload as KP
from repro_torch.core import quantize as Q
from repro_torch.models import transformer as T


@dataclasses.dataclass
class DivergenceReport:
    """Per-run divergence of a test decode vs its reference."""
    steps: int
    k: int
    max_abs_diff: float            # worst per-step logit |ref - test|
    mean_abs_diff: float
    topk_overlap_mean: float
    topk_overlap_min: float
    first_token_divergence: int    # first greedy mismatch step; -1 = never
    token_match_rate: float

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def topk_overlap(ref: np.ndarray, test: np.ndarray, k: int = 5) -> float:
    """``|top-k(ref) ∩ top-k(test)| / k`` for one logit vector each."""
    a = np.argsort(np.asarray(ref, np.float32))[-k:]
    b = np.argsort(np.asarray(test, np.float32))[-k:]
    return len(set(a.tolist()) & set(b.tolist())) / float(k)


def first_divergence(ref_tokens: Sequence[int],
                     test_tokens: Sequence[int]) -> int:
    """Index of the first differing token (-1 = identical; a length
    mismatch diverges at the shorter length)."""
    n = min(len(ref_tokens), len(test_tokens))
    for i in range(n):
        if int(ref_tokens[i]) != int(test_tokens[i]):
            return i
    return -1 if len(ref_tokens) == len(test_tokens) else n


def compare_logits(ref_logits: Sequence[np.ndarray],
                   test_logits: Sequence[np.ndarray],
                   k: int = 5) -> DivergenceReport:
    """Fold per-step logit pairs into a :class:`DivergenceReport`.

    Token-level fields are derived from the greedy argmax of each side's
    logits at every step."""
    assert len(ref_logits) == len(test_logits)
    diffs, overlaps = [], []
    ref_toks, test_toks = [], []
    for r, t in zip(ref_logits, test_logits):
        r = np.asarray(r, np.float32).ravel()
        t = np.asarray(t, np.float32).ravel()
        diffs.append(np.abs(r - t))
        overlaps.append(topk_overlap(r, t, k))
        ref_toks.append(int(np.argmax(r)))
        test_toks.append(int(np.argmax(t)))
    steps = len(diffs)
    matches = sum(a == b for a, b in zip(ref_toks, test_toks))
    return DivergenceReport(
        steps=steps, k=k,
        max_abs_diff=float(max((d.max() for d in diffs), default=0.0)),
        mean_abs_diff=float(np.mean([d.mean() for d in diffs]))
        if diffs else 0.0,
        topk_overlap_mean=float(np.mean(overlaps)) if overlaps else 1.0,
        topk_overlap_min=float(min(overlaps, default=1.0)),
        first_token_divergence=first_divergence(ref_toks, test_toks),
        token_match_rate=matches / steps if steps else 1.0)


def _roundtrip_kv(cache, precision: str):
    """Quantize→dequantize every stored KV position of a cache, in place —
    the numeric effect of the whole prefix having lived on a quantized
    tier."""
    pos = int(cache["pos"])
    if pos == 0 or precision in (None, "fp16"):
        return cache
    payload = KP.extract(cache, 0, pos)
    payload = Q.kv_dequantize_payload(
        Q.kv_quantize_payload(payload, precision))
    return KP.inject(cache, payload, 0)


def _fork(cache):
    """A copy of the cache whose tensors share no storage with it."""
    return {"pattern": [{n: t.clone() for n, t in layer.items()}
                        for layer in cache["pattern"]],
            "remainder": list(cache["remainder"]), "pos": cache["pos"]}


@torch.no_grad()
def kv_divergence_probe(cfg, params, prompt: Sequence[int],
                        gen_len: int = 8, precision: str = "int4",
                        k: int = 5, max_seq: Optional[int] = None,
                        dtype=torch.float32, device=None
                        ) -> DivergenceReport:
    """Measure decode divergence caused by one KV storage precision.

    Prefills ``prompt`` at full precision, forks the cache, round-trips
    the fork's KV through the tier codec at ``precision``, then decodes
    ``gen_len`` greedy reference tokens teacher-forced through both
    caches, comparing each step's logits. ``device`` (default ``cuda``)
    is where the model computes; ``params`` must live there."""
    device = resolve_device(device)
    have = params["embed"].device
    if have.type != device.type:
        raise ValueError(f"params live on {have}, the probe asked for "
                         f"{device}")
    prompt = torch.as_tensor(np.asarray(prompt, np.int64),
                             device=device)[None]
    if max_seq is None:
        max_seq = prompt.shape[1] + gen_len + 1

    def step(cache, tokens, mode):
        logits, cache, _ = T.forward(cfg, params, tokens, cache=cache,
                                     mode=mode, m2=True)
        return logits[0, -1, :], cache

    cache_ref = T.init_cache(cfg, 1, max_seq, dtype=dtype, device=device)
    last_ref, cache_ref = step(cache_ref, prompt, "prefill")
    cache_q = _roundtrip_kv(_fork(cache_ref), precision)
    # prefill logits predate the quantization and are identical on both
    # sides; the compared steps are the gen_len decodes that *read* the
    # quantized prefix
    ref_logits: List[np.ndarray] = []
    test_logits: List[np.ndarray] = []
    for _ in range(gen_len):
        tok = torch.argmax(last_ref).reshape(1, 1)     # teacher-forced
        last_ref, cache_ref = step(cache_ref, tok, "decode")
        last_q, cache_q = step(cache_q, tok, "decode")
        ref_logits.append(last_ref.float().cpu().numpy())
        test_logits.append(last_q.float().cpu().numpy())
    return compare_logits(ref_logits, test_logits, k=k)
