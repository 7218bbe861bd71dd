"""Deja-Vu-style low-rank active-neuron predictor, serving half
(``repro/core/predictor.py:22-58``).

score(x) = x @ A @ B   with A: (d, r), B: (r, f), r << d.
"""
from __future__ import annotations

import torch


def predictor_scores(x, A, B):
    """x: (..., d) -> scores (..., f) in fp32."""
    h = torch.einsum("...d,dr->...r", x.float(), A.float())
    return torch.einsum("...r,rf->...f", h, B.float())


def shared_topk_indices(scores, k: int):
    """Batch-shared active set: sum scores over leading dims, take top-k.

    Returns indices by descending score, ties broken by the lowest index —
    the order ``jax.lax.top_k`` gives. ``torch.topk`` promises no tie order,
    so a stable descending sort is sliced instead. Rank decides each
    neuron's precision tier, so the order matters, not only the set.
    """
    flat = scores.reshape(-1, scores.shape[-1]).sum(dim=0)
    return torch.sort(flat, descending=True, stable=True).indices[:k]
