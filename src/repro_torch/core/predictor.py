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


def top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: (values, indices) of the k
    largest, in descending order, ties broken by the lowest index.

    ``torch.topk`` promises no tie order, so a stable descending sort is
    sliced instead, and it runs on a total-order key of the float's bits
    (``b`` where ``b >= 0``, else ``b ^ 0x7FFFFFFF``), as ``jax.lax.top_k``
    orders: +0.0 above -0.0, +NaN above +inf and -NaN below -inf, each NaN
    by its payload. A float sort would hold the zeros equal."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def shared_topk_indices(scores, k: int):
    """Batch-shared active set: sum scores over leading dims, take top-k
    (:func:`top_k`'s order). Rank decides each neuron's precision tier, so
    the order matters, not only the set.

    One row is taken as it is: XLA drops a sum over a length-1 axis, so the
    reference keeps a -0.0 there, where a sum would make it +0.0. Over more
    rows both sums start from +0.0, and a column of zeros sums to +0.0.
    """
    flat = scores.reshape(-1, scores.shape[-1])
    flat = flat[0] if flat.shape[0] == 1 else flat.sum(dim=0)
    return top_k(flat.float(), k)[1]
