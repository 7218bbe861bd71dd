"""Deja-Vu-style low-rank active-neuron predictor (``repro/core/
predictor.py``): the serving half (scores, the batch-shared top-k) and the
offline half (the ground-truth magnitudes, fitting A and B to them, recall).

score(x) = x @ A @ B   with A: (d, r), B: (r, f), r << d.

The offline functions take the FFN's gate and up weights in the
reference's (d, f) layout; a caller holding the port's neuron-major banks
passes ``banks["wg_fp"].T``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import activation, reduced


def predictor_scores(x, A, B):
    """x: (..., d) -> scores (..., f) in fp32 (on a mesh the rank-r
    activations' sums are reduced before the second product, as GSPMD
    does)."""
    h = reduced(torch.einsum("...d,dr->...r", x.float(), A.float()))
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


def true_neuron_magnitude(x, wg, wu, act_name: str):
    """Ground-truth importance: |act(x Wg) * (x Wu)| per neuron (fp32)."""
    h = activation(act_name)(torch.einsum("...d,df->...f", x.float(),
                                          wg.float()))
    return torch.abs(h * torch.einsum("...d,df->...f", x.float(), wu.float()))


def topk_mask(scores, k: int):
    """Boolean mask of the top-k scoring neurons along the last axis, k
    clipped to [1, f], in :func:`top_k`'s order (which of tied scores are
    in). scores: (f,) or (..., f)."""
    k = min(max(k, 1), scores.shape[-1])
    idx = top_k(scores, k)[1]
    return torch.zeros(scores.shape, dtype=torch.bool,
                       device=scores.device).scatter_(-1, idx, True)


def init_predictor(d: int, f: int, rank: int, *, generator: torch.Generator):
    """(A (d, rank), B (rank, f)) in fp32: standard normal draws from
    ``generator`` (on its device) scaled by 1/sqrt(d) and 1/sqrt(rank), as the
    reference scales its ``jax.random`` draws (:62-66)."""
    dev = generator.device
    A = torch.randn((d, rank), generator=generator, device=dev) / math.sqrt(d)
    B = torch.randn((rank, f), generator=generator,
                    device=dev) / math.sqrt(rank)
    return A, B


def train_predictor(xs, wg, wu, *, act_name: str, A0, B0, steps: int = 200,
                    lr: float = 1e-2):
    """Fit (A, B) to the true neuron magnitudes of sample inputs ``xs``
    (N, d), normalised by their mean + 1e-8, by the mean squared error and
    momentum SGD (m = 0.9 m + g, p -= lr m) for ``steps`` steps from (A0,
    B0), as the reference's ``lax.scan`` (:69-99). Returns (A, B, the loss
    of the last step, taken before its update), as it does."""
    with torch.no_grad():
        target = true_neuron_magnitude(xs, wg, wu, act_name)
        target = target / (target.mean() + 1e-8)
    A, B = A0.detach().clone(), B0.detach().clone()
    mA, mB = torch.zeros_like(A), torch.zeros_like(B)
    loss = None
    for _ in range(steps):
        A.requires_grad_(True)
        B.requires_grad_(True)
        loss = torch.mean((predictor_scores(xs, A, B) - target) ** 2)
        gA, gB = torch.autograd.grad(loss, (A, B))
        with torch.no_grad():
            mA = 0.9 * mA + gA
            mB = 0.9 * mB + gB
            A = A.detach() - lr * mA
            B = B.detach() - lr * mB
    return A, B, loss.detach()


def predictor_recall(A, B, xs, wg, wu, *, act_name: str, k: int):
    """Mean over the samples of the fraction of the true top-k neurons that
    the predictor's top-k recovers (:102-112), a 0-d fp32 tensor."""
    with torch.no_grad():
        true_mask = topk_mask(true_neuron_magnitude(xs, wg, wu, act_name), k)
        pred_mask = topk_mask(predictor_scores(xs, A, B), k)
        return ((true_mask & pred_mask).sum(-1) / k).float().mean()
