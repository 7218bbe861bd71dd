"""Griffin / RecurrentGemma RG-LRU recurrent block [arXiv:2402.19427]
(``repro/models/hybrid.py``).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * r_t * softplus(Lambda)),  r_t, i_t gates from the input.

The reference computes a prompt's recurrence with ``jax.lax.
associative_scan``; the port takes a Hillis-Steele scan over the sequence
axis: log2(S) steps of elementwise products and sums, whose plan depends on
S alone (so a row's bits do not depend on the rows beside it). Both are
exact up to fp32 rounding in another order. Decode is a single-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (_gelu_tanh, causal_conv1d, constrain,
                                       each_row, model_idle_data, shard_on,
                                       sigmoid)

_C = 8.0  # recurrence-gate temperature from the Griffin paper


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, as a
    Hillis-Steele scan of the pairs (a, b) under (a1, b1) then (a2, b2) ->
    (a1 * a2, a2 * b1 + b2). Returns h (the scanned b)."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def rg_lru(x, r, i, lam, h0=None):
    """x, r, i: (B, S, W) ; lam: (W,). Returns (h_seq, h_final)."""
    log_a = -_C * r * F.softplus(lam.float())          # (B, S, W) fp32
    a = torch.exp(log_a)
    gated = (i * x).float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated

    if x.shape[1] == 1 and h0 is not None:  # decode fast path
        h = a[:, 0] * h0.float() + b[:, 0]
        return h[:, None].to(x.dtype), h.to(x.dtype)

    if h0 is not None:
        # fold the initial state in as a virtual step: h_0 contributes
        # a-decayed
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.float()[:, None], b], dim=1)

    h_seq = linear_scan(a, b)
    if h0 is not None:
        h_seq = h_seq[:, 1:]
    return h_seq.to(x.dtype), h_seq[:, -1].to(x.dtype)


def rglru_block(cfg, p, x, state, *, rows: bool = False, policy=None):
    """Griffin recurrent block. x: (B, S, d).

    state: {'h': (B, W), 'conv': (B, cw-1, W)} or None. Returns (y,
    new_state). ``rows``: the batch rows are separate requests, and the
    five products run one row at a time (``each_row``); the rest is
    elementwise along each row. ``policy``: the conv's output is made
    replicated over "model" (a no-op on plain tensors), so that the gate
    products ``w_a`` and ``w_i`` come out sharded on their columns as
    their biases are, not as partial sums: a partial sum plus a sharded
    bias needs a redistribution from a shard to a partial sum, which
    DTensor has not got."""
    def dense(w, t):
        return each_row(lambda tr: tr @ w, t) if rows else t @ w

    y_branch = _gelu_tanh(dense(p["w_y"], x))
    xb = dense(p["w_x"], x)
    conv_state = None if state is None else state["conv"]
    # a one-row step on a one-device "model" dim: the conv's channels on
    # the idle "data" dim, as GSPMD places them
    xb = shard_on(xb, model_idle_data(x), -1)
    xb, new_conv = causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)
    xb = constrain(xb, policy, ("pod", "data"), None, None)

    r = sigmoid(dense(p["w_a"], xb) + p["b_a"])
    i = sigmoid(dense(p["w_i"], xb) + p["b_i"])
    h0 = None if state is None else state["h"]
    h_seq, h_fin = rg_lru(xb, r.to(xb.dtype), i.to(xb.dtype), p["lam"], h0)

    out = dense(p["w_out"], y_branch * h_seq)
    new_state = ({"h": h_fin, "conv": new_conv}
                 if state is not None else None)
    return out, new_state
