"""Mixture-of-Experts FFN with GShard-style capacity dispatch
(``repro/models/moe.py``).

Tokens are dispatched within their batch row (group): a choice's position
in its expert comes from a cumsum over the row's own ``S * k`` choices, so
capacity is per row, as in GShard/Switch. A choice at or past the capacity
``C`` is dropped: it reaches no expert and adds nothing to the output. The
drops are part of the result and match the reference's exactly.

The reference's mesh ``policy`` (a ``shard_map`` over the batch axes) is
TPU-mesh tooling and is not ported: the port runs on one card.
"""
from __future__ import annotations

import torch

from repro_torch.core.predictor import top_k
from repro_torch.models.common import activation, glu_ffn


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert and row, computed in Python as the reference does."""
    return max(int(S * k / E * capacity_factor), 1)


def route(x, router_w, *, E: int, k: int, capacity_factor: float):
    """The router of ``x`` (B, S, d): fp32 logits (B, S, E); each token's
    k experts in ``jax.lax.top_k``'s order (top-k of the logits, then a
    softmax of the k; for k = 1 the softmax first, then the top one); each
    choice's position in its expert's slots, counted over the row's
    ``S * k`` choices in order; and whether it is kept (position < C).
    Returns (logits, gate values (B, S, k), experts (B, S, k), positions
    (B, S*k), keep (B, S*k), C)."""
    B, S, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    if k == 1:
        gate_vals, expert_idx = top_k(torch.softmax(logits, dim=-1), 1)
    else:
        top_logits, expert_idx = top_k(logits, k)
        gate_vals = torch.softmax(top_logits, dim=-1)
    C = capacity(S, k, E, capacity_factor)
    flat_e = expert_idx.reshape(B, S * k)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos_excl = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_excl, 2, flat_e[..., None])[..., 0]
    return logits, gate_vals, expert_idx, pos, pos < C, C


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, num_experts_per_tok: int,
            capacity_factor: float, act_name: str, shared=None):
    """x: (B, S, d). w_gate/w_up: (E, d, f); w_down: (E, f, d). ``shared``:
    (gate, up, down) of an always-on shared expert (llama4), or None.

    Returns (y, aux) with the router's load-balance loss (``lb_loss``) and
    the fraction of choices dropped (``dropped_frac``).

    Dispatch writes each kept choice into its own (row, expert, slot) of a
    (B, E, C, d) buffer, targets all distinct, so the result does not depend
    on the order of the writes; dropped choices go to a spare row that is
    never read. The reference scatter-adds into zeros (dropped choices add
    a zero source at slot (0, 0)): every slot holds 0.0 + its one kept
    value, so the port adds 0.0 too (a -0.0 becomes +0.0). The expert
    products run over all E experts, as the reference's einsums do."""
    B, S, d = x.shape
    E = w_gate.shape[0]
    k = num_experts_per_tok
    logits, gate_vals, expert_idx, pos, keep, C = route(
        x, router_w, E=E, k=k, capacity_factor=capacity_factor)

    # ---- dispatch: each kept choice to its own slot of (B, E, C, d)
    flat_e = expert_idx.reshape(B, S * k)
    rows = torch.arange(B, device=x.device)[:, None]
    target = (rows * E + flat_e) * C + pos
    spare = B * E * C
    src = torch.repeat_interleave(x, k, dim=1) + 0.0     # (B, S*k, d)
    slots = x.new_zeros((spare + 1, d))
    slots.index_copy_(0, torch.where(keep, target, spare).reshape(-1),
                      src.reshape(-1, d))
    buf = slots[:spare].view(B, E, C, d)

    # ---- expert compute over all E experts
    act = activation(act_name)
    h = act(torch.einsum("becd,edf->becf", buf, w_gate))
    h = h * torch.einsum("becd,edf->becf", buf, w_up)
    out_buf = torch.einsum("becf,efd->becd", h, w_down)   # (B, E, C, d)

    # ---- combine: a dropped choice reads slot (0, 0) and is masked to 0
    read = torch.where(keep, target, rows * E * C)
    gathered = out_buf.reshape(B * E * C, d)[read.reshape(-1)].view(B, S * k, d)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * gate_vals.reshape(B, S * k, 1).to(gathered.dtype)
    y = weighted.reshape(B, S, k, d).sum(dim=2)

    if shared is not None:                 # llama4's always-on shared expert
        sw_gate, sw_up, sw_down = shared
        y = y + glu_ffn(x, sw_gate, sw_up, sw_down, act_name)

    # ---- router aux (Switch-style load-balance terms)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(
        expert_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    aux = {"lb_loss": lb_loss,
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux
