"""Mixture-of-Experts FFN with GShard-style capacity dispatch
(``repro/models/moe.py``).

Tokens are dispatched within their batch row (group): a choice's position
in its expert comes from a cumsum over the row's own ``S * k`` choices, so
capacity is per row, as in GShard/Switch. A choice at or past the capacity
``C`` is dropped: it reaches no expert and adds nothing to the output. The
drops are part of the result and match the reference's exactly.

With a mesh ``policy``, dispatch and combine run under ``local_map``
over the batch axes that shard the rows (the reference's ``shard_map``;
replicated where none divides the batch), so their data-dependent indexing
stays local to each shard; on plain tensors, or without a policy, they run
on the whole tensor, and the bits are the same.
"""
from __future__ import annotations

import torch

from repro_torch.core.predictor import top_k
from repro_torch.models.common import activation, glu_ffn, reduced


def _batch_axes(policy, B: int) -> tuple:
    """Mesh axes the batch dim is actually sharded over (divisibility-checked,
    moe.py:20-31)."""
    if policy is None:
        return ()
    axes = []
    size = 1
    for a in ("pod", "data"):
        ext = getattr(policy.axes, a)
        if ext > 1 and B % (size * ext) == 0:
            axes.append(a)
            size *= ext
    return tuple(axes)


def _targets(flat_e, pos, E: int, C: int):
    """Each choice's flat slot in its rows' (B, E, C) buffer."""
    rows = torch.arange(flat_e.shape[0], device=flat_e.device)[:, None]
    return (rows * E + flat_e) * C + pos, rows


def _dispatch(src, flat_e, pos, keep, E: int, C: int):
    """Each kept choice of ``src`` (B, S*k, d) to its own slot of a (B, E,
    C, d) buffer; dropped choices go to a spare slot that is never read."""
    B, _, d = src.shape
    target, _ = _targets(flat_e, pos, E, C)
    spare = B * E * C
    slots = src.new_zeros((spare + 1, d))
    slots.index_copy_(0, torch.where(keep, target, spare).reshape(-1),
                      src.reshape(-1, d))
    return slots[:spare].view(B, E, C, d)


def _combine(out_buf, flat_e, pos, keep):
    """Each choice's slot of ``out_buf`` (B, E, C, d), a dropped one 0:
    (B, S*k, d)."""
    B, E, C, d = out_buf.shape
    target, rows = _targets(flat_e, pos, E, C)
    read = torch.where(keep, target, rows * E * C)
    gathered = out_buf.reshape(B * E * C, d)[read.reshape(-1)].view(
        B, -1, d)
    return torch.where(keep[..., None], gathered, 0.0)


def _row_local(fn, policy, axes, n_in: int):
    """``fn`` under ``local_map`` with every input and the output sharded on
    dim 0 over the mesh's ``axes`` and replicated over its other dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    place = tuple(Shard(0) if n in axes else Replicate()
                  for n in policy.mesh.mesh_dim_names)
    return local_map(fn, out_placements=list(place),
                     in_placements=(place,) * n_in
                     + (None,) * (fn.__code__.co_argcount - n_in),
                     device_mesh=policy.mesh, redistribute_inputs=True)


def _experts(buf, w_gate, w_up, w_down, act_name: str):
    """The GLU experts over the dispatch buffer (B, E, C, d)."""
    act = activation(act_name)
    h = act(torch.einsum("becd,edf->becf", buf, w_gate))
    h = h * torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", h, w_down)


def _experts_local(policy, batch_axes, E: int, w_gate):
    """:func:`_experts` with each product under ``local_map``, placed as
    GSPMD places the reference's: the hidden dim f on "model" (the down
    product's output a partial sum over it); with ``expert_data_shard`` the
    experts on "data", the buffer moved there by an all-to-all; the
    buffer's rows on the batch axes, the weights gathered there (FSDP); on
    a mesh dim that holds no rows (one row) and shards the weights' d
    (FSDP), the buffer's d too: the gate and up products' sums are partial
    over it, reduced before the activation, and the down product's output
    keeps d sharded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    by_e = policy.expert_data_shard and E % policy.axes.data == 0
    # per mesh dim: (buf, w_in, h) -> h_in; (h, w_out) -> out
    buf, w_in, h_in, h, w_out, out = ([] for _ in range(6))
    for i, n in enumerate(policy.mesh.mesh_dim_names):
        if n == "model":
            place = (Replicate(), Shard(2), Shard(3), Shard(3), Shard(1),
                     Partial())
        elif n == "data" and by_e:
            place = (Shard(1), Shard(0), Shard(1), Shard(1), Shard(0),
                     Shard(1))
        elif n in batch_axes:
            place = (Shard(0), Replicate(), Shard(0), Shard(0), Replicate(),
                     Shard(0))
        elif isinstance(w_gate, DTensor) and w_gate.placements[i] == Shard(1):
            place = (Shard(3), Shard(1), Partial(), Replicate(), Shard(2),
                     Shard(3))
        else:
            place = (Replicate(),) * 6
        for lst, pl in zip((buf, w_in, h_in, h, w_out, out), place):
            lst.append(pl)
    mesh = policy.mesh
    prod_in = local_map(lambda b, w: torch.einsum("becd,edf->becf", b, w),
                        out_placements=h_in, in_placements=(buf, w_in),
                        device_mesh=mesh, redistribute_inputs=True)
    prod_out = local_map(lambda t, w: torch.einsum("becf,efd->becd", t, w),
                         out_placements=out, in_placements=(h, w_out),
                         device_mesh=mesh, redistribute_inputs=True)

    def experts(b, w_gate, w_up, w_down, act_name):
        g = activation(act_name)(reduced(prod_in(b, w_gate)))
        return prod_out(g * reduced(prod_in(b, w_up)), w_down)
    return experts


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert and row, computed in Python as the reference does."""
    return max(int(S * k / E * capacity_factor), 1)


def route(x, router_w, *, E: int, k: int, capacity_factor: float,
          policy=None):
    """The router of ``x`` (B, S, d): fp32 logits (B, S, E); each token's
    k experts in ``jax.lax.top_k``'s order (top-k of the logits, then a
    softmax of the k; for k = 1 the softmax first, then the top one); each
    choice's position in its expert's slots, counted over the row's
    ``S * k`` choices in order; and whether it is kept (position < C).
    Returns (logits, gate values (B, S, k), experts (B, S, k), positions
    (B, S*k), keep (B, S*k), C). ``policy``: the logits' product reads x
    with its features on "model", as the reference's activations come (its
    sums then reduced, and x's gradient sharded as x), under ``local_map``
    (a no-op on plain tensors)."""
    B, S, _ = x.shape

    def product(t, w):
        return torch.einsum("bsd,de->bse", t.float(), w.float())
    from torch.distributed.tensor import DTensor, Partial
    if policy is not None and isinstance(x, DTensor):
        from torch.distributed.tensor.experimental import local_map
        mesh, x_pl = policy.named(tuple(x.shape), ("pod", "data"), None,
                                  "model")
        w_pl = policy.named(tuple(router_w.shape), "model", None)[1]
        out_pl = [Partial() if n == "model" else pl
                  for n, pl in zip(mesh.mesh_dim_names, x_pl)]
        product = local_map(product, out_placements=out_pl,
                            in_placements=(x_pl, w_pl), device_mesh=mesh,
                            redistribute_inputs=True)
    logits = reduced(product(x, router_w))
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
            capacity_factor: float, act_name: str, shared=None, policy=None):
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
    products run over all E experts, as the reference's einsums do.
    ``policy``: dispatch and combine local to the batch's shards (see the
    module's docstring)."""
    B, S, d = x.shape
    E = w_gate.shape[0]
    k = num_experts_per_tok
    logits, gate_vals, expert_idx, pos, keep, C = route(
        x, router_w, E=E, k=k, capacity_factor=capacity_factor,
        policy=policy)

    # ---- dispatch: each kept choice to its own slot of (B, E, C, d)
    flat_e = expert_idx.reshape(B, S * k)
    dispatch, combine = _dispatch, _combine
    if policy is not None:
        ba = _batch_axes(policy, B)
        dispatch = _row_local(_dispatch, policy, ba, 4)
        combine = _row_local(_combine, policy, ba, 4)
    src = torch.repeat_interleave(x, k, dim=1) + 0.0     # (B, S*k, d)
    buf = dispatch(src, flat_e, pos, keep, E, C)

    # ---- expert compute over all E experts
    experts = _experts
    if policy is not None:
        experts = _experts_local(policy, ba, E, w_gate)
    out_buf = experts(buf, w_gate, w_up, w_down, act_name)   # (B, E, C, d)

    # ---- combine: a dropped choice reads slot (0, 0) and is masked to 0
    gathered = combine(out_buf, flat_e, pos, keep)
    weighted = gathered * gate_vals.reshape(B, S * k, 1).to(gathered.dtype)
    y = weighted.reshape(B, S, k, d).sum(dim=2)

    # ---- router aux (Switch-style load-balance terms)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(
        expert_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    aux = {"lb_loss": lb_loss,
           "dropped_frac": 1.0 - keep.float().mean()}

    # llama4's always-on shared expert, last: a layer's recompute in the
    # backward pass stops before its closing product, whose output the
    # backward never reads (as the reference's remat leaves it out)
    if shared is not None:
        sw_gate, sw_up, sw_down = shared
        y = y + glu_ffn(x, sw_gate, sw_up, sw_down, act_name)
    return y, aux
