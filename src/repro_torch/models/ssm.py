"""Mamba-2 block — SSD (state-space duality) chunked form [arXiv:2405.21060]
(``repro/models/ssm.py``).

Prefill uses the chunked dual form (quadratic within a chunk, linear
recurrence across chunk states); decode uses the O(1) recurrent update.
Attention-free: M2Cache's neuron sparsity is inapplicable here, but the
layer-wise multi-level weight cache still applies.

The reference's multi-operand einsums are written as pairwise products in a
fixed order (``matmul`` and broadcast multiplies): one ``torch.einsum``
would let ``opt_einsum``, where it is installed, choose the contraction
order, and two machines could then sum in two orders. The reference's
``lax.scan`` over chunk states is a Python loop over the chunks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (activation, causal_conv1d, constrain,
                                       heads_on_idle_data, reduced, rms_norm)


def _segsum(a):
    """a: (..., L). Returns (..., L, L) with out[i, j] = sum_{k=j+1..i} a_k
    for i >= j, -inf elsewhere (log-space decay matrix)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def ssd_chunked(x, dt, A, B, C, *, chunk: int, h0=None, policy=None):
    """SSD scan. x: (b, s, h, p), dt: (b, s, h), A: (h,), B, C: (b, s, n).

    Returns (y, h_final) with y: (b, s, h, p), h_final: (b, h, p, n).
    ``policy`` (DTensor inputs), as GSPMD places the reference's: the
    chunks' C B^T with n on "model" (its sums reduced), the rest under
    ``local_map`` on each device's rows and heads (B, C and C B^T whole)."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, (s, chunk)
    c = s // chunk
    cB = B.reshape(b, c, chunk, n)
    cC = C.reshape(b, c, chunk, n)
    from torch.distributed.tensor import DTensor
    if policy is None or not isinstance(x, DTensor):
        return _ssd_chunks(x, dt, A, cB, cC, cC @ cB.transpose(-1, -2), h0)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    batch = ("pod", "data")
    mesh = policy.mesh

    def place(t, *spec):
        return policy.named(tuple(t.shape), *spec)[1]

    def partial(pl):            # a replicated input's gradient: per-head sums
        return [Partial() if n_ == "model" else q
                for n_, q in zip(mesh.mesh_dim_names, pl)]
    nsh = place(cC, batch, None, None, "model")
    scores = local_map(lambda u, v: u @ v.transpose(-1, -2),
                       out_placements=partial(nsh), in_placements=(nsh, nsh),
                       device_mesh=mesh, redistribute_inputs=True)
    CB = reduced(scores(cC, cB))
    whole = place(cC, batch)
    x_pl = place(x, batch, None, "model")
    dt_pl = place(dt, batch, None, "model")
    a_pl = place(A, "model")
    h_pl = place(x[:, 0][..., None], batch, "model")
    args = (x, dt, A, cB, cC, CB, h0)
    ins = (x_pl, dt_pl, a_pl, whole, whole, whole,
           None if h0 is None else h_pl)
    grads = (x_pl, dt_pl, a_pl, partial(whole), partial(whole),
             partial(whole), None if h0 is None else h_pl)
    return local_map(_ssd_chunks, out_placements=(x_pl, h_pl),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _ssd_chunks(x, dt, A, cB, cC, CB, h0):
    """:func:`ssd_chunked` given B and C in chunks (b, c, l, n) and their
    product C B^T (b, c, i, j)."""
    b, s, nh, p = x.shape
    _, c, chunk, n = cB.shape

    xd = x * dt[..., None]                                   # dt-discretised
    dtA = dt * A                                             # (b, s, h)

    cx = xd.reshape(b, c, chunk, nh, p)
    cdtA = dtA.reshape(b, c, chunk, nh)

    A_cum = torch.cumsum(cdtA, dim=2)                        # (b, c, l, h)

    # intra-chunk (quadratic, "attention-like"): bcin,bcjn,bchij,bcjhp->bcihp
    Lmat = torch.exp(_segsum(cdtA.permute(0, 1, 3, 2)))      # (b, c, h, l, l)
    scores = CB[:, :, None] * Lmat                           # (b, c, h, i, j)
    Y_diag = scores @ cx.permute(0, 1, 3, 2, 4)              # (b, c, h, i, p)

    # chunk-final states from intra-chunk inputs: bcln,bclh,bclhp->bchpn
    decay_states = torch.exp(A_cum[:, :, -1:, :] - A_cum)    # (b, c, l, h)
    xw = cx * decay_states[..., None]                        # (b, c, l, h, p)
    states = xw.permute(0, 1, 3, 4, 2) @ cB[:, :, None]      # (b, c, h, p, n)

    # inter-chunk recurrence over chunk states (emit the state entering each)
    chunk_decay = torch.exp(A_cum[:, :, -1, :])              # (b, c, h)
    h = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device) \
        if h0 is None else h0.to(x.dtype)
    h_prevs = []
    for i in range(c):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (b, c, h, p, n)

    # inter-chunk contribution: bcln,bchpn,bclh->bclhp; below fp32 the
    # decay on C first and then the sum over n, as the reference's einsum
    # orders it and rounds (in fp32 the decay after, on the smaller
    # (b, c, h, l, p) product)
    state_decay = torch.exp(A_cum).permute(0, 1, 3, 2)[..., None]
    if cC.dtype == torch.float32:
        Y_off = (cC[:, :, None] @ h_prevs.transpose(-1, -2)) * state_decay
    else:
        Y_off = (cC[:, :, None] * state_decay) @ h_prevs.transpose(-1, -2)

    y = (Y_diag + Y_off).permute(0, 1, 3, 2, 4).reshape(b, s, nh, p)
    return y, h


def ssd_decode_step(x, dt, A, B, C, h):
    """Single-token recurrent update. x: (b, h, p), dt: (b, h), B, C: (b, n),
    h: (b, h, p, n)."""
    dec = torch.exp(dt * A)                                  # (b, h)
    upd = (x * dt[..., None])[..., None] * B[:, None, None, :]   # bhp,bn->bhpn
    h_new = h * dec[..., None, None].to(h.dtype) + upd
    # bhpn,bn->bhp (on a mesh the heads over an idle "data" axis, as GSPMD
    # splits the reference's one-row step)
    y = heads_on_idle_data(lambda t: (t @ C[:, None, :, None])[..., 0],
                           h_new)
    return y, h_new


# ---------------------------------------------------------------------------
# Full mamba2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)


def ssd_mix(cfg, p, zxbcdt, state, *, mode: str, policy=None):
    """The block between its two projections: ``zxbcdt`` (B, S, 2di + 2n +
    nh) split into z, xBC and dt; softplus(dt + dt_bias), A = -exp(A_log);
    the causal conv over xBC from ``state["conv"]`` and SiLU; the SSD from
    ``state["h"]`` ("decode": S = 1, the recurrent update; "prefill": the
    chunked scan, S padded to a whole number of chunks and sliced back);
    the D skip. Returns (y (B, S, di), z, new state or None).
    ``policy``: the conv's channels on "model", then the chunked scan's
    heads, as GSPMD places the reference's (:func:`ssd_chunked`; a no-op
    on plain tensors)."""
    B_, S, _ = zxbcdt.shape
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_head_dim
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, S, nh)
    A = -torch.exp(p["A_log"].float())                       # (nh,)

    batch = ("pod", "data")
    conv_state = None if state is None else state["conv"]
    xBC = constrain(xBC, policy, batch, None, "model")
    xBC, new_conv = causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = activation("silu")(xBC)
    xs, Bs, Cs = torch.split(xBC, [di, n, n], dim=-1)
    xs = xs.reshape(B_, S, nh, hd)

    h0 = None if state is None else state["h"]
    if mode == "decode":
        y1, h_new = ssd_decode_step(
            xs[:, 0], dt[:, 0].to(xs.dtype), A.to(xs.dtype), Bs[:, 0],
            Cs[:, 0], h0 if h0 is not None else torch.zeros(
                (B_, nh, hd, n), dtype=xs.dtype, device=xs.device))
        y = y1[:, None]
    else:
        xs = constrain(xs, policy, batch, None, "model")
        dt = constrain(dt, policy, batch, None, "model")
        Bs, Cs = constrain(Bs, policy, batch), constrain(Cs, policy, batch)
        pad = (-S) % cfg.ssm_chunk
        xp, Bp, Cp, dtp = xs, Bs, Cs, dt
        if pad:
            xp = F.pad(xs, (0, 0, 0, 0, 0, pad))
            Bp = F.pad(Bs, (0, 0, 0, pad))
            Cp = F.pad(Cs, (0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
        y, h_new = ssd_chunked(xp, dtp.to(xs.dtype), A.to(xs.dtype), Bp, Cp,
                               chunk=cfg.ssm_chunk, h0=h0, policy=policy)
        y = y[:, :S]

    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    new_state = {"h": h_new, "conv": new_conv} if state is not None else None
    return y.reshape(B_, S, di), z, new_state


def ssm_block(cfg, p, x, state, *, mode: str, policy=None):
    """x: (B, S, d). state: {'h': (B, nh, hd, n), 'conv': (B, W-1, di+2n)}
    or None. ``mode`` as in :func:`ssd_mix`: in_proj, :func:`ssd_mix`, the
    gated RMSNorm, out_proj. ``policy``: in_proj's output column-parallel
    (its gradient too, for the weight's) and :func:`ssd_mix`'s placements.

    Returns (y, new_state)."""
    zxbcdt = constrain(x @ p["w_in"], policy, ("pod", "data"), None, "model")
    y, z, new_state = ssd_mix(cfg, p, zxbcdt, state, mode=mode,
                              policy=policy)
    y = rms_norm(y * activation("silu")(z), p["gnorm_w"])
    return y @ p["w_out"], new_state
