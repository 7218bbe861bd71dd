"""Shared building blocks (PyTorch counterparts of ``repro/models/common.py``).

``_attend`` and ``chunked_attention`` are the plain versions of the two
attention kernels: the port computes with them on the CPU.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

def constrain(x, policy, *spec):
    """Activation sharding constraint (the reference's transformer.py:
    455-461): the identity without a policy or on a plain tensor; a DTensor
    is redistributed to the policy's placements of ``spec`` (checked
    against x's shape)."""
    if policy is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(*policy.named(tuple(x.shape), *spec))


# ---------------------------------------------------------------------------
# Norms


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def layer_norm(x, weight, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def apply_norm(cfg, x, weight):
    return layer_norm(x, weight) if cfg.norm == "layernorm" else rms_norm(x, weight)


# ---------------------------------------------------------------------------
# RoPE


def each_row(fn, x):
    """``fn`` over each batch row of ``x`` alone, results concatenated on
    the batch axis (``fn`` may return a tensor or a tuple of tensors).

    The server's stacked rows are separate requests, and a request's bits
    must not depend on the rows beside it. On the card, cuBLAS products and
    PyTorch's reductions choose their kernels, and so their summation
    order, from the whole tensor's shape; run on one row at a time they see
    the shape that row has alone."""
    if x.shape[0] == 1:
        return fn(x)
    outs = [fn(x[r:r + 1]) for r in range(x.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


@functools.lru_cache(maxsize=None)
def rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` as the reference's fp32 power
    rounds it: the fp32 exponent, the power of the fp32 theta in float64,
    rounded once to fp32. ``torch.pow`` in fp32 misses the correctly
    rounded power by one ulp on some frequencies (4 of 64 at theta 1e6,
    D = 128), and the angle ``position * freq`` carries the miss to
    ~1e-2 at position 524272. Computed on the CPU, so every device gets
    the same bits; a constant per (theta, half, device)."""
    exponent = -torch.arange(0, half, dtype=torch.float32) / half
    base = torch.tensor(theta, dtype=torch.float32).double()
    return torch.pow(base, exponent.double()).float().to(device)


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) absolute positions. Split-half
    layout with float32 angles."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(float(theta), half, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def activation(name: str):
    return {"silu": F.silu, "relu": F.relu, "gelu": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# Attention core (prefill / decode)


def _attend(q, k, v, q_pos, kv_pos, *, window: int = 0,
            softcap: float = 0.0, kv_valid=None):
    """Dense attention over the given K/V with causal (+window) masking.

    q: (B, Sq, Hq, D)   k, v: (B, Skv, Hkv, D)
    q_pos: (B, Sq) absolute positions; kv_pos: (B, Skv).
    kv_valid: optional (B, Skv) bool — entries that contain real data.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    mask = kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    if window:
        mask &= kv_pos[:, None, None, None, :] > (
            q_pos[:, None, None, :, None] - window)
    if kv_valid is not None:
        mask &= kv_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


def chunked_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                      softcap: float = 0.0, kv_valid=None,
                      q_chunk: int = 512):
    """Loop over query chunks so peak score memory is (B,H,chunk,Skv)."""
    B, Sq, Hq, D = q.shape
    if Sq <= q_chunk:
        return _attend(q, k, v, q_pos, kv_pos, window=window,
                       softcap=softcap, kv_valid=kv_valid)
    assert Sq % q_chunk == 0, (Sq, q_chunk)
    outs = [_attend(q[:, i:i + q_chunk], k, v, q_pos[:, i:i + q_chunk], kv_pos,
                    window=window, softcap=softcap, kv_valid=kv_valid)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Causal depthwise conv (the RG-LRU input branch)


def causal_conv1d(x, w, b=None, state=None):
    """x: (B, S, C); w: (W, C) depthwise; state: (B, W-1, C) past inputs.

    Returns (y, new_state) where new_state holds the last W-1 inputs. The
    taps are summed in a fixed order, one elementwise product each (not
    ``F.conv1d``, whose algorithm, and so its summation order, would
    follow the whole batch's shape), so a row's bits do not depend on the
    rows beside it."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xin = torch.cat([state.to(x.dtype), x], dim=1)      # (B, S+W-1, C)
    y = xin[:, 0:S] * w[0]
    for j in range(1, W):
        y = y + xin[:, j:j + S] * w[j]
    if b is not None:
        y = y + b
    new_state = xin[:, S:] if W > 1 else state
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# GLU feed-forward (the paper's neuron substrate)


def glu_ffn(x, w_gate, w_up, w_down, act_name: str):
    """y = (act(x W_gate) * (x W_up)) W_down.

    A *neuron* in the paper's sense is the triple
    (W_gate[:, j], W_up[:, j], W_down[j, :]).
    """
    act = activation(act_name)
    h = act(torch.einsum("...d,df->...f", x, w_gate))
    h = h * torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", h, w_down)
