"""Shared building blocks (PyTorch counterparts of ``repro/models/common.py``).

``_attend`` and ``chunked_attention`` are the plain versions of the two
attention kernels: the port computes with them on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) absolute positions. Split-half
    layout with float32 angles."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                      exponent)
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
