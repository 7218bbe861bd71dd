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


def sharded_on(t, axis: str, dim: int) -> bool:
    """Whether ``t`` is a DTensor whose mesh dim ``axis`` shards its dim
    ``dim``."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return False
    names = t.device_mesh.mesh_dim_names or ()
    return axis in names and t.placements[names.index(axis)] == Shard(dim)


def on_model(x):
    """``x`` with its last dim on the mesh's "model" dim (where that
    divides it; its other placements kept), as the reference's activations
    come between layers; the identity on a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or "model" not in (
            x.device_mesh.mesh_dim_names or ()):
        return x
    i = x.device_mesh.mesh_dim_names.index("model")
    if x.shape[-1] % x.device_mesh.size(i):
        return x
    placements = list(x.placements)
    placements[i] = Shard(x.dim() - 1)
    return x.redistribute(x.device_mesh, placements)


def reduced(x):
    """``x`` with its partial sums reduced (a DTensor's ``Partial``
    placements made ``Replicate``, its shards kept); the identity on a
    plain tensor. A product's input that DTensor would otherwise carry
    partial into it, so that the product ran on a whole operand."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            pl.is_partial() for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in x.placements])


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


def head_split(hq: int, hkv: int, m: int) -> tuple:
    """How GSPMD splits grouped-query attention over a model axis of ``m``
    devices, as the reference's compiled steps show (one device's score
    products): the kv heads ``a`` ways, each kv head's group of ``G = hq /
    hkv`` query heads ``b`` ways, and each such block held by ``r``
    devices (``a * b * r = m``). qwen2.5-14b's 40 query heads over 8 kv
    heads on 16 devices: (8, 1, 2), 5 query heads a device; 8 over 2 on 4:
    (2, 2, 1)."""
    a = math.gcd(hkv, m)
    b = math.gcd(hq // hkv, m // a)
    return a, b, m // (a * b)


def head_slots(t, hkv: int, a: int, b: int, r: int):
    """(B, S, hkv * g, D) -> (B, S, a * b * r, (hkv / a) * (g / b), D): slot
    (i, j, c) holds kv-head block i and its query groups' block j, repeated
    for c < r (K/V: g = 1, b = 1 and r the query's b * r)."""
    B, S, H, D = t.shape
    g = H // hkv
    t = t.reshape(B, S, a, hkv // a, b, g // b, D).transpose(3, 4)
    t = t.unsqueeze(4).expand(B, S, a, b, r, hkv // a, g // b, D)
    return t.reshape(B, S, a * b * r, H // (a * b), D)


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
    out = _weighted_values(probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


#: the "data" axis size from which GSPMD splits a step's heads over that
#: axis where the rows leave it idle (one row: long_500k): the reference's
#: compiled steps split them on 8 x 16 and 16 x 16 and keep them whole on
#: 2 x 4 and 4 x 16
IDLE_DATA_SPLIT = 8


def idle_data(t) -> int:
    """The index of the mesh's "data" dim where ``t`` is a DTensor that
    the rows leave idle there (replicated) on a mesh of at least
    ``IDLE_DATA_SPLIT`` such devices, else -1."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return -1
    names = t.device_mesh.mesh_dim_names or ()
    if "data" not in names:
        return -1
    i = names.index("data")
    if t.device_mesh.size(i) < IDLE_DATA_SPLIT or \
            t.placements[i] != Replicate():
        return -1
    return i


def heads_on_idle_data(fn, t, dim: int = 1):
    """``fn(t)``, with ``t``'s heads (``dim``) split over the mesh's "data"
    dim where the rows leave it idle (:func:`idle_data`) and it divides
    them, as GSPMD splits the reference's one-row steps (the result
    replicated there again)."""
    i = idle_data(t)
    if i < 0 or t.shape[dim] % t.device_mesh.size(i):
        return fn(t)
    from torch.distributed.tensor import Replicate, Shard
    placements = list(t.placements)
    placements[i] = Shard(dim)
    out = fn(t.redistribute(t.device_mesh, placements))
    placements = list(out.placements)
    placements[i] = Replicate()
    return out.redistribute(out.device_mesh, placements)


def _weighted_values(probs, v):
    """probs (B, Hkv, G, Sq, Skv) x v (B, Skv, Hkv, D) -> (B, Sq, Hkv, G,
    D). On a mesh whose "data" axis the rows leave idle (:func:`idle_data`)
    the query heads split over it as GSPMD splits the reference's (the
    scores before it keep every head), under ``local_map``, each device
    its heads' block (:func:`head_split`) over its slots of the keys."""
    i = idle_data(v)
    if i < 0:
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, Hkv, G, Sq, Skv = probs.shape
    D = v.shape[-1]
    mesh = v.device_mesh
    a, b, r = head_split(Hkv * G, Hkv, mesh.size(i))
    ps = head_slots(probs.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G, Skv),
                    Hkv, a, b, r)                     # (B, Sq, m, hq_l, Skv)
    vs = head_slots(v, Hkv, a, 1, b * r)              # (B, Skv, m, hkv_l, D)
    p_pl, v_pl, o_pl = [], [], []
    for j, vp in enumerate(vs.placements):
        if j == i:                                    # the head slots
            pl = (Shard(2), Shard(2), Shard(2))
        elif vp == Shard(1):                          # the keys' slots
            pl = (Shard(4), vp, Partial())
        else:
            pl = (Replicate(),) * 3
        for lst, q in zip((p_pl, v_pl, o_pl), pl):
            lst.append(q)

    def block(p, v):
        hkv = v.shape[3]
        p = p[:, :, 0].reshape(B, Sq, hkv, -1, p.shape[-1])
        return torch.einsum("bqhgk,bkhd->bqhgd", p, v[:, :, 0]).reshape(
            B, Sq, 1, -1, D)
    out = local_map(block, out_placements=o_pl, in_placements=(p_pl, v_pl),
                    device_mesh=mesh, redistribute_inputs=True)(ps, vs)
    out = out.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(
        B, Sq, a, b, r, Hkv // a, G // b, D)
    return out[:, :, :, :, 0].transpose(3, 4).reshape(B, Sq, Hkv, G, D)


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
    return glu_down(glu_hidden(x, w_gate, w_up, act_name), w_down)


def glu_hidden(x, w_gate, w_up, act_name: str):
    """:func:`glu_ffn`'s hidden activations act(x W_gate) * (x W_up)."""
    act = activation(act_name)
    h = act(reduced(placed_product(x, w_gate)))
    return h * reduced(placed_product(x, w_up))


def glu_down(h, w_down):
    """:func:`glu_ffn`'s closing product."""
    return placed_product(h, w_down)


def placed_product(x, w):
    """``x @ w`` (``...i,io->...o``); for DTensors under ``local_map``,
    placed on each mesh dim as GSPMD places the reference's: where x's rows
    lie, w gathered there (FSDP) and the output's rows as x's; else where w
    shards its input dim, x's last dim too and the output a partial sum;
    else where w shards its output dim, x whole and the output's last dim
    sharded; the gradients placed to match (a partial sum where the
    forward's operand was whole). DTensor's own choice here differs between
    torch versions, and with it the count."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return torch.einsum("...i,io->...o", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    pl = [[] for _ in range(5)]              # x, w, out, x's grad, w's grad
    for px, pw in zip(x.placements, w.placements):
        if isinstance(px, Shard) and px.dim < last:          # x's rows
            place = (px, Replicate(), px, px, Partial())
        elif pw == Shard(0):
            place = (Shard(last), pw, Partial(), Shard(last), pw)
        elif pw == Shard(1):
            place = (Replicate(), pw, Shard(last), Partial(), pw)
        else:
            place = (Replicate(),) * 5
        for lst, q in zip(pl, place):
            lst.append(q)
    return local_map(lambda a, b: torch.einsum("...i,io->...o", a, b),
                     out_placements=pl[2], in_placements=(pl[0], pl[1]),
                     in_grad_placements=(pl[3], pl[4]),
                     device_mesh=w.device_mesh, redistribute_inputs=True)(
                         x, w)
