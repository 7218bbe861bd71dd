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


def data_idle(x) -> bool:
    """``x`` is a DTensor on a mesh whose "data" dim, of more than one
    device, its rows leave idle (replicated there: one row)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names or ()
    if "data" not in names:
        return False
    i = names.index("data")
    return x.device_mesh.size(i) > 1 and x.placements[i] == Replicate()


def model_idle_data(x) -> int:
    """The mesh's "data" dim where ``x`` is a DTensor on a mesh whose
    "model" dim is one device and whose "data" dim its rows leave idle
    (:func:`data_idle`: a one-row step), else -1. There GSPMD spreads the
    reference's work over "data" where the weights leave it free: the
    M2Cache FFN's gate and up products and the predictor's first contract
    their d over it, the RG-LRU conv takes its channels there, and a down
    product whose layer's output stays inside a pattern repeat writes its d
    there (one-row long_500k m2 steps of qwen2.5-14b and recurrentgemma-2b
    on 2 x 1 and 4 x 1, the reference's partitioned HLO)."""
    if not data_idle(x):
        return -1
    names = x.device_mesh.mesh_dim_names
    if "model" not in names or x.device_mesh.size(names.index("model")) > 1:
        return -1
    return names.index("data")


def shard_on(x, i: int, dim: int):
    """``x`` with its ``dim`` sharded over mesh dim ``i`` (its other
    placements kept); the identity where ``i`` < 0 or on a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if i < 0 or not isinstance(x, DTensor):
        return x
    placements = list(x.placements)
    placements[i] = Shard(dim % x.dim())
    return x.redistribute(x.device_mesh, placements)


def off_model(x):
    """``x`` replicated over the mesh's "model" dim (its other placements
    kept); the identity on a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or "model" not in (
            x.device_mesh.mesh_dim_names or ()):
        return x
    placements = list(x.placements)
    placements[x.device_mesh.mesh_dim_names.index("model")] = Replicate()
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


def _rounded(c: float, dtype) -> float:
    """The constant ``c`` as a ``dtype`` value (JAX casts a Python constant
    to a bf16 operand's type before the product)."""
    return float(torch.tensor(c, dtype=dtype))


def sigmoid(x):
    """``jax.nn.sigmoid``: below fp32 XLA's logistic, 1 / (1 + exp(-x)) with
    every op rounded to x's dtype (on a mesh from x's partial sums reduced,
    as the single op they stand for reduces them)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-reduced(x)))


def _silu(x):
    """``jax.nn.silu``. Below fp32 XLA computes its logistic as 1 / (1 +
    exp(-x)) with every op rounded to x's dtype, then the product: the same
    ops here, each rounded (bit-equal at bf16; ``F.silu`` rounds once and
    matched 61 % of bf16 values)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    x = reduced(x)
    return x * sigmoid(x)


def _gelu_tanh(x):
    """``jax.nn.gelu``'s default (tanh) form. Below fp32 every op of its
    jaxpr rounds to x's dtype, its constants first (bit-equal at bf16;
    ``F.gelu`` rounds once and matched 57 % of bf16 values)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    x = reduced(x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def activation(name: str):
    return {"silu": _silu, "relu": F.relu, "gelu": _gelu_tanh}[name]


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


def idle_data(t, hq: int, hkv: int) -> tuple:
    """``(i, a, b)``: GSPMD splits a one-row step's heads (``hq`` query
    heads over ``hkv`` kv heads; ``hq = hkv`` for heads without groups)
    over the mesh's "data" dim ``i``, where the rows leave it idle (``t`` a
    DTensor replicated there), as it splits them over "model": the kv heads
    ``a`` ways and each group ``b`` ways (``a, b, _ = head_split(hq, hkv,
    the "model" dim's size)``), if 1 < a * b <= the "data" dim's size, each
    block of heads on data / (a * b) of its devices; else ``(-1, 1, 1)``.
    It stays a placement: a no-op on plain tensors.

    The cases that decided it (the reference's partitioned HLO counted by
    ``repro/roofline/hlo_cost.analyze``, one-row long_500k steps on "data"
    x "model" meshes of placeholder CPU devices): the attention's weighted values, whose
    keys lie on "model", split qwen2.5-14b's 40 query heads over 8 kv heads
    (a, b = 2, 1 on "model" 2; 4, 1 on 4; 8, 1 on 8 and 16) 2 ways on 2 x
    2 to 16 x 2, 4 ways on 4 x 4, 8 x 4 and 16 x 4, 8 ways on 8 x 8, 16 x
    8, 8 x 16 and 16 x 16, and not on 1 x m, 2 x 4, 2 x 8, 4 x 8, 2 x 16 or
    4 x 16; mistral-large-123b's 96 over 8 (8, 2 on "model" 16) 16 ways on
    16 x 16 and not on 8 x 16; the SSD decode's h C splits mamba2-370m's
    32 heads 4 ways on 4 x 4, 8 x 4 and 16 x 4, 16 ways on 16 x 16, and not
    on 2 x 4, 4 x 16 or 8 x 16 (tests/test_torch_dryrun_parity_meshes.py
    holds the port to the reference at each edge)."""
    if not data_idle(t) or "model" not in t.device_mesh.mesh_dim_names:
        return -1, 1, 1
    names = t.device_mesh.mesh_dim_names
    i = names.index("data")
    a, b, _ = head_split(hq, hkv, t.device_mesh.size(names.index("model")))
    if not 1 < a * b <= t.device_mesh.size(i):
        return -1, 1, 1
    return i, a, b


def _head_blocks(t, dim: int, n: int, r: int):
    """``t``'s ``dim`` of H heads as n blocks of H / n heads, each block
    repeated r times (size r * H, block-major): the slots of a "data" dim
    of n * r devices, each block on r of them."""
    lead, H, rest = t.shape[:dim], t.shape[dim], t.shape[dim + 1:]
    t = t.reshape(*lead, n, 1, H // n, *rest)
    t = t.expand(*lead, n, r, H // n, *rest)
    return t.reshape(*lead, n * r * (H // n), *rest)


def heads_on_idle_data(fn, t, dim: int = 1):
    """``fn(t)``, with ``t``'s heads (``dim``) split over the mesh's "data"
    dim where the rows leave it idle (:func:`idle_data`), as GSPMD splits
    the reference's one-row steps (the result replicated there again).
    ``fn`` maps the heads dim to itself."""
    i, n, _ = idle_data(t, t.shape[dim], t.shape[dim])
    if i < 0:
        return fn(t)
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    r = mesh.size(i) // n
    placements = list(t.placements)
    placements[i] = Shard(dim)
    out = fn(_head_blocks(t, dim, n, r).redistribute(mesh, placements))
    placements = list(out.placements)
    placements[i] = Replicate()
    out = out.redistribute(mesh, placements)
    lead, rest = out.shape[:dim], out.shape[dim + 1:]
    H = t.shape[dim]
    return out.reshape(*lead, n, r, H // n, *rest)[
        (slice(None),) * dim + (slice(None), 0)].reshape(*lead, H, *rest)


def _weighted_values(probs, v):
    """probs (B, Hkv, G, Sq, Skv) x v (B, Skv, Hkv, D) -> (B, Sq, Hkv, G,
    D). On a mesh whose "data" axis the rows leave idle (:func:`idle_data`)
    the query heads split over it as GSPMD splits the reference's (the
    scores before it keep every head), under ``local_map``, each device
    its heads' block (:func:`idle_data`) over its slots of the keys."""
    B, Hkv, G, Sq, Skv = probs.shape
    i, a, b = idle_data(v, Hkv * G, Hkv)
    if i < 0:
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    D = v.shape[-1]
    mesh = v.device_mesh
    r = mesh.size(i) // (a * b)
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
