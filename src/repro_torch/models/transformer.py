"""Model assembly for all six families (``repro/models/transformer.py``'s
serving path): the attention families (``dense``, ``vlm``'s decoder,
``moe`` and ``audio``'s codebook decoder), the ``hybrid`` family
(RecurrentGemma's RG-LRU blocks beside sliding-window attention) and the
attention-free ``ssm`` family (Mamba-2's SSD blocks, no FFN), with the
M2Cache FFN or the MoE FFN.

Parameters are plain dictionaries of tensors with the reference's leaf
names; where the reference stacks the layers of one pattern position on a
leading axis for ``lax.scan``, the port keeps one dictionary per layer in
``params["layers"]``, in layer order (layer l = repeat * len(pattern) +
position, then the remainder), and runs them in a Python loop. The cache
keeps the reference's layout, ``{"pattern": [one entry per pattern
position, its leaves stacked over the F repeats], "remainder": [one entry
per remainder layer], "pos"}``, an attention entry ``{"k", "v": (F, B,
sbuf, kvH, Dh)}`` (``sbuf = min(window, max_seq)`` with a sliding window:
a ring; with ``kv_quant`` int8 ``k``/``v`` and fp32 scales ``k_s``/``v_s``
(F, B, sbuf, kvH)), an RG-LRU entry ``{"h": (F, B, W), "conv": (F, B,
cw-1, W)}``, an SSD entry ``{"h": (F, B, nh, hd, n), "conv": (F, B, cw-1,
di+2n)}`` (remainder entries without the F axis), and is updated in place.
``pos`` is an int when every row stands at one position (a fresh cache,
launch/serve's batch) and a CPU int64 tensor (B,) when the rows are
separate requests at their own positions (the server's stacked rows, where
the reference vmaps a one-row graph over a per-row ``pos``).

Ported: attention layers, serial or parallel (command-r's attention and
FFN side by side on one norm), with the attention logit softcap (grok-1)
and a sliding window; RG-LRU layers (``models/hybrid.py``); SSD layers
(``models/ssm.py``, no FFN); the vlm and audio families' prepended
``prefix`` embeddings (patches, conditioning frames) and the audio
family's K codebooks (tokens (B, K, S), logits (B, K, S, V)); the three
FFNs of the reference's ``_ffn_apply``: the M2Cache FFN (``m2`` and a
layer with banks), the MoE experts (``models/moe.py``: no banks, no active
neurons) and the dense GLU (``init_params(m2=False)``'s ``wg``/``wu``/
``wd``); ``mode`` "train" (no cache, under autograd; ``remat`` recomputes
each layer in the backward pass; :func:`lm_loss`), "prefill",
"prefill_resume" (attention-only models without a window, as the
reference) and "decode"; the long-context ``window`` override (a sliding
window on a model without one of its own) and the int8 K/V cache
(``kv_quant``: each token's K and V per head quantized, dequantized to fp32
before the attention kernels), outside the server's ``rows``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import mp_ffn as mp
from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
from repro_torch.kernels import ops
from repro_torch.models import hybrid, moe, ssm
from repro_torch.models.common import (apply_norm, chunked_attention,
                                       constrain, each_row, glu_down,
                                       glu_ffn, glu_hidden, head_slots,
                                       head_split, placed_product, rope,
                                       sharded_on)
from repro_torch.sharding import P

# ---------------------------------------------------------------------------
# Parameter specification


def pattern_of(cfg):
    if cfg.family == "hybrid":
        return tuple(cfg.block_pattern)
    return (cfg.layer_kinds[0],)


def pattern_split(cfg) -> Tuple[tuple, int, int]:
    pat = pattern_of(cfg)
    F, rem = divmod(cfg.num_layers, len(pat))
    return pat, F, rem


def check_supported(cfg):
    """Raise NotImplementedError for layer kinds the port does not run:
    anything but attention, RG-LRU and SSD."""
    other = set(pattern_of(cfg)) - {"attn", "rglru", "ssm"}
    if other:
        raise NotImplementedError(f"layer kinds {sorted(other)} are not "
                                  "ported yet")


def _ffn_specs(cfg, dtype, m2: bool) -> Dict:
    """(shape, dtype, kind) of one layer's FFN: the MoE experts
    (transformer.py:57-76: the router, (E, d, f) gate and up, (E, f, d)
    down, a shared expert where the config has one, and with ``m2`` the
    per-expert predictor leaves, which nothing reads), else with ``m2`` the
    M2Cache FFN (transformer.py:77-102), in the reference's layout:
    :func:`init_params` draws the fp weights in it and then stores gate and
    up neuron-major; else the dense GLU's (d, f) gate and up and (f, d)
    down (transformer.py:103-107)."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.m2_predictor_rank
    i8, f32 = torch.int8, torch.float32
    if cfg.num_experts:
        E = cfg.num_experts
        out = {
            "router": ((d, E), f32, "replicated"),
            "wg": ((E, d, f), dtype, "expert_in"),
            "wu": ((E, d, f), dtype, "expert_in"),
            "wd": ((E, f, d), dtype, "expert_out"),
        }
        if cfg.shared_expert_d_ff:
            fs = cfg.shared_expert_d_ff
            out["shared_wg"] = ((d, fs), dtype, "col")
            out["shared_wu"] = ((d, fs), dtype, "col")
            out["shared_wd"] = ((fs, d), dtype, "row")
        if m2:
            out["pred_A"] = ((d, r), f32, "replicated")
            out["pred_B"] = ((r, f), f32, "replicated")
        return out
    if not m2:
        return {"wg": ((d, f), dtype, "col"), "wu": ((d, f), dtype, "col"),
                "wd": ((f, d), dtype, "row")}
    assert d % 2 == 0 and f % 2 == 0
    return {
        "banks": {
            "wg_fp": ((d, f), dtype, "m2_in"),
            "wu_fp": ((d, f), dtype, "m2_in"),
            "wd_fp": ((f, d), dtype, "m2_out"),
            "wg_i8": ((d, f), i8, "m2_in"),
            "wu_i8": ((d, f), i8, "m2_in"),
            "wd_i8": ((f, d), i8, "m2_out"),
            "wg_i8_s": ((f,), f32, "replicated"),
            "wu_i8_s": ((f,), f32, "replicated"),
            "wd_i8_s": ((f,), f32, "replicated"),
            "wg_i4": ((d // 2, f), i8, "m2_in"),
            "wu_i4": ((d // 2, f), i8, "m2_in"),
            "wd_i4": ((f, d // 2), i8, "m2_out"),
            "wg_i4_s": ((f,), f32, "replicated"),
            "wu_i4_s": ((f,), f32, "replicated"),
            "wd_i4_s": ((f,), f32, "replicated"),
        },
        "pred": {
            "A": ((d, r), f32, "replicated"),
            "B": ((r, f), f32, "pred_out"),
        },
    }


def _layer_specs(cfg, kind: str, dtype, m2: bool) -> Dict:
    """One layer of ``kind`` (transformer.py:110-156): an attention layer
    (a parallel block has no ``norm2``), an RG-LRU one or an SSD one (no
    ``ffn``)."""
    d = cfg.d_model
    if kind == "ssm":
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        cw, f32 = cfg.ssm_conv_width, torch.float32
        return {
            "norm1": ((d,), f32, "vector"),
            "w_in": ((d, 2 * di + 2 * n + nh), dtype, "col"),
            "dt_bias": ((nh,), f32, "replicated"),
            "A_log": ((nh,), f32, "replicated"),
            "D": ((nh,), f32, "replicated"),
            "conv_w": ((cw, di + 2 * n), f32, "vector"),
            "conv_b": ((di + 2 * n,), f32, "vector"),
            "gnorm_w": ((di,), f32, "vector"),
            "w_out": ((di, d), dtype, "row"),
        }
    if kind == "rglru":
        w, f32 = cfg.lru_width, torch.float32
        return {
            "norm1": ((d,), f32, "vector"),
            "w_y": ((d, w), dtype, "col"),
            "w_x": ((d, w), dtype, "col"),
            "conv_w": ((cfg.ssm_conv_width, w), f32, "vector"),
            "conv_b": ((w,), f32, "vector"),
            "w_a": ((w, w), dtype, "col"),
            "b_a": ((w,), f32, "vector"),
            "w_i": ((w, w), dtype, "col"),
            "b_i": ((w,), f32, "vector"),
            "lam": ((w,), f32, "vector"),
            "w_out": ((w, d), dtype, "row"),
            "norm2": ((d,), f32, "vector"),
            "ffn": _ffn_specs(cfg, dtype, m2),
        }
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {
        "norm1": ((d,), torch.float32, "vector"),
        "wqkv": ((d, (hq + 2 * hkv) * hd), dtype, "col"),
        "wo": ((hq * hd, d), dtype, "row"),
        "ffn": _ffn_specs(cfg, dtype, m2),
    }
    if cfg.qkv_bias:
        out["bqkv"] = (((hq + 2 * hkv) * hd,), torch.float32, "vector")
    if not cfg.parallel_block:
        out["norm2"] = ((d,), torch.float32, "vector")
    return out


def model_param_specs(cfg, *, dtype=torch.float32, m2: bool = True) -> Dict:
    """The params' (shape, dtype, kind) leaves, one dictionary per layer.
    ``m2`` (the port's default; the reference's is False) gives the
    M2Cache banks where the config enables them, else the dense FFN."""
    check_supported(cfg)
    m2 = m2 and cfg.m2_enabled
    d, V = cfg.d_model, cfg.vocab_size
    specs = {
        "final_norm": ((d,), torch.float32, "vector"),
        "layers": [_layer_specs(cfg, kind, dtype, m2)
                   for kind in cfg.layer_kinds],
    }
    if cfg.family == "audio":                   # transformer.py:180-182
        K = cfg.num_codebooks
        specs["embed"] = ((K, V, d), dtype, "codebook")
        specs["unembed"] = ((K, d, V), dtype, "codebook_out")
    else:
        specs["embed"] = ((V, d), dtype, "vocab")
        if not cfg.tie_embeddings:
            specs["unembed"] = ((V, d), dtype, "vocab")
    return specs


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[2], str)


def _init_one(spec, gen, device):
    """The reference's init rule (transformer.py:253-260): float vectors and
    replicated leaves start at zero (so the predictor's A and an MoE
    router are zero), int8 leaves at zero, everything else
    N(0, 1/fan_in)."""
    shape, dtype, kind = spec
    if kind in ("vector", "replicated") and len(shape) and dtype != torch.int8:
        return torch.zeros(shape, dtype=dtype, device=device)
    if dtype == torch.int8:
        return torch.zeros(shape, dtype=torch.int8, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def _map_specs(fn, tree):
    """``fn`` over the (shape, dtype, kind) leaves of a spec tree."""
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def abstract_params(cfg, *, dtype=torch.float32, m2: bool = True):
    """The params as tensors on the ``meta`` device, in the port's layout
    (banks neuron-major): ``T.abstract_params``' counterpart, nothing is
    allocated."""
    params = _map_specs(lambda s: torch.empty(s[0], dtype=s[1],
                                              device="meta"),
                        model_param_specs(cfg, dtype=dtype, m2=m2))
    for layer in params["layers"]:
        if "banks" in layer.get("ffn", {}):
            layer["ffn"]["banks"] = to_neuron_major(layer["ffn"]["banks"])
    return params


#: the port's per-layer leaf kinds that hold the reference's (d, f) layout
#: transposed (``core.quantize.to_neuron_major``)
_NEURON_MAJOR = ("wg_fp", "wu_fp", "wg_i8", "wu_i8", "wg_i4", "wu_i4")


def _drop_lead(p):
    return P(*tuple(p)[1:])


def param_shardings(cfg, policy, *, dtype=torch.float32, m2: bool = True):
    """PartitionSpec tree of :func:`abstract_params`' tree
    (transformer.py:190-230). A layer's leaf gets the spec the reference
    gives its stacked leaf, the unsharded lead dim dropped (which is the
    spec of an unstacked remainder leaf); a neuron-major bank (f, d) gets
    the transpose of the reference's (d, f) ``m2_in`` spec."""
    def resolve(leaf):
        sh, _, kind = leaf
        if kind == "col":
            return policy.col_parallel(sh)
        if kind == "row":
            return policy.row_parallel(sh)
        if kind == "expert_in":                 # (E, d, f)
            return _drop_lead(policy.expert_parallel((1,) + sh))
        if kind == "expert_out":
            return _drop_lead(policy.expert_parallel_out((1,) + sh))
        if kind == "vector":
            return policy.vector(sh)
        if kind == "replicated":
            return P()
        if kind == "vocab":
            return policy.vocab_embed(sh)
        if kind == "codebook":                  # (K, V, d)
            return policy.spec(sh, None, "model", policy._fsdp_axis())
        if kind == "codebook_out":              # (K, d, V)
            return policy.spec(sh, None, policy._fsdp_axis(), "model")
        if kind == "m2_in":                     # (d|d//2, f): d on model
            return policy.spec(sh, "model", None)
        if kind in ("m2_out", "pred_out"):      # (f, d|d//2), (r, f)
            return policy.spec(sh, None, "model")
        raise ValueError(kind)

    specs = _map_specs(resolve, model_param_specs(cfg, dtype=dtype, m2=m2))
    for layer in specs["layers"]:
        banks = layer.get("ffn", {}).get("banks")
        if banks is not None:
            for k in _NEURON_MAJOR:
                banks[k] = P(*reversed(banks[k]))
    return specs


@torch.no_grad()
def init_params(cfg, *, seed: int = 0, device=None, dtype=torch.float32,
                generator: torch.Generator = None, m2: bool = True):
    """Materialise parameters from a ``torch.Generator`` (seeded with ``seed``
    on ``device`` unless one is given), set the recurrent layers' special
    leaves (transformer.py:271-286: SSD ``A_log`` 0, ``dt_bias`` 0.5, ``D``
    1; RG-LRU ``lam`` 0.7; ``conv_w`` 1 / width), then build every layer's
    quantized banks from its fp weights (transformer.py:298-321), gate and
    up stored neuron-major (``core.quantize.to_neuron_major``); MoE layers
    have no banks, and with ``m2`` False (:func:`model_param_specs`) no
    layer has: the dense FFN keeps its drawn ``wg``/``wu``/``wd``. The
    numbers differ from ``jax.random``'s; parity tests carry the
    reference's params over with ``repro_torch.bridge`` instead."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    params = _map_specs(lambda s: _init_one(s, gen, device),
                        model_param_specs(cfg, dtype=dtype, m2=m2))
    for kind, layer in zip(cfg.layer_kinds, params["layers"]):
        if kind == "ssm":
            layer["A_log"].fill_(0.0)                  # A = -1
            layer["dt_bias"].fill_(0.5)
            layer["D"].fill_(1.0)
        if kind == "rglru":
            layer["lam"].fill_(0.7)
        if kind != "attn":
            layer["conv_w"].fill_(1.0 / layer["conv_w"].shape[-2])
        if "banks" not in layer.get("ffn", {}):
            continue
        b = layer["ffn"]["banks"]
        layer["ffn"]["banks"] = to_neuron_major(build_neuron_banks(
            b["wg_fp"], b["wu_fp"], b["wd_fp"]))
    return params


# ---------------------------------------------------------------------------
# Caches


def _entry(cfg, kind: str, lead: tuple, batch: int, max_seq: int, dtype,
           device, window: int, kv_quant: bool) -> Dict:
    """One pattern position's (``lead`` = (F,)) or remainder layer's (())
    cache entry (transformer.py:339-362)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)
    if kind == "attn":
        w = cfg.window_size or window
        sbuf = min(w, max_seq) if w else max_seq
        kv = (batch, sbuf, cfg.num_kv_heads, cfg.head_dim)
        if kv_quant:
            sc = kv[:-1]
            return {"k": zeros(*kv, dt=torch.int8),
                    "v": zeros(*kv, dt=torch.int8),
                    "k_s": zeros(*sc, dt=torch.float32),
                    "v_s": zeros(*sc, dt=torch.float32)}
        return {"k": zeros(*kv), "v": zeros(*kv)}
    if kind == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        return {"h": zeros(batch, cfg.ssm_nheads, cfg.ssm_head_dim, n),
                "conv": zeros(batch, cfg.ssm_conv_width - 1, di + 2 * n)}
    w = cfg.lru_width
    return {"h": zeros(batch, w),
            "conv": zeros(batch, cfg.ssm_conv_width - 1, w)}


def _cache(cfg, batch: int, max_seq: int, dtype, device, window: int,
           kv_quant: bool):
    check_supported(cfg)
    pat, F, rem = pattern_split(cfg)

    def entry(kind, lead):
        return _entry(cfg, kind, lead, batch, max_seq, dtype, device, window,
                      kv_quant)
    return {"pattern": [entry(k, (F,)) for k in pat],
            "remainder": [entry(k, ()) for k in pat[:rem]],
            "pos": 0}


def init_cache(cfg, batch: int, max_seq: int, *, window: int = 0,
               dtype=torch.float32, kv_quant: bool = False, device=None):
    """Zero decode cache in the reference's layout (transformer.py:330-380):
    one entry per pattern position, its leaves stacked over the F repeats,
    then one per remainder layer; an attention layer's K/V buffer holds
    ``min(window, max_seq)`` slots with a sliding window (the config's, or
    else ``window``: a ring), ``max_seq`` without. ``kv_quant``: K/V int8
    with an fp32 scale per (token, head), ``k_s``/``v_s``."""
    return _cache(cfg, batch, max_seq, dtype, resolve_device(device), window,
                  kv_quant)


def cache_specs(cfg, batch: int, max_seq: int, *, window: int = 0,
                dtype=torch.float32, kv_quant: bool = False):
    """The cache's leaves as shape-and-dtype tensors on the ``meta`` device
    (``T.cache_specs``' counterpart: nothing is allocated)."""
    return _cache(cfg, batch, max_seq, dtype, torch.device("meta"), window,
                  kv_quant)


def cache_shardings(cfg, policy, batch: int, max_seq: int, *,
                    window: int = 0, dtype=torch.float32,
                    kv_quant: bool = False):
    """PartitionSpec tree of :func:`cache_specs`' tree
    (transformer.py:383-408): the pattern entries' stacked leaves and the
    remainder entries' unstacked ones, ``pos`` replicated."""
    specs = cache_specs(cfg, batch, max_seq, window=window, dtype=dtype,
                        kv_quant=kv_quant)

    def resolve(name, t, stacked):
        sh = tuple(t.shape)
        if name in ("k", "v"):                  # (F, B, S, kvH, Dh)
            if stacked:
                return policy.kv_cache(sh)
            return _drop_lead(policy.kv_cache((1,) + sh))
        if name in ("k_s", "v_s"):              # (F, B, S, kvH) scales
            if stacked:
                return P(*tuple(policy.kv_cache(sh + (1,)))[:-1])
            return P(*tuple(policy.kv_cache((1,) + sh + (1,)))[1:-1])
        if stacked:                             # recurrent states
            return policy.recurrent_state(sh)
        return _drop_lead(policy.recurrent_state((1,) + sh))

    return {"pattern": [{n: resolve(n, t, True) for n, t in e.items()}
                        for e in specs["pattern"]],
            "remainder": [{n: resolve(n, t, False) for n, t in e.items()}
                          for e in specs["remainder"]],
            "pos": P()}


def layer_cache(cfg, cache, l: int) -> Dict:
    """Layer ``l``'s cache entry as views of the cache's leaves (writes go
    into the cache): pattern position l % len(pattern), repeat l //
    len(pattern), or a remainder entry."""
    pat, F, rem = pattern_split(cfg)
    n = len(pat)
    if l < F * n:
        return {k: t[l // n] for k, t in cache["pattern"][l % n].items()}
    return cache["remainder"][l - F * n]


def kv_slots(cache):
    """Slots of the attention layers' K/V buffer (None without attention)."""
    for entry in cache["pattern"] + cache["remainder"]:
        if "k" in entry:
            return entry["k"].shape[-3]
    return None


def row_positions(cache, batch: int) -> torch.Tensor:
    """The cache's ``pos`` as a CPU int64 tensor (B,), one entry per row."""
    pos = cache["pos"]
    if isinstance(pos, torch.Tensor):
        return pos.to(torch.int64)
    return torch.full((batch,), int(pos), dtype=torch.int64)


# ---------------------------------------------------------------------------
# Layer forward


def _ring_slot_positions(pos, sbuf: int):
    """Absolute position held by each ring slot after writing token ``pos``
    (B,): (B, sbuf); negative where the slot was never written."""
    s = torch.arange(sbuf, device=pos.device)[None]
    return pos[:, None] - torch.remainder(pos[:, None] - s, sbuf)


def decode_slots(pos0, sbuf: int, ring: bool = False):
    """The decode step's attention mask, built once per forward and shared
    by every layer: (slot positions (B, sbuf) int32, -1 where a slot takes
    no part; lengths (B,) int32, the rows' positions). Without ``ring``
    slot i holds position i and takes part at or below the row's position;
    in a ``ring`` (a sliding window's buffer) it holds
    :func:`_ring_slot_positions` and takes part once written (every
    position a ring holds lies inside the window)."""
    lengths = pos0.to(torch.int32)
    if ring:
        held = _ring_slot_positions(pos0.to(torch.int64), sbuf)
        return torch.where(held >= 0, held, -1).to(torch.int32), lengths
    slots = torch.arange(sbuf, dtype=torch.int32, device=pos0.device)[None]
    return torch.where(slots <= lengths[:, None], slots, -1), lengths


def _kv_quantize(x):
    """(B, S, kvH, Dh) -> (int8 values, (B, S, kvH) fp32 scales)
    (transformer.py:441-447): the scale is max|x| over Dh / 127, floored
    at 1e-8; ``torch.round`` rounds half to even, as ``jnp.round``. The
    127 is a tensor on x's device: CUDA divides by a Python number as a
    product with its reciprocal, which can miss the quotient by an ulp."""
    xf = x.float()
    peak = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(peak / peak.new_full((), 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q, scale, dtype):
    """transformer.py:450-452."""
    return (q.float() * scale[..., None].float()).to(dtype)


def _tp_input(x, policy):
    """A column-parallel product's input with its features replicated over
    "model" (Megatron's f): DTensor picks each op's placements alone, and
    left with the residual's model-sharded features it contracts them into
    a partial sum that it reduce-scatters onto the sequence dim, which a
    later flatten cannot shard evenly."""
    return constrain(x, policy, ("pod", "data"), *[None] * (x.dim() - 1))


def _norm(cfg, x, w, policy):
    """``apply_norm`` over features replicated over "model", in and out
    (:func:`_tp_input`): a LayerNorm's mean over sharded features is a
    partial average whose gradient DTensor cannot form from a partial
    sum."""
    return _tp_input(apply_norm(cfg, _tp_input(x, policy), w), policy)


def _write_slots(buf, at, new, policy=None):
    """``buf[b, at[b, j]] = new[b, j]`` for every row b and token j, in
    place. With a policy, a DTensor buffer sharded over the mesh (batch, or
    a decode step's slots with ``shard_kv_seq``) is written shard by shard:
    each device writes the tokens whose slots it holds."""
    if policy is not None:
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(buf, DTensor) and not all(
                isinstance(pl, Replicate) for pl in buf.placements):
            _write_shards(buf, at, new, policy)
            return
    rows = torch.arange(new.shape[0], device=new.device)[:, None]
    buf[rows, at] = new.to(buf.dtype)


def _write_shards(buf, at, new, policy):
    """:func:`_write_slots` on a sharded DTensor ``buf``, one token a row
    (a decode step): each device's block of ``buf`` takes the rows it
    holds at the slots it holds, from its offset along the slots, and
    writes the slot's old value back where the token lies elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if at.shape[1] != 1:
        raise NotImplementedError("a sharded cache takes one token a row")
    mesh, place = buf.device_mesh, tuple(buf.placements)
    offset = policy.block_offset(tuple(buf.shape), place, 1)
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in place)

    def write(b, t, a):
        local = a - offset
        inside = (local >= 0) & (local < b.shape[1])
        local = local.clamp(0, b.shape[1] - 1)
        r = torch.arange(b.shape[0], device=b.device)[:, None]
        b[r, local] = torch.where(inside[..., None, None], t.to(b.dtype),
                                  b[r, local])
        return b

    def dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local_map(write, out_placements=list(place),
              in_placements=(place, rows, rows),
              device_mesh=mesh, redistribute_inputs=True)(buf, dt(new),
                                                          dt(at))


def _sharded_attention(fn, q, k, v, positions, policy):
    """``fn(q, k, v, positions)``, an attention without a cache; with a
    policy and DTensor inputs, under ``local_map`` on each device's batch
    rows and the heads GSPMD gives it (:func:`head_split`): the query heads
    and the kv heads they read are laid out in ``model`` slots (a block
    that several devices hold is repeated), one slot a device, and the
    output is read back from the first of each block's slots, replicated
    over "model". DTensor cannot follow the attention's products itself:
    their batch and head dims, both sharded, are flattened into one."""
    if policy is None:
        return fn(q, k, v, positions)
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(q, DTensor):
        return fn(q, k, v, positions)
    from torch.distributed.tensor.experimental import local_map
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    a, b, r = head_split(hq, hkv, policy.axes.model)
    batch = ("pod", "data")
    whole = (batch, None, None, None)
    qs = head_slots(constrain(q, policy, *whole), hkv, a, b, r)
    ks = head_slots(constrain(k, policy, *whole), hkv, a, 1, b * r)
    vs = head_slots(constrain(v, policy, *whole), hkv, a, 1, b * r)
    mesh, q_pl = policy.named(tuple(qs.shape), batch, None, "model")
    kv_pl = policy.named(tuple(ks.shape), batch, None, "model")[1]
    pos_pl = policy.named(tuple(positions.shape), batch, None)[1]
    if not isinstance(positions, DTensor):
        positions = DTensor.from_local(positions, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)

    def slot(q, k, v, pos):
        return fn(q[:, :, 0], k[:, :, 0], v[:, :, 0], pos).unsqueeze(2)
    out = local_map(slot, out_placements=q_pl,
                    in_placements=(q_pl, kv_pl, kv_pl, pos_pl),
                    device_mesh=mesh, redistribute_inputs=True)(
                        qs, ks, vs, positions)
    out = constrain(out, policy, batch, None, None, None, None)
    out = out.reshape(B, S, a, b, r, hkv // a, hq // hkv // b, D)
    return out[:, :, :, :, 0].transpose(3, 4).reshape(B, S, hq, D)


def _cached_attention(q, k, v, kv, positions, *, mode: str, window: int,
                      slots, softcap: float, policy=None):
    """The attention of a serving mode, which writes this call's K/V (or,
    with an int8 cache, their :func:`_kv_quantize` bytes and scales) into
    the cache views ``kv`` in place; ``attn_layer`` says what each mode
    attends over. A prompt attends through :func:`_sharded_attention`
    (``policy``)."""
    B, S = q.shape[:2]
    sbuf = kv["k"].shape[1]
    if "k_s" in kv:
        (k_st, ks_st), (v_st, vs_st) = _kv_quantize(k), _kv_quantize(v)
        store = {"k": k_st, "v": v_st, "k_s": ks_st, "v_s": vs_st}
    else:
        store = {"k": k, "v": v}
    if mode == "prefill":                   # from position 0
        if window and S >= sbuf:            # the ring keeps the last sbuf
            # position p goes to slot p mod sbuf: the last sbuf tokens fill
            # the ring from slot S mod sbuf on and wrap once. Two slice
            # writes (an indexed write has no DTensor rule in torch 2.11)
            o = S % sbuf
            for n, t in store.items():
                last = t[:, S - sbuf:].to(kv[n].dtype)
                kv[n][:, o:] = last[:, :sbuf - o]
                kv[n][:, :o] = last[:, sbuf - o:]
        else:
            for n, t in store.items():
                kv[n][:, :S] = t.to(kv[n].dtype)
        return _sharded_attention(
            lambda q, k, v, pos: ops.prefill_attention(
                q, k, v, pos, window=window, softcap=softcap),
            q, k, v, positions, policy)
    # decode or prefill_resume: the reference writes by a one-hot select or
    # a dynamic_update_slice into a new buffer; the port overwrites the
    # rows' slots of the cache in place
    at = torch.remainder(positions, sbuf) if window else positions
    for n, t in store.items():
        _write_slots(kv[n], at, t, policy)
    if "k_s" in kv:
        ck = _kv_dequantize(kv["k"], kv["k_s"], q.dtype)
        cv = _kv_dequantize(kv["v"], kv["v_s"], q.dtype)
    else:
        ck, cv = kv["k"], kv["v"]
    if mode == "decode":
        # the flash-decoding layout (transformer.py:528-529): the buffer's
        # sequence dim on "model" with ``shard_kv_seq``
        kv_seq = "model" if (policy is not None
                             and policy.shard_kv_seq) else None
        ck = constrain(ck, policy, ("pod", "data"), kv_seq, None, None)
        cv = constrain(cv, policy, ("pod", "data"), kv_seq, None, None)
        return ops.decode_attention(q, ck, cv, *slots, softcap=softcap)
    # causal mask kv_pos <= q_pos hides the chunk's future tokens and
    # whatever sits above the prefill front
    return ops.chunk_attention(q, ck, cv, positions, softcap=softcap)


def attn_layer(cfg, p, x, kv, pos0, *, mode: str, rows: bool = False,
               slots=None, m2: bool = True, window: int = 0, policy=None,
               remat: bool = False, place: str = "carry"):
    """x: (B, S, d). kv: this layer's {'k', 'v'} cache views (and
    {'k_s', 'v_s'} with an int8 cache), updated in place (None in "train").
    pos0: (B,) int64 start positions on x's device (all 0 for "prefill"
    and "train"). mode: "decode" (one token at
    pos0), "prefill" (from 0), "prefill_resume" (an S-token chunk at pos0,
    attending over the whole buffer) or "train" (from 0, no cache: the
    plain ``chunked_attention`` on every device, as the reference trains,
    transformer.py:495-498; the attention kernels have no backward).
    ``rows``: the batch rows are separate requests: per-row FFN
    active sets, and the products and norms run one row at a time.
    ``m2``: the FFN as :func:`_ffn_apply` picks it.
    ``slots``: :func:`decode_slots` of pos0 (decode only). A parallel block
    (transformer.py:625-627) feeds the FFN the normed ``h`` that fed QKV
    and adds both outputs to x. The attention takes ``cfg.logit_softcap``
    and a sliding window, ``cfg.window_size`` or else ``window``: with a
    window the cache is a ring, a prompt writes its last ``sbuf`` tokens to
    their slots and a decode step slot ``pos mod sbuf`` (transformer.py:502,
    603-609). An int8 cache (transformer.py:499-620) takes each written
    token's K and V quantized (:func:`_kv_quantize`); a prompt attends over
    its own unquantized K/V, a decode step or a chunk over the buffer
    dequantized to fp32.
    ``policy`` (a ``sharding.ShardingPolicy``) constrains K/V (and a
    decode step's q and buffer) where the reference does
    (transformer.py:493-494, 513-531), a no-op on plain tensors.
    ``remat`` (train, a parallel block with the dense GLU only): the layer
    checkpoints itself (``forward``'s ``remat``). ``place``: the layer's
    place in the layer pattern, which places its M2Cache FFN on a mesh
    (``core.mp_ffn.mp_ffn_apply``).
    Returns (y, active ids: (k,) or (B, k) with ``rows``, the MoE router's
    load-balance loss: 0.0 for another FFN, a (B,) tensor with
    ``rows``)."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    batch = ("pod", "data")

    def dense(fn, t):
        """The products and norms of separate requests: one row at a time."""
        return each_row(fn, t) if rows else fn(t)

    def attend(t):
        return _attention(cfg, p, t, kv, pos0, mode=mode, rows=rows,
                       slots=slots, window=window, policy=policy)
    if remat and cfg.parallel_block:
        # the backward pass recomputes the layer up to its two closing
        # products, whose outputs it never reads, as the reference's remat
        # leaves them out (a recompute stops at the last tensor it saves)
        f = p["ffn"]

        def body(t):
            h, a = attend(t)
            return a, glu_hidden(_tp_input(h, policy), f["wg"], f["wu"],
                                 cfg.ffn_act)
        a, hidden = checkpoint(body, x, use_reentrant=False)
        y = x + a @ p["wo"] + glu_down(hidden, f["wd"])
        return y, torch.zeros((0,), dtype=torch.int32, device=x.device), 0.0
    h, attn_out = attend(x)
    attn_out = dense(lambda t: t @ p["wo"], attn_out)

    def ffn(t):
        return _ffn_apply(cfg, p["ffn"], t, m2=m2, rows=rows, policy=policy,
                          place=place)
    if cfg.parallel_block:
        ffn_out, idx, lb = ffn(h)
        y = x + attn_out + ffn_out
    else:
        x = x + attn_out
        ffn_out, idx, lb = ffn(dense(
            lambda t: _norm(cfg, t, p["norm2"], policy), x))
        y = x + ffn_out
    return y, idx, lb


def _attention(cfg, p, x, kv, pos0, *, mode, rows, slots, window, policy):
    """:func:`attn_layer`'s attention half: (the normed input, the
    attention's output (B, S, hq * hd) before ``wo``)."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    batch = ("pod", "data")

    def dense(fn, t):
        """The products and norms of separate requests: one row at a time."""
        return each_row(fn, t) if rows else fn(t)

    def norm_qkv(t):
        h = _norm(cfg, t, p["norm1"], policy)
        qkv = h @ p["wqkv"]
        if cfg.qkv_bias:
            qkv = qkv + p["bqkv"].to(qkv.dtype)
        # column-parallel, as its gradient must come back for the weight's
        return h, constrain(qkv, policy, batch, None, "model")
    h, qkv = dense(norm_qkv, x)
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)

    positions = pos0[:, None] + torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    cap, w_eff = cfg.logit_softcap, cfg.window_size or window
    # q, K and V replicated over "model" (a decode step's q as the
    # reference's, transformer.py:522-524; K/V before a prompt's attention,
    # :486-494): a prompt's attention then takes its heads from them
    # (_sharded_attention)
    q = constrain(q, policy, batch, None, None, None)
    k = constrain(k, policy, batch, None, None, None)
    v = constrain(v, policy, batch, None, None, None)
    if mode == "train":
        attn_out = _sharded_attention(
            lambda q, k, v, pos: chunked_attention(
                q, k, v, pos, pos, window=w_eff, softcap=cap),
            q, k, v, positions, policy)
    else:
        attn_out = _cached_attention(q, k, v, kv, positions, mode=mode,
                                     window=w_eff, slots=slots, softcap=cap,
                                     policy=policy)

    # the output's heads on "model", as the row-parallel wo reads them
    attn_out = constrain(attn_out, policy, batch, None, "model", None)
    return h, attn_out.reshape(B, S, hq * hd)


def _ffn_apply(cfg, p_ffn, x, *, m2: bool, rows: bool, policy=None,
               place: str = "carry"):
    """A layer's FFN (the reference's ``_ffn_apply``, transformer.py:
    414-432): the MoE experts, the M2Cache FFN where ``m2`` and the layer
    has banks, else the dense GLU; ``rows``, ``policy`` (the MoE
    dispatch's batch shards) and ``place`` as in :func:`attn_layer`.
    Returns (y, active ids (empty but for the M2Cache FFN), the MoE
    load-balance loss or 0.0)."""
    def dense(fn, t):
        return each_row(fn, t) if rows else fn(t)
    x = _tp_input(x, policy)
    empty = torch.zeros((x.shape[0], 0) if rows else (0,), dtype=torch.int32,
                        device=x.device)
    if cfg.num_experts:
        y, lb = dense(lambda t: _moe_apply(cfg, p_ffn, t, policy), x)
        return y, empty, lb if rows else lb[0]
    if m2 and "banks" in p_ffn:
        y, info = mp.mp_ffn_apply(cfg, p_ffn["banks"], p_ffn["pred"], x,
                                  rows=rows, place=place)
        return y, info["active_idx"], 0.0
    y = dense(lambda t: glu_ffn(t, p_ffn["wg"], p_ffn["wu"], p_ffn["wd"],
                                cfg.ffn_act), x)
    return y, empty, 0.0


def _moe_apply(cfg, p_ffn, x, policy=None):
    """An MoE layer's FFN (the reference's ``_ffn_apply``, transformer.py:
    417-426): (y, the router's load-balance loss as a (1,) tensor). The
    per-expert predictor leaves are not read."""
    shared = None
    if cfg.shared_expert_d_ff:
        shared = (p_ffn["shared_wg"], p_ffn["shared_wu"], p_ffn["shared_wd"])
    y, aux = moe.moe_ffn(
        x, p_ffn["router"], p_ffn["wg"], p_ffn["wu"], p_ffn["wd"],
        num_experts_per_tok=cfg.num_experts_per_tok,
        capacity_factor=cfg.moe_capacity_factor, act_name=cfg.ffn_act,
        shared=shared, policy=policy)
    return y, aux["lb_loss"].reshape(1)


def rglru_layer(cfg, p, x, state, *, rows: bool = False, m2: bool = True,
                policy=None, place: str = "carry"):
    """An RG-LRU layer (transformer.py:636-643): x: (B, S, d); state: this
    layer's {'h', 'conv'} cache views, updated in place (None: no cache).
    ``rows``, ``m2`` and ``place`` as in :func:`attn_layer`.
    Returns (y, active ids, 0.0)."""
    def dense(fn, t):
        return each_row(fn, t) if rows else fn(t)
    h = dense(lambda t: _norm(cfg, t, p["norm1"], policy), x)
    mix, new_state = hybrid.rglru_block(cfg, p, h, state, rows=rows,
                                        policy=policy)
    if state is not None:
        state["h"].copy_(new_state["h"])
        state["conv"].copy_(new_state["conv"])
    x = x + mix
    h2 = dense(lambda t: _norm(cfg, t, p["norm2"], policy), x)
    y, idx, lb = _ffn_apply(cfg, p["ffn"], h2, m2=m2, rows=rows,
                            policy=policy, place=place)
    return x + y, idx, lb


def ssm_layer(cfg, p, x, state, *, mode: str, rows: bool = False,
              policy=None):
    """An SSD layer (transformer.py:646-649): norm1, the Mamba-2 block, the
    residual; no FFN. x: (B, S, d); state: this layer's {'h', 'conv'}
    cache views, updated in place (None: no cache). ``rows`` as in
    :func:`attn_layer`. Returns (y, empty active ids: (0,), or (B, 0) with
    ``rows``, 0.0)."""
    def block(t, st):
        h = _norm(cfg, t, p["norm1"], policy)
        y, new = ssm.ssm_block(cfg, p, h, st, mode=mode, policy=policy)
        for k in st or {}:
            st[k].copy_(new[k])
        return y
    if rows and x.shape[0] > 1:
        mix = torch.cat([block(x[r:r + 1], None if state is None else
                               {k: v[r:r + 1] for k, v in state.items()})
                         for r in range(x.shape[0])])
    else:
        mix = block(x, state)
    empty = torch.zeros((x.shape[0], 0) if rows else (0,), dtype=torch.int32,
                        device=x.device)
    return x + mix, empty, 0.0


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_tokens(cfg, params, tokens, policy=None):
    """The tokens' embeddings; with a ``policy`` each lookup of a
    vocab-sharded table (a masked partial sum) is reduced before another
    touches it (:func:`_tp_input`)."""
    if cfg.family == "audio":
        # tokens (B, K, S): the K codebooks' embeddings summed in codebook
        # order (transformer.py:670-676)
        tokens = tokens.long()

        def lookup(k):
            return _tp_input(F.embedding(tokens[:, k], params["embed"][k]),
                             policy)
        x = lookup(0)
        for k in range(1, tokens.shape[1]):
            x = x + lookup(k)
        return x
    # the gather as ``embedding``: DTensor places its lookup and gradient
    # over a vocab-sharded table (an index's gradient it may not)
    x = _tp_input(F.embedding(tokens.long(), params["embed"]), policy)
    if cfg.family == "hybrid":                  # gemma-style scale
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(cfg, params, x):
    if cfg.family == "audio":                   # bsd,kdv->bksv
        return x[:, None] @ params["unembed"][None]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    if sharded_on(table, "model", 0) or sharded_on(table, "model", 1):
        # on a mesh, placed as GSPMD places it (the vocab on "model", or
        # the features where the axis does not divide the vocab); a tied
        # table's two gradients (this and the lookup's) then share their
        # placements, where DTensor's own choice can leave two it cannot add
        return placed_product(x, table.T)
    return x @ table.T


# ---------------------------------------------------------------------------
# Full forward


def forward(cfg, params, tokens, *, prefix=None, cache=None,
            mode: str = "train", m2: bool = True, rows: bool = False,
            remat: bool = False, window: int = 0, policy=None):
    """Returns (logits, cache, aux); ``cache`` is updated in place.

    tokens: (B, S) integer ids, (B, K, S) for the audio family's K
    codebooks. prefix: (B, N, d) precomputed frontend embeddings (vlm
    patches, audio conditioning frames), prepended outside decode: they
    fill the cache's first N slots of the run and get no logits
    (transformer.py: 711-714, 775-776). mode: train | prefill |
    prefill_resume | decode. "train" takes no cache and runs under the
    caller's autograd mode (``remat``: each pattern repeat recomputed in
    the backward pass, ``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` of each, transformer.py:739-740; no remainder
    layer);
    the serving modes take a cache and run under ``no_grad``. decode and
    prefill_resume start each row at its ``cache["pos"]`` (prefill_resume
    raises on a sliding window or a recurrent layer, as the reference
    asserts, transformer.py:559-561). Logits are (B, S, V), (B, K, S, V)
    for audio. Layers run in layer order, each by its kind
    (transformer.py:715-790). A sliding window's ring lets a prompt or a
    decode step run past its ``sbuf`` slots. ``m2``: an FFN with banks
    runs as the M2Cache FFN (the reference's default is False; the port's
    serving params always have banks), a dense one as the GLU whatever
    ``m2`` says. ``window`` > 0 (the reference's long-context override,
    launch/steps.py's long_500k) gives a model without a window of its own
    a sliding window of that many positions: train mode attends within it,
    and the serving modes take a cache built with the same ``window``
    (:func:`init_cache`), a ring. A cache built with ``kv_quant`` holds
    int8 K/V (:func:`attn_layer`).
    ``rows``: every batch row is its own request, with its own FFN active
    sets, and gives the bits it gives alone — what the reference computes
    by vmapping a one-row forward; an MoE layer's capacity is then counted
    over the row alone, as the reference's is. ``rows`` with ``window`` or
    an int8 cache raises NotImplementedError: no path of the reference
    runs them in its server.
    aux["active_idx"] is ``{"pattern": [(F, k) tensor per pattern
    position], "remainder": [(k,) tensor per remainder layer]}``, the
    reference's structure; with ``rows`` (B, F, k) and (B, k), the
    reference's vmapped layout. MoE, SSD and dense-FFN layers have no
    active neurons: their entries are (F, 0), (B, F, 0) with ``rows``.
    aux["lb_loss"] sums the MoE layers' load-balance losses (0.0 without
    MoE; (B,) with ``rows``).
    ``policy``: a ``sharding.ShardingPolicy`` whose activation constraints
    (the residual after the embedding and after each pattern repeat, K/V,
    a decode step's q and buffer: transformer.py:493-531, 719, 736) apply
    to DTensor activations; on plain tensors it changes nothing. Rows mode
    takes none."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "prefill_resume", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "train") != (cache is None):
        raise ValueError(f"mode {mode!r} takes "
                         + ("no cache" if mode == "train" else "a cache"))
    if rows and (window or (cache is not None and any(
            "k_s" in e for e in cache["pattern"] + cache["remainder"]))):
        raise NotImplementedError(
            "rows (the server's stacked requests) with the window= override "
            "or an int8 K/V cache: the reference's server runs neither")
    grad = contextlib.nullcontext() if mode == "train" else torch.no_grad()
    with grad:
        return _forward(cfg, params, tokens, prefix, cache, mode,
                        m2 and cfg.m2_enabled, rows, remat, window, policy)


def _forward(cfg, params, tokens, prefix, cache, mode, m2, rows, remat,
             window, policy):
    pat, F, rem = pattern_split(cfg)
    w_eff = cfg.window_size or window
    if mode == "prefill_resume" and (w_eff or set(pat) - {"attn"}):
        raise NotImplementedError(
            "prefill_resume does not support sliding-window attention or "
            "recurrent layers")
    x = embed_tokens(cfg, params, tokens, policy)
    n_prefix = 0
    if prefix is not None and mode != "decode":
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
        n_prefix = prefix.shape[1]
    B, S = x.shape[:2]
    act = (("pod", "data"), None, "model")
    x = constrain(x, policy, *act)
    slots = None
    if cache is None:
        pos0 = torch.zeros(B, dtype=torch.int64, device=x.device)
    else:
        sbuf = kv_slots(cache)
        pos = 0 if mode == "prefill" else cache["pos"]
        # an int position is known on the host without a read (a traced
        # step's tensors hold no data); a per-row tensor is read
        lo, hi = ((int(pos.min()), int(pos.max()))
                  if isinstance(pos, torch.Tensor) else (int(pos), int(pos)))
        if lo < 0 or (sbuf is not None and not w_eff and hi + S > sbuf):
            shown = pos.tolist() if isinstance(pos, torch.Tensor) else pos
            raise ValueError(f"{mode} of {S} token(s) at positions "
                             f"{shown} outside the cache buffer of "
                             f"{sbuf} slots")
        pos0 = row_positions({"pos": pos}, B).to(x.device)
        if mode == "decode" and sbuf is not None:
            slots = decode_slots(pos0, sbuf, bool(w_eff))

    def layer(l, place, x):
        c = None if cache is None else layer_cache(cfg, cache, l)
        kind, p = cfg.layer_kinds[l], params["layers"][l]
        if kind == "attn":
            return attn_layer(cfg, p, x, c, pos0, mode=mode, rows=rows,
                              slots=slots, m2=m2, window=window,
                              policy=policy, place=place)
        if kind == "rglru":
            return rglru_layer(cfg, p, x, c, rows=rows, m2=m2, policy=policy,
                               place=place)
        return ssm_layer(cfg, p, x, c, mode=mode, rows=rows, policy=policy)

    n = len(pat)

    def repeat(first, x):
        """The pattern repeat from layer ``first``, its layers inline (the
        reference's ``super_block``): (x, [(active ids, lb loss)] a
        layer)."""
        outs = []
        for l in range(first, first + n):
            x, idx, lb = layer(l, "carry" if l == first + n - 1 else "scan",
                               x)
            outs.append((idx, lb))
        return constrain(x, policy, *act), outs

    # ``remat`` recomputes a pattern repeat as a whole, and no remainder
    # layer (as the reference's jax.checkpoint of its super_block)
    idxs, lb_acc = [], 0.0
    for first in range(0, F * n, n):
        p = params["layers"][first]
        if remat and pat == ("attn",) and cfg.parallel_block \
                and "wd" in p["ffn"] and not (m2 and "banks" in p["ffn"]):
            x, idx, lb = attn_layer(cfg, p, x, None, pos0, mode=mode,
                                    m2=m2, window=window, policy=policy,
                                    remat=True)
            x, outs = constrain(x, policy, *act), [(idx, lb)]
        elif remat:
            x, outs = checkpoint(repeat, first, x, use_reentrant=False)
        else:
            x, outs = repeat(first, x)
        for idx, lb in outs:
            idxs.append(idx)
            lb_acc = lb_acc + lb
    for l in range(F * n, len(cfg.layer_kinds)):
        x, idx, lb = layer(l, "remainder", x)
        idxs.append(idx)
        lb_acc = lb_acc + lb

    def head(t):
        t = _norm(cfg, t, params["final_norm"], policy)
        logits = unembed(cfg, params, t[:, n_prefix:])
        # vocab-parallel, as its gradient must come back for the table's
        return constrain(logits, policy, act[0],
                         *[None] * (logits.dim() - 2), "model")
    logits = each_row(head, x) if rows else head(x)
    if cache is not None:
        cache["pos"] = cache["pos"] + (1 if mode == "decode" else S)

    def stacked(i):
        """Pattern position i's active ids over the F repeats."""
        if F == 0:
            return torch.zeros((B, 0, 0) if rows else (0, 0),
                               dtype=torch.int32, device=x.device)
        return torch.stack(idxs[i:F * n:n], dim=1 if rows else 0)
    aux = {"lb_loss": lb_acc,
           "active_idx": {"pattern": [stacked(i) for i in range(n)],
                          "remainder": idxs[F * n:]}}
    return logits, cache, aux


# ---------------------------------------------------------------------------
# Loss


def lm_loss(cfg, params, batch, *, remat: bool = True, m2: bool = False,
            window: int = 0, policy=None):
    """Next-token cross entropy plus 0.01 x the MoE load-balance loss
    (transformer.py:796-815), from a train-mode :func:`forward`. batch:
    {"tokens": (B, S) ids, (B, K, S) for audio (targets (B, K, S-1)),
    optionally "prefix": (B, N, d)}, tensors on the params' device.
    ``policy`` as :func:`forward` takes it. Returns (total, {"nll",
    "lb_loss"})."""
    tokens = batch["tokens"]
    logits, _, aux = forward(cfg, params, tokens, prefix=batch.get("prefix"),
                             mode="train", remat=remat, m2=m2, window=window,
                             policy=policy)
    if cfg.family == "audio":
        tgt, lg = tokens[..., 1:], logits[..., :-1, :]
    else:
        tgt, lg = tokens[:, 1:], logits[:, :-1, :]
    logp = torch.log_softmax(lg.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    loss = nll.mean()
    lb = aux["lb_loss"]
    return loss + 0.01 * lb, {"nll": loss, "lb_loss": lb}
