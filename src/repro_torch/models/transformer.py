"""Model assembly, dense attention family with the M2Cache FFN
(``repro/models/transformer.py``'s serving path).

Parameters are plain dictionaries of tensors with the reference's leaf
names; where the reference stacks the layers of one pattern position on a
leading axis for ``lax.scan``, the port keeps one dictionary per layer in
``params["layers"]`` and runs them in a Python loop. The KV cache keeps the
reference's layout, ``{"pattern": [{"k", "v": (F, B, S, kvH, Dh)}],
"remainder": [], "pos": int}``, and is updated in place.

Ported so far: dense attention layers, ``mode`` "prefill" and "decode",
``m2=True``. Other families, windows, logit
softcaps, parallel blocks and the int8 KV cache raise NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import mp_ffn as mp
from repro_torch.core.quantize import build_neuron_banks
from repro_torch.kernels import ops
from repro_torch.models.common import apply_norm, rope

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


def check_supported(cfg, *, m2: bool = True):
    """Raise NotImplementedError for what the port does not serve yet."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.window_size:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if cfg.logit_softcap:
        raise NotImplementedError("logit softcap is not ported yet")
    if cfg.parallel_block:
        raise NotImplementedError("parallel attention+FFN blocks are not ported")
    if cfg.num_experts:
        raise NotImplementedError("MoE FFNs are not ported yet")
    if not (m2 and cfg.m2_enabled):
        raise NotImplementedError("only the M2Cache FFN (m2=True) is ported")


def _ffn_specs(cfg, dtype) -> Dict:
    """(shape, dtype, kind) of one layer's M2Cache FFN (transformer.py:77-102)."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.m2_predictor_rank
    assert d % 2 == 0 and f % 2 == 0
    i8, f32 = torch.int8, torch.float32
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


def _layer_specs(cfg, dtype) -> Dict:
    """One attention layer (transformer.py:110-124)."""
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {
        "norm1": ((d,), torch.float32, "vector"),
        "wqkv": ((d, (hq + 2 * hkv) * hd), dtype, "col"),
        "wo": ((hq * hd, d), dtype, "row"),
        "ffn": _ffn_specs(cfg, dtype),
    }
    if cfg.qkv_bias:
        out["bqkv"] = (((hq + 2 * hkv) * hd,), torch.float32, "vector")
    out["norm2"] = ((d,), torch.float32, "vector")
    return out


def model_param_specs(cfg, *, dtype=torch.float32) -> Dict:
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    specs = {
        "final_norm": ((d,), torch.float32, "vector"),
        "layers": [_layer_specs(cfg, dtype) for _ in range(cfg.num_layers)],
        "embed": ((V, d), dtype, "vocab"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ((V, d), dtype, "vocab")
    return specs


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[2], str)


def _init_one(spec, gen, device):
    """The reference's init rule (transformer.py:253-260): float vectors and
    replicated leaves start at zero (so the predictor's A is zero), int8
    leaves at zero, everything else N(0, 1/fan_in)."""
    shape, dtype, kind = spec
    if kind in ("vector", "replicated") and len(shape) and dtype != torch.int8:
        return torch.zeros(shape, dtype=dtype, device=device)
    if dtype == torch.int8:
        return torch.zeros(shape, dtype=torch.int8, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def _materialise(tree, gen, device):
    if _is_spec(tree):
        return _init_one(tree, gen, device)
    if isinstance(tree, dict):
        return {k: _materialise(v, gen, device) for k, v in tree.items()}
    return [_materialise(v, gen, device) for v in tree]


@torch.no_grad()
def init_params(cfg, *, seed: int = 0, device=None, dtype=torch.float32,
                generator: torch.Generator = None):
    """Materialise parameters from a ``torch.Generator`` (seeded with ``seed``
    on ``device`` unless one is given), then build every layer's quantized
    banks from its fp weights (transformer.py:298-321). The numbers differ
    from ``jax.random``'s; parity tests carry the reference's params over
    with ``repro_torch.bridge`` instead."""
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    params = _materialise(model_param_specs(cfg, dtype=dtype), gen, device)
    for layer in params["layers"]:
        b = layer["ffn"]["banks"]
        layer["ffn"]["banks"] = build_neuron_banks(b["wg_fp"], b["wu_fp"],
                                                   b["wd_fp"])
    return params


# ---------------------------------------------------------------------------
# Caches


def init_cache(cfg, batch: int, max_seq: int, *, dtype=torch.float32,
               device=None):
    """Zero decode cache in the reference's layout (transformer.py:330-380):
    K and V of all layers of the one pattern position stacked as
    (F, B, S, kvH, Dh)."""
    check_supported(cfg)
    device = resolve_device(device)
    pat, F, rem = pattern_split(cfg)
    shape = (F, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pattern": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}],
        "remainder": [],
        "pos": 0,
    }


# ---------------------------------------------------------------------------
# Layer forward


def attn_layer(cfg, p, x, kv, pos0: int, *, mode: str):
    """x: (B, S, d). kv: this layer's {'k', 'v'} cache views. mode:
    "decode" (one token at ``pos0``) or "prefill" (``pos0`` = 0).
    Returns (y, rank-sorted active neuron ids) and updates ``kv`` in place."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = apply_norm(cfg, x, p["norm1"])
    qkv = h @ p["wqkv"]
    if cfg.qkv_bias:
        qkv = qkv + p["bqkv"].to(qkv.dtype)
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)

    positions = (pos0 + torch.arange(S, device=x.device))[None, :].expand(B, S)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        ck, cv = kv["k"], kv["v"]
        sbuf = ck.shape[1]
        if not 0 <= pos0 < sbuf:
            raise ValueError(f"decode position {pos0} outside the cache "
                             f"buffer of {sbuf} slots")
        # The reference writes the slot by a one-hot select into a new
        # buffer; the port overwrites the slot of the cache in place.
        slot = torch.tensor([pos0], device=x.device)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        kv_pos = torch.arange(sbuf, device=x.device)
        kv_pos_b = kv_pos[None].expand(B, sbuf)
        valid_b = (kv_pos <= pos0)[None].expand(B, sbuf)
        attn_out = ops.decode_attention(q, ck, cv, positions, kv_pos_b,
                                        valid_b)
    else:                                   # prefill, from position 0
        attn_out = ops.prefill_attention(q, k, v, positions)
        kv["k"][:, :S] = k.to(kv["k"].dtype)
        kv["v"][:, :S] = v.to(kv["v"].dtype)

    attn_out = attn_out.reshape(B, S, hq * hd) @ p["wo"]
    x = x + attn_out
    h2 = apply_norm(cfg, x, p["norm2"])
    ffn_out, info = mp.mp_ffn_apply(cfg, p["ffn"]["banks"], p["ffn"]["pred"],
                                    h2)
    return x + ffn_out, info["active_idx"]


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()]


def unembed(cfg, params, x):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return x @ table.T


# ---------------------------------------------------------------------------
# Full forward


@torch.no_grad()
def forward(cfg, params, tokens, *, cache, mode: str, m2: bool = True):
    """Returns (logits, cache, aux); ``cache`` is updated in place.

    tokens: (B, S) integer ids. mode: prefill | decode.
    aux["active_idx"] is ``{"pattern": [(F, k) tensor], "remainder": []}``,
    the reference's structure."""
    check_supported(cfg, m2=m2)
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet")
    x = embed_tokens(cfg, params, tokens)
    pos0 = cache["pos"] if mode == "decode" else 0

    idxs = []
    for l, p in enumerate(params["layers"]):
        kv = {n: cache["pattern"][0][n][l] for n in ("k", "v")}
        x, idx = attn_layer(cfg, p, x, kv, pos0, mode=mode)
        idxs.append(idx)

    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)
    cache["pos"] = cache["pos"] + (1 if mode == "decode" else tokens.shape[-1])
    aux = {"active_idx": {"pattern": [torch.stack(idxs)], "remainder": []}}
    return logits, cache, aux
