"""Operations and bytes of a whole step of the model: every layer's
projections, attention and sparse FFN (with its predictor), then the
unembedding of the positions whose logits the step needs: every row of a
decode step, a prompt's last position (its first token). Weights are read
once a step; a decode step reads each row's K/V before its position and
writes its new K/V; a prefill writes its K/V and the last logits. Activations between kernels are
not counted (a step that kept them on chip would not move them)."""
from __future__ import annotations

from typing import Sequence, Tuple

from portbench.cost.kernels import (BF16, FP32, ffn_weight_bytes,
                                    flash_attention, tier_sizes)


def _layer_fixed(cfg: dict, tokens: int) -> Tuple[float, float]:
    """A layer's work that does not depend on positions, over ``tokens``
    rows: QKV and output projections, predictor, FFN."""
    d, f, r = cfg["d"], cfg["ffn"], cfg["m2"]["predictor_rank"]
    hq, hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    k = tier_sizes(f, cfg["m2"])["k"]
    qkv = d * (hq + 2 * hkv) * D
    wo = hq * D * d
    flops = 2.0 * tokens * (qkv + wo + d * r + r * f + 3 * d * k)
    nbytes = ((qkv + wo) * BF16 + (hq + 2 * hkv) * D * FP32 * cfg["qkv_bias"]
              + 2 * d * FP32 + (d * r + r * f) * FP32 + ffn_weight_bytes(cfg)
              + tokens * hkv * D * BF16 * 2)              # K/V written
    return flops, nbytes


def _head(cfg: dict, tokens: int, positions: int) -> Tuple[float, float]:
    """Embedding lookups of ``tokens`` tokens and the unembedding of
    ``positions`` positions."""
    d, V = cfg["d"], cfg["vocab"]
    flops = 2.0 * positions * d * V
    nbytes = V * d * BF16 + d * FP32 + tokens * d * BF16 \
        + positions * V * BF16
    return flops, nbytes


def decode_step(cfg: dict, positions: Sequence[int]) -> Tuple[float, float]:
    """One token for each row at ``positions`` (each attends position + 1
    slots)."""
    hq, hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    B = len(positions)
    fl, by = _layer_fixed(cfg, B)
    fl += 4.0 * hq * D * float(sum(p + 1 for p in positions))
    by += float(sum(positions)) * hkv * D * BF16 * 2      # K/V read
    hf, hb = _head(cfg, B, B)
    return cfg["layers"] * fl + hf, cfg["layers"] * by + hb


def prefill(cfg: dict, S: int) -> Tuple[float, float]:
    """A whole prompt of S tokens from position 0 to its first token: the
    logits of its last position (the port computes them at every position;
    the rest is not work the first token needs)."""
    fl, by = _layer_fixed(cfg, S)
    hf, hb = _head(cfg, S, 1)
    return cfg["layers"] * (fl + flash_attention(cfg, S)[0]) + hf, \
        cfg["layers"] * by + hb
