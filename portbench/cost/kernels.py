"""Operations and bytes of one call of each kernel the timed path
launches, from the shapes of the call (``chip_smoke.py``'s bounds: bytes
of what the call must read and write once, operations of its products).
Each returns (flops, bytes)."""
from __future__ import annotations

from typing import Sequence, Tuple

from portbench.reference.model import tier_sizes

BF16 = 2
FP32 = 4


def ffn_weight_bytes(cfg: dict) -> float:
    """One layer's active neurons' weights (gate, up, down rows) at their
    tiers' widths, with the int tiers' per-neuron scales."""
    z, d = tier_sizes(cfg["ffn"], cfg["m2"]), cfg["d"]
    rows = z["fp"] * BF16 * d + z["int8"] * d + z["int4"] * d / 2
    return 3 * (rows + (z["int8"] + z["int4"]) * FP32)


def qmatmul_ffn(cfg: dict, M: int) -> Tuple[float, float]:
    """The sparse FFN's qmatmul kernels over one layer at M rows sharing a
    set: gate, up and down products of the k active neurons; each tier's
    rows read once, x (bf16) read once, the output (fp32) written once."""
    z, d = tier_sizes(cfg["ffn"], cfg["m2"]), cfg["d"]
    flops = 2.0 * M * d * z["k"] * 3
    nbytes = ffn_weight_bytes(cfg) + M * d * BF16 + M * d * FP32
    return flops, nbytes


def flash_decode(cfg: dict, lengths: Sequence[int]) -> Tuple[float, float]:
    """One decode attention call over a layer's cache: each row's valid
    K and V slots (``lengths``: slots each row attends, its position + 1)
    read once, q read (bf16), the output written (fp32)."""
    hq, hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    slots = float(sum(lengths))
    flops = 4.0 * hq * D * slots
    nbytes = slots * hkv * D * BF16 * 2 + len(lengths) * hq * D * (BF16 + FP32)
    return flops, nbytes


def flash_attention(cfg: dict, S: int) -> Tuple[float, float]:
    """One whole-prompt causal attention call of S tokens: S(S+1)/2
    query-key pairs, two products of D each per head; q, k, v read and the
    output written once (bf16)."""
    hq, hkv, D = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    pairs = S * (S + 1) / 2
    flops = 4.0 * hq * D * pairs
    nbytes = S * D * BF16 * (2 * hq + 2 * hkv)
    return flops, nbytes
