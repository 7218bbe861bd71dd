"""The device dispatch of the port's kernels.

A tensor on the CPU goes to the plain PyTorch version; any other tensor
goes to the hand-written CUDA kernel, whose wrapper raises on what it does
not take. Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.qmatmul import qmatmul_gathered
from repro_torch.models.common import activation, chunked_attention

#: (kernel precision, tier name in tier_sizes, bank suffix), in rank order
_TIERS = (("fp", "fp16", "_fp"), ("int8", "int8", "_i8"),
          ("int4", "int4", "_i4"))


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def mp_ffn(x, banks: Dict[str, torch.Tensor], idx, sizes: Dict[str, int],
           act_name: str):
    """Sparse mixed-precision GLU FFN over the model's banks.
    x: (B, S, d); idx: (k,) rank-sorted active neurons. Returns (B, S, d).

    On the card each tier runs gate and up through the col kernel, the
    activation in PyTorch, and down through the row kernel, which adds into
    one (B*S, d) output: 9 kernel launches per layer."""
    if _on_cpu(x):
        return ref.mp_ffn_gathered_ref(x, banks, idx, sizes, act_name)
    B, S, d = x.shape
    x2 = x.reshape(B * S, d).contiguous()
    idx32 = idx.to(torch.int32)
    act = activation(act_name)
    y = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    start = 0
    for precision, tier, suffix in _TIERS:
        n = sizes[tier]
        if n == 0:
            continue
        t_idx = idx32[start:start + n]
        start += n

        def call(w, x_in, layout, out=None):
            scale = None if precision == "fp" else banks[f"{w}{suffix}_s"]
            return qmatmul_gathered(x_in, banks[f"{w}{suffix}"], scale, t_idx,
                                    precision=precision, layout=layout,
                                    out=out)

        h = act(call("wg", x2, "col")) * call("wu", x2, "col")
        call("wd", h, "row", out=y)
    return y.reshape(B, S, d)


def decode_attention(q, k, v, q_pos, kv_pos, kv_valid):
    """One query token per row over the cache buffer, causal by absolute
    position and restricted to ``kv_valid`` slots.
    q: (B, 1, Hq, D); k, v: (B, S, Hkv, D); q_pos: (B, 1); kv_pos and
    kv_valid: (B, S). Returns (B, 1, Hq, D)."""
    if _on_cpu(q):
        return chunked_attention(q, k, v, q_pos, kv_pos, kv_valid=kv_valid)
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    slots = torch.where(kv_valid, kv_pos, torch.full_like(kv_pos, -1))
    out = flash_decode(q.reshape(B, Hkv, Hq // Hkv, D).contiguous(),
                       k.contiguous(), v.contiguous(),
                       slots.to(torch.int32).contiguous(),
                       q_pos[:, 0].to(torch.int32).contiguous())
    return out.reshape(B, 1, Hq, D)


def prefill_attention(q, k, v, positions):
    """Causal self-attention over a prompt that starts at position 0.
    q: (B, S, Hq, D); k, v: (B, S, Hkv, D); positions: (B, S)."""
    if _on_cpu(q):
        return chunked_attention(q, k, v, positions, positions)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
