"""The device dispatch of the port's kernels.

A tensor on the CPU goes to the plain PyTorch version; any other tensor
goes to the hand-written CUDA kernel, whose wrapper raises on what it does
not take. Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.quantize import quantize_int4, quantize_int8
from repro_torch.kernels import ref
from repro_torch.kernels.atu_update import atu_update as atu_update_kernel
from repro_torch.kernels.chunk_attention import chunk_attention as chunk_kernel
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
    x: (B, S, d); idx: (k,) rank-sorted active neurons shared by the batch,
    or (B, k), one set per row. Returns (B, S, d).

    On the card each tier runs gate and up through the col kernel, the
    activation in PyTorch, and down through the row kernel, which adds into
    one output: 9 kernel launches per layer whatever the row count."""
    if _on_cpu(x):
        return ref.mp_ffn_gathered_ref(x, banks, idx, sizes, act_name)
    B, S, d = x.shape
    if idx.dim() == 1:                      # one set: the batch is one row
        x3, idx2 = x.reshape(1, B * S, d), idx[None]
    else:
        x3, idx2 = x, idx
    x3 = x3.contiguous()
    idx32 = idx2.to(torch.int32)
    act = activation(act_name)
    y = torch.zeros(x3.shape, dtype=torch.float32, device=x.device)
    start = 0
    for precision, tier, suffix in _TIERS:
        n = sizes[tier]
        if n == 0:
            continue
        t_idx = idx32[:, start:start + n].contiguous()
        start += n

        def call(w, x_in, layout, out=None):
            scale = None if precision == "fp" else banks[f"{w}{suffix}_s"]
            return qmatmul_gathered(x_in, banks[f"{w}{suffix}"], scale, t_idx,
                                    precision=precision, layout=layout,
                                    out=out)

        h = act(call("wg", x3, "col")) * call("wu", x3, "col")
        call("wd", h, "row", out=y)
    return y.reshape(B, S, d)


def make_compact_banks(wg, wu, wd, sizes: Dict[str, int], idx) -> Dict:
    """Compact per-tier banks from dense fp weights and a rank-sorted active
    set (``repro/kernels/ops.py``'s ``make_compact_banks``): neurons
    contiguous per tier; int8/int4 quantized along the contraction axis of
    each product with a per-output scale, int4 packed along the contraction
    (``wd``: (k4/2, d) with a (d,) scale) — the col layout throughout."""
    k16, k8, k4 = sizes["fp16"], sizes["int8"], sizes["int4"]
    idx = idx.long()
    i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:k16 + k8 + k4]
    out = {}
    if k16:
        out["fp"] = {"wg": wg[:, i16], "wu": wu[:, i16], "wd": wd[i16, :]}
    for tier, n, sel, quant in (("int8", k8, i8, quantize_int8),
                                ("int4", k4, i4, quantize_int4)):
        if not n:
            continue
        g, sg = quant(wg[:, sel], 0)
        u, su = quant(wu[:, sel], 0)
        dq, sd = quant(wd[sel, :], 0)
        out[tier] = {"wg": g, "wu": u, "wd": dq, "sg": sg, "su": su, "sd": sd}
    return out


def mp_glu_ffn(x, banks: Dict, *, act_name: str = "silu"):
    """x: (B, d); banks: :func:`make_compact_banks`' output. Returns (B, d)
    float32. On the card: per tier, gate, up and down through the col
    kernel with ``idx=None``, 9 launches in all."""
    if _on_cpu(x):
        return ref.mp_glu_ffn_ref(x, banks, act_name)
    x = x.contiguous()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    act = activation(act_name)
    for tier, t in banks.items():
        hg = qmatmul_gathered(x, t["wg"], t.get("sg"), precision=tier)
        hu = qmatmul_gathered(x, t["wu"], t.get("su"), precision=tier)
        y += qmatmul_gathered((act(hg) * hu).contiguous(), t["wd"], t.get("sd"),
                              precision=tier)
    return y


def atu_update(bank, unit, src_idx, dst_idx, *, bg: int = 8):
    """Copy ``bg``-column groups of ``bank`` into ``unit`` in place (the ATU
    cache-unit update); returns ``unit``."""
    if _on_cpu(bank):
        return ref.atu_update_ref(bank, unit, src_idx, dst_idx, bg=bg)
    return atu_update_kernel(bank, unit, src_idx.to(torch.int32).contiguous(),
                             dst_idx.to(torch.int32).contiguous(), bg=bg)


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


def chunk_attention(q, k, v, positions):
    """An S-token prefill chunk over the whole cache buffer, causal by
    absolute position. q: (B, S, Hq, D) at ``positions`` (B, S), which run
    from each row's start; k, v: (B, Sbuf, Hkv, D), slot j at position j."""
    if _on_cpu(q):
        return ref.chunk_attention_ref(q, k, v, positions[:, 0])
    return chunk_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                        positions[:, 0].to(torch.int32).contiguous())
