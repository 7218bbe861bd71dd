"""The device dispatch of the port's kernels.

A tensor on the CPU goes to the plain PyTorch version; any other tensor
goes to the hand-written CUDA kernel, whose wrapper raises on what it does
not take. Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.quantize import quantize_int4, quantize_int8
from repro_torch.kernels import qmatmul as qmm
from repro_torch.kernels import ref
from repro_torch.kernels.atu_update import atu_update as atu_update_kernel
from repro_torch.kernels.chunk_attention import chunk_attention as chunk_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.qmatmul import (ffn_down_bf16, glu_bf16,
                                         qmatmul_gathered)
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
    or (B, k), one set per row. Returns (B, S, d) in x's dtype.

    On the card each tier runs gate and up through the col kernel, the
    activation in PyTorch, and down through the row kernel, which adds into
    one fp32 output: 9 kernel launches per layer whatever the row count.
    At bf16 the gate and up products are rounded to bf16 before the
    activation and the product h, as the reference's einsums round them, h
    goes to the down kernel in bf16, and the sum is rounded to bf16 once at
    the end. A bf16 FFN whose rows take kernel A (M <= 4 a row) runs the
    same arithmetic, to the bit, in 5 launches: one fused GLU for the tiers
    (``glu_bf16``, every activation of ``models.common``), then the three
    down products and their sum (``ffn_down_bf16``). The kernel has no
    backward: an input that requires grad raises there."""
    if _on_cpu(x):
        return ref.mp_ffn_gathered_ref(x, banks, idx, sizes, act_name)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in banks.values())):
        raise ValueError("the qmatmul kernels have no backward: run the "
                         "M2Cache FFN on the card under torch.no_grad()")
    B, S, d = x.shape
    if idx.dim() == 1:                      # one set: the batch is one row
        x3, idx2 = x.reshape(1, B * S, d), idx[None]
    else:
        x3, idx2 = x, idx
    x3 = x3.contiguous()
    idx32 = idx2.to(torch.int32)
    M = x3.shape[1]
    if x.dtype == torch.bfloat16 and M <= min(qmm.GEMV_MAX_M, qmm.GLU_MAX_M):
        return _mp_ffn_fused(x3, banks, idx32, sizes, act_name).reshape(
            B, S, d)
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

        h = act(call("wg", x3, "col").to(x.dtype)) * \
            call("wu", x3, "col").to(x.dtype)
        call("wd", h, "row", out=y)
    return y.reshape(B, S, d).to(x.dtype)


def _mp_ffn_fused(x3, banks, idx32, sizes, act_name):
    """:func:`mp_ffn` of bf16 x3 (R, M, d) at small M over idx32 (R, k): one
    fused GLU launch for the tiers, then their down products summed in one
    more. Returns (R, M, d) bf16."""
    start, tiers, downs = 0, [], []
    for precision, tier, suffix in _TIERS:
        n = sizes[tier]
        if n == 0:
            continue
        t_idx = idx32[:, start:start + n].contiguous()
        start += n
        sg, su, sd = ((None,) * 3 if precision == "fp" else
                      (banks[f"{w}{suffix}_s"] for w in ("wg", "wu", "wd")))
        tiers.append((precision, banks[f"wg{suffix}"], banks[f"wu{suffix}"],
                      sg, su, t_idx))
        downs.append((banks[f"wd{suffix}"], sd, t_idx, precision))
    if not tiers:
        return torch.zeros(x3.shape, dtype=x3.dtype, device=x3.device)
    hs = glu_bf16(x3, tiers, act=act_name)
    return ffn_down_bf16([(h, w, s, i, p) for h, (w, s, i, p)
                          in zip(hs, downs)])


def make_compact_banks(wg, wu, wd, sizes: Dict[str, int], idx) -> Dict:
    """Compact per-tier banks from dense fp weights and a rank-sorted active
    set (``repro/kernels/ops.py``'s ``make_compact_banks``): neurons
    contiguous per tier; int8/int4 quantized along the contraction axis of
    each product with a per-output scale, int4 packed along the contraction.
    Each matrix is the reference's, transposed to be output-major (``wg``,
    ``wu``: (k, d) [int4 (k, d/2)]; ``wd``: (d, k) [int4 (d, k/2)] with a
    (d,) scale), so every compact product is the col form."""
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
    return {tier: {k: v.t().contiguous() if k in ("wg", "wu", "wd") else v
                   for k, v in t.items()} for tier, t in out.items()}


def mp_glu_ffn(x, banks: Dict, *, act_name: str = "silu"):
    """x: (B, d); banks: :func:`make_compact_banks`' output. Returns (B, d)
    float32. On the card: per tier, gate, up and down through the col
    form with ``idx=None``, 9 launches in all."""
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


def decode_attention(q, k, v, slots, lengths, *, softcap: float = 0.0):
    """One query token per row over the cache buffer, causal by absolute
    position. q: (B, 1, Hq, D) at positions ``lengths`` (B,) int32; k, v:
    (B, S, Hkv, D); slots: (B, S) int32, each slot's position, -1 where it
    takes no part (``models/transformer.decode_slots``, built once per
    forward; a sliding window's ring holds only positions inside it, so
    the window needs no mask of its own). ``softcap`` > 0: the logit softcap on the scaled scores,
    before the mask (here and in the two prefill forms). Returns
    (B, 1, Hq, D) in q's dtype."""
    if _on_cpu(q):
        return chunked_attention(q, k, v, lengths[:, None], slots,
                                 softcap=softcap, kv_valid=slots >= 0)
    B, _, Hq, D = q.shape
    out = flash_decode(q.reshape(B, k.shape[2], Hq // k.shape[2], D), k, v,
                       slots, lengths, softcap=softcap)
    # the kernel writes fp32, as the Pallas kernel does; the model goes on
    # in q's dtype, as the plain attention returns it
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def prefill_attention(q, k, v, positions, *, window: int = 0,
                      softcap: float = 0.0):
    """Causal self-attention over a prompt that starts at position 0,
    within a sliding ``window`` where one is given (a key sees the query
    when it lies fewer than ``window`` positions before it).
    q: (B, S, Hq, D); k, v: (B, S, Hkv, D); positions: (B, S)."""
    if _on_cpu(q):
        return chunked_attention(q, k, v, positions, positions, window=window,
                                 softcap=softcap)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=window, softcap=softcap)


def chunk_attention(q, k, v, positions, *, softcap: float = 0.0):
    """An S-token prefill chunk over the whole cache buffer, causal by
    absolute position. q: (B, S, Hq, D) at ``positions`` (B, S), which run
    from each row's start; k, v: (B, Sbuf, Hkv, D), slot j at position j."""
    if _on_cpu(q):
        return ref.chunk_attention_ref(q, k, v, positions[:, 0],
                                       softcap=softcap)
    return chunk_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                        positions[:, 0].to(torch.int32).contiguous(),
                        softcap=softcap)
