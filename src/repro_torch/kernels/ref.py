"""Plain PyTorch versions of every kernel of the port (the counterparts of
``repro/kernels/ref.py``'s oracles, plus the gathered sparse FFN).

On the CPU the port computes with these; on the card ``chip_smoke.py``
holds each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.quantize import unpack_int4
from repro_torch.models.common import activation, chunked_attention, reduced


def _unpack_rows(w):
    """(half, n) packed int8 -> (2*half, n) int8, low nibble = even row."""
    return unpack_int4(w, 0)


def qmatmul_ref(x, w, scale=None, *, precision: str = "fp"):
    """y = x (B, K) @ dequant(w) (K, N) [int4: (K/2, N) packed along K],
    with the per-output-channel scale applied after the product."""
    x = x.float()
    wf = (_unpack_rows(w) if precision == "int4" else w).float()
    y = x @ wf
    if precision in ("int8", "int4") and scale is not None:
        y = y * scale[None, :].float()
    return y


def qmm_gathered_ref(x, w, scale=None, idx=None, *, precision: str = "fp",
                     layout: str = "col", out: Optional[torch.Tensor] = None):
    """Plain version of ``kernels/qmatmul.qmatmul_gathered``: gathers the
    selected neuron rows, dequantizes them and multiplies (same arguments;
    x (R, M, K) with idx (R, n) runs each row with its own set). Both
    layouts read neuron-major banks: col ``w`` (f, K) [int4 (f, K/2)] with
    a per-neuron (output) scale, row ``w`` (f, N) [int4 (f, N/2)] with a
    per-neuron (contraction) scale."""
    if x.dim() == 3:
        ys = [qmm_gathered_ref(x[r], w, scale, None if idx is None else idx[r],
                               precision=precision, layout=layout,
                               out=None if out is None else out[r])
              for r in range(x.shape[0])]
        return out if out is not None else torch.stack(ys)
    if layout not in ("col", "row"):
        raise ValueError(layout)
    x = x.float()
    quant = precision in ("int8", "int4") and scale is not None
    rows = idx.long() if idx is not None else None
    wq = w if rows is None else w.index_select(0, rows)
    wf = (unpack_int4(wq, 1) if precision == "int4" else wq).float()
    s = (scale if rows is None else scale[rows]).float() if quant else None
    if layout == "col":
        y = x @ wf.t()
        return y * s[None, :] if quant else y
    if quant:
        wf = wf * s[:, None]
    y = x @ wf
    return out.add_(y) if out is not None else y


def glu_bf16_ref(gate, up, act_name: str):
    """The fused GLU's epilogue over its fp32 products: h = activation(
    bf16(gate)) * bf16(up), each op of the activation rounded to bf16
    (``models.common``'s forms), bf16."""
    return activation(act_name)(gate.to(torch.bfloat16)) * \
        up.to(torch.bfloat16)


def qmm_glu_ref(x, tiers, *, act_name: str = "silu"):
    """Plain version of ``kernels/qmatmul.glu_bf16``: for each (precision,
    wg, wu, sg, su, idx) tier the gate and up products as
    :func:`qmm_gathered_ref` computes them (fp32), then
    :func:`glu_bf16_ref`. Returns a bf16 (M, n) or (R, M, n) h a tier."""
    return [glu_bf16_ref(
        qmm_gathered_ref(x, wg, sg, idx, precision=precision),
        qmm_gathered_ref(x, wu, su, idx, precision=precision), act_name)
        for precision, wg, wu, sg, su, idx in tiers]


def ffn_down_ref(terms):
    """Plain version of ``kernels/qmatmul.ffn_down_bf16``: each (h, w,
    scale, idx, precision) term's row-form product (:func:`qmm_gathered_ref`,
    fp32), summed in term order from 0 and rounded to bf16 once."""
    y = 0.0
    for h, w, scale, idx, precision in terms:
        y = y + qmm_gathered_ref(h, w, scale, idx, precision=precision,
                                 layout="row")
    return y.to(torch.bfloat16)


def mp_ffn_gathered_ref(x, banks: Dict[str, torch.Tensor], idx,
                        sizes: Dict[str, int], act_name: str):
    """The sparse mixed-precision GLU FFN as ``repro/core/mp_ffn.py`` computes
    it: gather each tier's neurons, dequantize, concatenate, then einsum.
    x: (B, S, d); idx: (k,) rank-sorted active neurons shared by the batch,
    or (B, k), one set per row, each row computed as a batch of one.
    ``banks`` are neuron-major (``core.quantize.to_neuron_major``), so every
    gather is a row gather."""
    if idx.dim() == 2:
        return torch.cat([mp_ffn_gathered_ref(x[r:r + 1], banks, idx[r], sizes,
                                              act_name)
                          for r in range(x.shape[0])])
    k16, k8 = sizes["fp16"], sizes["int8"]
    idx = idx.long()
    i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:]
    compute = x.dtype

    def rows(name, r):
        return banks[name].index_select(0, r)

    def gathered(w):
        """(k, width) dequantized rows of the three tiers of ``w``."""
        fp = rows(f"{w}_fp", i16).to(compute)
        i8w = (rows(f"{w}_i8", i8).to(compute)
               * banks[f"{w}_i8_s"][i8].to(compute)[:, None])
        i4w = (unpack_int4(rows(f"{w}_i4", i4), 1).to(compute)
               * banks[f"{w}_i4_s"][i4].to(compute)[:, None])
        return torch.cat([fp, i8w, i4w], dim=0)
    wg = gathered("wg").t()                     # (d, k)
    wu = gathered("wu").t()
    wd = gathered("wd")                         # (k, d)
    act = activation(act_name)
    h = act(torch.einsum("bsd,dk->bsk", x, wg))
    # (on a mesh the up product's sums are reduced first, as GSPMD does)
    h = h * reduced(torch.einsum("bsd,dk->bsk", x, wu))
    return torch.einsum("bsk,kd->bsd", h, wd)


def mp_glu_ffn_ref(x, banks_compact, act_name: str = "silu"):
    """The composed mixed-precision GLU FFN over compact per-tier banks
    (``ops.make_compact_banks``' neuron-major layout; ``repro/kernels/
    ref.py``'s ``mp_glu_ffn_ref``). x: (B, d) -> (B, d) float32."""
    act = activation(act_name)
    y = 0.0
    for tier, t in banks_compact.items():
        hg = qmm_gathered_ref(x, t["wg"], t.get("sg"), precision=tier)
        hu = qmm_gathered_ref(x, t["wu"], t.get("su"), precision=tier)
        y = y + qmm_gathered_ref(act(hg) * hu, t["wd"], t.get("sd"),
                                 precision=tier)
    return y


def atu_update_ref(bank, unit, src_idx, dst_idx, *, bg: int = 8):
    """Block-group column copies, in group order (a later group naming the
    same destination wins), into ``unit`` in place; returns ``unit``."""
    m = src_idx.shape[0]
    if m % bg or m > unit.shape[1]:
        raise ValueError(f"atu_update: m={m} bg={bg} k={unit.shape[1]}")
    src, dst = src_idx.tolist(), dst_idx.tolist()
    for g in range(m // bg):
        sbase = src[g * bg] // bg * bg
        dbase = dst[g * bg] // bg * bg
        if not (0 <= sbase <= bank.shape[1] - bg
                and 0 <= dbase <= unit.shape[1] - bg):
            raise ValueError(f"atu_update: group {g} ({sbase} -> {dbase}) "
                             "lies outside bank or unit")
        unit[:, dbase:dbase + bg] = bank[:, sbase:sbase + bg].to(unit.dtype)
    return unit


def _cap(s, softcap: float):
    """The attention logit softcap on scaled scores, before the mask:
    tanh(s / c) * c (none when c is 0)."""
    return torch.tanh(s / softcap) * softcap if softcap else s


def chunk_attention_ref(q, k, v, pos0, *, softcap: float = 0.0):
    """Causal attention of a chunk at positions ``pos0[b] + i`` over each
    row's whole buffer. q: (B, S, Hq, D); k, v: (B, Skv, Hkv, D); pos0: (B,).
    ``softcap`` > 0 caps the scaled scores before the mask."""
    B, S = q.shape[:2]
    Skv = k.shape[1]
    q_pos = pos0.long()[:, None] + torch.arange(S, device=q.device)[None]
    kv_pos = torch.arange(Skv, device=q.device)[None].expand(B, Skv)
    return chunked_attention(q, k, v, q_pos, kv_pos, softcap=softcap)


def flash_decode_ref(q, k, v, slot_positions, lengths, *,
                     softcap: float = 0.0):
    """q: (B,Hkv,G,D); k,v: (B,S,Hkv,D); slot_positions: (B,S); lengths: (B,).
    ``softcap`` > 0 caps the scaled scores before the mask (a masked slot
    stays at -1e30)."""
    D = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(D))
    s = _cap(torch.einsum("bhgd,bshd->bhgs", qf, k.float()), softcap)
    valid = (slot_positions >= 0) & (slot_positions <= lengths[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def flash_attention_ref(q, k, v, *, window: int = 0, softcap: float = 0.0):
    """Dense causal (+window) attention. q: (B,S,Hq,D); k,v: (B,S,Hkv,D).
    ``softcap`` > 0 caps the scaled scores before the mask."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = _cap(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D),
             softcap)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > (pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)
