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
from repro_torch.models.common import activation


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
    selected neurons, dequantizes them and multiplies (same arguments)."""
    x = x.float()
    quant = precision in ("int8", "int4") and scale is not None
    if layout == "col":
        cols = idx.long() if idx is not None else None
        wq = w if cols is None else w.index_select(1, cols)
        wf = (_unpack_rows(wq) if precision == "int4" else wq).float()
        y = x @ wf
        if quant:
            y = y * (scale if cols is None else scale[cols]).float()[None, :]
    elif layout == "row":
        rows = idx.long() if idx is not None else None
        wq = w if rows is None else w.index_select(0, rows)
        wf = (unpack_int4(wq, 1) if precision == "int4" else wq).float()
        if quant:
            wf = wf * (scale if rows is None else scale[rows]).float()[:, None]
        y = x @ wf
        if out is not None:
            return out.add_(y)
    else:
        raise ValueError(layout)
    return y


def mp_ffn_gathered_ref(x, banks: Dict[str, torch.Tensor], idx,
                        sizes: Dict[str, int], act_name: str):
    """The sparse mixed-precision GLU FFN as ``repro/core/mp_ffn.py`` computes
    it: gather each tier's neurons, dequantize, concatenate, then einsum.
    x: (B, S, d); idx: (k,) rank-sorted active neurons."""
    k16, k8 = sizes["fp16"], sizes["int8"]
    idx = idx.long()
    i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:]
    compute = x.dtype

    def cols(w, c):
        return w.index_select(1, c)

    def rows(w, r):
        return w.index_select(0, r)

    wg16 = cols(banks["wg_fp"], i16).to(compute)
    wu16 = cols(banks["wu_fp"], i16).to(compute)
    wd16 = rows(banks["wd_fp"], i16).to(compute)
    wg8 = cols(banks["wg_i8"], i8).to(compute) * banks["wg_i8_s"][i8].to(compute)
    wu8 = cols(banks["wu_i8"], i8).to(compute) * banks["wu_i8_s"][i8].to(compute)
    wd8 = (rows(banks["wd_i8"], i8).to(compute)
           * banks["wd_i8_s"][i8].to(compute)[:, None])
    wg4 = (unpack_int4(cols(banks["wg_i4"], i4), 0).to(compute)
           * banks["wg_i4_s"][i4].to(compute))
    wu4 = (unpack_int4(cols(banks["wu_i4"], i4), 0).to(compute)
           * banks["wu_i4_s"][i4].to(compute))
    wd4 = (unpack_int4(rows(banks["wd_i4"], i4), 1).to(compute)
           * banks["wd_i4_s"][i4].to(compute)[:, None])
    wg = torch.cat([wg16, wg8, wg4], dim=1)
    wu = torch.cat([wu16, wu8, wu4], dim=1)
    wd = torch.cat([wd16, wd8, wd4], dim=0)
    act = activation(act_name)
    h = act(torch.einsum("bsd,dk->bsk", x, wg))
    h = h * torch.einsum("bsd,dk->bsk", x, wu)
    return torch.einsum("bsk,kd->bsd", h, wd)


def flash_decode_ref(q, k, v, slot_positions, lengths):
    """q: (B,Hkv,G,D); k,v: (B,S,Hkv,D); slot_positions: (B,S); lengths: (B,)."""
    D = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    valid = (slot_positions >= 0) & (slot_positions <= lengths[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float())


def flash_attention_ref(q, k, v, *, window: int = 0):
    """Dense causal (+window) attention. q: (B,S,Hq,D); k,v: (B,S,Hkv,D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > (pos[:, None] - window)
    s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, Hq, D).to(q.dtype)
