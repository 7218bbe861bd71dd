"""Symmetric INT8 / packed-INT4 weight quantization (per-neuron scales) —
the weight half of ``repro/core/quantize.py``, byte for byte.

A *neuron* is a column of the FFN up/gate projections and the matching row
of the down projection; scales are therefore per-neuron:
  W_gate/W_up: (d, f), scale over axis 0 -> (f,)
  W_down:      (f, d), scale over axis 1 -> (f,)

INT4 values are packed two per int8 along the *non-neuron* axis (low nibble
= even index) so that gathering neurons never splits a byte. Rounding is
round-half-even (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

from typing import Optional

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0


def quantize_int8(w, axis: int):
    wf = w.float()
    scale = torch.amax(torch.abs(wf), dim=axis, keepdim=True) / INT8_MAX
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axis)


def _pack_nibbles(lo, hi):
    """(lo & 0x0F) | (hi << 4) as int8 bytes, computed without int8 overflow."""
    byte = (lo.to(torch.int16) & 0x0F) | ((hi.to(torch.int16) & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def quantize_int4(w, axis: int):
    """Returns (packed, scale). ``packed`` halves ``axis``, which is both the
    scale's reduction axis (the non-neuron axis) and the packing axis."""
    wf = w.float()
    scale = torch.amax(torch.abs(wf), dim=axis, keepdim=True) / INT4_MAX
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    if axis == 0:
        assert w.shape[0] % 2 == 0
        lo, hi = q[0::2], q[1::2]
    else:
        assert w.shape[1] % 2 == 0
        lo, hi = q[:, 0::2], q[:, 1::2]
    return _pack_nibbles(lo, hi), scale.squeeze(axis)


def pack_int4(q, axis: int = -1):
    """Pack int4 values (int8 storage, each in [-7, 7]) two per byte along
    ``axis``. Odd lengths are zero-padded; pass the original length back to
    :func:`unpack_int4` as ``orig_len`` to recover the input exactly."""
    q = torch.as_tensor(q).to(torch.int8)
    axis = axis % q.dim()
    if q.shape[axis] % 2:
        pad_shape = list(q.shape)
        pad_shape[axis] = 1
        q = torch.cat([q, q.new_zeros(pad_shape)], dim=axis)
    pairs = q.unflatten(axis, (-1, 2))
    return _pack_nibbles(pairs.select(axis + 1, 0), pairs.select(axis + 1, 1))


def unpack_int4(packed, axis: int, orig_len: Optional[int] = None):
    """Inverse of the packing step: int8 (n//2 on axis) -> int4 values (n),
    each nibble sign-extended as ``(b << 4) >> 4`` (low) and ``b >> 4`` (high).
    ``orig_len`` trims the unpacked axis back to an odd pre-padding length."""
    axis = axis % packed.dim()
    b = packed.to(torch.int32)
    lo = ((b & 0x0F) ^ 0x08) - 0x08
    hi = b >> 4
    out = torch.stack([lo, hi], dim=axis + 1).flatten(axis, axis + 1)
    if orig_len is not None and orig_len != out.shape[axis]:
        out = out.narrow(axis, 0, orig_len)
    return out.to(torch.int8)


# ---------------------------------------------------------------------------
# Neuron-bank container: the SSD-resident representation of one FFN layer.


def build_neuron_banks(wg, wu, wd):
    """Quantize a GLU FFN layer into the three M2Cache precision banks.
    The fp banks keep the input dtype."""
    g8, g8s = quantize_int8(wg, 0)
    u8, u8s = quantize_int8(wu, 0)
    d8, d8s = quantize_int8(wd, 1)
    g4, g4s = quantize_int4(wg, 0)
    u4, u4s = quantize_int4(wu, 0)
    d4, d4s = quantize_int4(wd, 1)
    return {
        "wg_fp": wg, "wu_fp": wu, "wd_fp": wd,
        "wg_i8": g8, "wg_i8_s": g8s, "wu_i8": u8, "wu_i8_s": u8s,
        "wd_i8": d8, "wd_i8_s": d8s,
        "wg_i4": g4, "wg_i4_s": g4s, "wu_i4": u4, "wu_i4_s": u4s,
        "wd_i4": d4, "wd_i4_s": d4s,
    }


def bytes_per_neuron(d_model: int, precision: str) -> int:
    """Traffic cost of loading one neuron (3 vectors of length d_model)."""
    per_elt = {"fp16": 2.0, "int8": 1.0, "int4": 0.5}[precision]
    return int(3 * d_model * per_elt)
