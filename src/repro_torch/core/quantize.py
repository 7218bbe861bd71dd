"""Symmetric INT8 / packed-INT4 weight quantization (per-neuron scales) —
the weight half of ``repro/core/quantize.py``, byte for byte, and its
KV-payload codec (numpy only: payloads are host arrays).

A *neuron* is a column of the FFN up/gate projections and the matching row
of the down projection; scales are therefore per-neuron:
  W_gate/W_up: (d, f), scale over axis 0 -> (f,)
  W_down:      (f, d), scale over axis 1 -> (f,)
``build_neuron_banks`` keeps that (the reference's) layout; the model's
params hold gate and up neuron-major (:func:`to_neuron_major`), and the SSD
tier persists the reference's layout (:func:`to_reference_layout`).

INT4 values are packed two per int8 along the *non-neuron* axis (low nibble
= even index) so that gathering neurons never splits a byte. Rounding is
round-half-even (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

INT8_MAX = 127.0
INT4_MAX = 7.0


def quantize_int8(w, axis: int):
    wf = w.float()
    scale = torch.amax(torch.abs(wf), dim=axis, keepdim=True) / INT8_MAX
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize_int8(q, scale, axis: int):
    """int8 values times their per-neuron scales (reference :31), fp32."""
    return q.float() * scale.unsqueeze(axis)


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


def dequantize_int4(packed, scale, axis: int):
    """Unpacked int4 values times their per-neuron scales (reference
    :93), fp32; ``axis`` is the packing axis."""
    return unpack_int4(packed, axis).float() * scale.unsqueeze(axis)


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


#: the banks that hold a neuron as a column in the reference's layout
NEURON_COLUMN_BANKS = ("wg_fp", "wu_fp", "wg_i8", "wu_i8", "wg_i4", "wu_i4")


def _transpose_neuron_columns(banks):
    return {k: v.t().contiguous() if k in NEURON_COLUMN_BANKS else v
            for k, v in banks.items()}


def to_neuron_major(banks):
    """The reference's banks -> the port's layout: gate and up become
    neuron-major like the down bank already is (``wg_fp`` (d, f) -> (f, d),
    ``wg_i8`` likewise, ``wg_i4`` (d/2, f) -> (f, d/2); each int4 byte keeps
    its nibble pair, low nibble = even k), so every gathered neuron is one
    contiguous row in all three products. Scales and ``wd_*`` are
    unchanged; the same bytes, transposed."""
    return _transpose_neuron_columns(banks)


def to_reference_layout(banks):
    """Inverse of :func:`to_neuron_major` (the transposition is its own
    inverse): the layout the reference builds and the SSD tier persists."""
    return _transpose_neuron_columns(banks)


def bytes_per_neuron(d_model: int, precision: str) -> int:
    """Traffic cost of loading one neuron (3 vectors of length d_model)."""
    per_elt = {"fp16": 2.0, "int8": 1.0, "int4": 0.5}[precision]
    return int(3 * d_model * per_elt)


# ---------------------------------------------------------------------------
# KV payload quantization: the per-tier storage codec for the serving
# cache (``serving/kv_cache.py``). A host KV payload is a flat
# ``{keystr: ndarray}`` dict (``core/kv_payload.py``); quantizing one for
# a colder tier produces *another flat dict of plain arrays* — so the
# DRAM store, the SSD memmap tier and the prefix-tree checksum handshake
# all handle quantized payloads unchanged, and the checksum covers the
# packed form. Both codecs are symmetric with max-based scales:
#
# * ``int8`` (the DRAM tier): one fp32 scale per last-axis row.
# * ``int4`` (the SSD tier): the paper's dynamic mixed-precision idea
#   applied within a block — each last-axis row is split into groups of
#   ``KV_INT4_GROUP`` elements; the half of the groups with the largest
#   magnitude ("outlier" groups, which dominate attention) keep int8,
#   the cold half is nibble-packed int4, with fp16 per-group scales.
#   Pure max-scaled int4 measurably reorders top-k logits on flat
#   distributions; sparing the outlier groups buys the divergence gate
#   (``eval/divergence.py``) at ~1 byte/element stored.

#: legal per-tier KV storage precisions, widest first
KV_PRECISIONS = ("fp16", "int8", "int4")

#: marker key of a quantized payload dict (value: [precision code])
KVQ_KEY = "__kvq__"

#: int4 codec: elements per scale group along the last axis
KV_INT4_GROUP = 8

_PRECISION_CODE = {"int8": 8, "int4": 4}
_CODE_PRECISION = {v: k for k, v in _PRECISION_CODE.items()}

_DTYPE_CODE = {"float32": 0, "float16": 1, "float64": 2, "bfloat16": 3}


def _dtype_of(code: int):
    name = {v: k for k, v in _DTYPE_CODE.items()}[int(code)]
    if name == "bfloat16":
        import ml_dtypes             # numpy's bfloat16, as the reference has it
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def kv_payload_precision(payload: Optional[Dict]) -> str:
    """Storage precision of a payload dict ("fp16" = not quantized)."""
    if payload is None or KVQ_KEY not in payload:
        return "fp16"
    return _CODE_PRECISION[int(np.asarray(payload[KVQ_KEY]).ravel()[0])]


def kv_payload_nbytes(payload: Dict) -> int:
    """Actual stored bytes of a (possibly quantized) payload dict."""
    return sum(np.asarray(a).nbytes for a in payload.values())


def _pack_int4_np(q: np.ndarray, axis: int = -1) -> np.ndarray:
    """numpy :func:`pack_int4`: int4 values two per byte along ``axis``, odd
    lengths zero-padded, low nibble = even index."""
    q = np.asarray(q, np.int8)
    axis = axis % q.ndim
    if q.shape[axis] % 2:
        pad = [(0, 0)] * q.ndim
        pad[axis] = (0, 1)
        q = np.pad(q, pad)
    lo = np.take(q, np.arange(0, q.shape[axis], 2), axis=axis)
    hi = np.take(q, np.arange(1, q.shape[axis], 2), axis=axis)
    return ((lo & 0x0F) | (hi << 4)).astype(np.int8)


def _unpack_int4_np(packed: np.ndarray, axis: int,
                    orig_len: Optional[int] = None) -> np.ndarray:
    """numpy :func:`unpack_int4` (sign-extended nibbles, optional trim)."""
    axis = axis % packed.ndim
    lo = (packed.astype(np.int8) << 4).astype(np.int8) >> 4
    hi = packed.astype(np.int8) >> 4
    out = np.stack([lo, hi], axis=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    out = out.reshape(shape)
    if orig_len is not None and orig_len != shape[axis]:
        out = np.take(out, np.arange(orig_len), axis=axis)
    return out


def _rows_of(arr: np.ndarray):
    cols = arr.shape[-1] if arr.ndim else 1
    return arr.reshape(-1, cols).astype(np.float32), cols


def _quantize_int8_rows(arr: np.ndarray) -> Dict[str, np.ndarray]:
    a, _ = _rows_of(arr)
    scale = np.abs(a).max(axis=1) / INT8_MAX
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    q = np.clip(np.rint(a / scale[:, None]), -127, 127).astype(np.int8)
    return {"": q, "::scale": scale}


def _dequantize_int8_rows(payload: Dict, key: str, cols: int):
    q = np.asarray(payload[key]).astype(np.float32)
    scale = np.asarray(payload[key + "::scale"], np.float32)
    return q * scale[:, None]


def _grouped(arr: np.ndarray):
    """(rows, cols) view padded and reshaped to (rows, ngroups, G)."""
    a, cols = _rows_of(arr)
    G = KV_INT4_GROUP
    ng = -(-cols // G)
    padded = np.zeros((a.shape[0], ng * G), np.float32)
    padded[:, :cols] = a
    return padded.reshape(-1, ng, G), ng, cols


def _quantize_int4_rows(arr: np.ndarray) -> Dict[str, np.ndarray]:
    g, ng, _ = _grouped(arr)
    n_hot = ng // 2
    amax = np.abs(g).max(axis=2)
    qmax = np.full(amax.shape, INT4_MAX, np.float32)
    if n_hot:
        hot = np.sort(np.argsort(amax, axis=1)[:, ng - n_hot:], axis=1)
        np.put_along_axis(qmax, hot, INT8_MAX, axis=1)
    # floor must survive the fp16 cast (1e-8 underflows fp16 to zero,
    # which would turn all-zero groups into 0/0 = NaN on dequantize)
    scale = np.maximum(amax / qmax, 1e-6).astype(np.float16)
    q = np.clip(np.rint(g / scale.astype(np.float32)[..., None]),
                -qmax[..., None], qmax[..., None]).astype(np.int8)
    out = {"::scale": scale}
    if n_hot:
        mask = np.zeros(amax.shape, bool)
        np.put_along_axis(mask, hot, True, axis=1)
        out["::hot"] = q[mask].reshape(len(g), -1)          # int8 groups
        out["::hotidx"] = hot.astype(np.int8)
        cold = q[~mask].reshape(len(g), -1)
    else:
        cold = q.reshape(len(g), -1)
    out[""] = _pack_int4_np(cold, axis=1)
    return out


def _dequantize_int4_rows(payload: Dict, key: str, cols: int):
    G = KV_INT4_GROUP
    scale = np.asarray(payload[key + "::scale"]).astype(np.float32)
    rows, ng = scale.shape
    hotidx = payload.get(key + "::hotidx")
    n_hot = hotidx.shape[1] if hotidx is not None else 0
    ncold = ng - n_hot
    cold = _unpack_int4_np(np.asarray(payload[key]), axis=1,
                           orig_len=ncold * G)
    q = np.empty((rows, ng, G), np.float32)
    if n_hot:
        mask = np.zeros((rows, ng), bool)
        np.put_along_axis(mask, np.asarray(hotidx, np.int64), True, axis=1)
        q[mask] = np.asarray(payload[key + "::hot"],
                             np.float32).reshape(-1, G)
        q[~mask] = cold.astype(np.float32).reshape(-1, G)
    else:
        q[:] = cold.astype(np.float32).reshape(rows, ng, G)
    deq = (q * scale[..., None]).reshape(rows, ng * G)
    return deq[:, :cols]


def kv_quantize_payload(payload: Dict, precision: str) -> Dict:
    """Quantize a full-precision KV payload for a storage tier.

    Per original key ``k`` the result carries ``k`` (the quantized
    values — nibble-packed cold groups for int4), ``k::scale`` (and for
    int4 ``k::hot`` / ``k::hotidx``, the outlier groups kept at int8)
    and ``k::meta`` ([dtype code, *shape], int64), plus the ``KVQ_KEY``
    marker. "fp16" (or None) returns the payload unchanged."""
    if precision in (None, "fp16"):
        return payload
    quantize = {"int8": _quantize_int8_rows,
                "int4": _quantize_int4_rows}[precision]
    out = {KVQ_KEY: np.asarray([_PRECISION_CODE[precision]], np.int64)}
    for key in sorted(payload):
        assert "::" not in key and key != KVQ_KEY, key
        arr = np.asarray(payload[key])
        for suffix, bank in quantize(arr).items():
            out[key + suffix] = bank
        out[key + "::meta"] = np.asarray(
            [_DTYPE_CODE[str(arr.dtype)], *arr.shape], np.int64)
    return out


def kv_dequantize_payload(payload: Optional[Dict]) -> Optional[Dict]:
    """Inverse of :func:`kv_quantize_payload`; restores the original
    keys, shapes and dtypes. Unquantized payloads pass through."""
    if payload is None or KVQ_KEY not in payload:
        return payload
    precision = kv_payload_precision(payload)
    dequantize = {"int8": _dequantize_int8_rows,
                  "int4": _dequantize_int4_rows}[precision]
    out = {}
    for key in payload:
        if key == KVQ_KEY or "::" in key:
            continue
        meta = np.asarray(payload[key + "::meta"])
        dtype = _dtype_of(meta[0])
        shape = tuple(int(x) for x in meta[1:])
        cols = shape[-1] if shape else 1
        deq = dequantize(payload, key, cols)
        out[key] = np.asarray(deq.reshape(shape), dtype=dtype)
    return out


def kv_requantize_payload(payload: Dict, precision: str) -> Dict:
    """Ensure a payload is stored at (at most) ``precision``.

    Precision only ever *decays*: an int4 payload asked for int8 stays
    int4 (re-widening stored values cannot recover information), int8
    asked for int4 re-quantizes down, fp16 quantizes directly. Returns
    the input object unchanged when nothing needs to happen."""
    cur = kv_payload_precision(payload)
    if precision in (None, "fp16") or cur == precision or cur == "int4":
        return payload
    if cur == "fp16":
        return kv_quantize_payload(payload, precision)
    return kv_quantize_payload(kv_dequantize_payload(payload), precision)
