"""Flash-decoding attention — the CUDA kernel of the decode step
(``csrc/flash_decode.cu``; it replaces ``repro/kernels/flash_decode.py``'s
``_flash_kernel``).

``flash_decode`` launches it on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``flash_decode_ref`` and the device dispatch lives in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
launches = 0

_MAX_G = 8
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_decode").flash_decode_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float,
                       P, P, P, P, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 slot_positions: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, S, Hkv, D); slot_positions: (B, S) int32
    absolute position per cache slot (-1 = empty); lengths: (B,) int32
    current decode position (inclusive). Returns (B, Hkv, G, D) float32."""
    global launches
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.is_contiguous(),
                 f"{name} must be contiguous float32 on {q.device}")
    _require(q.dim() == 4 and k.dim() == 4, "q and k must be 4-D")
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    _require(tuple(k.shape) == (B, S, Hkv, D) and v.shape == k.shape,
             f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _require(D in (32, 64, 128), f"head dim {D} not in (32, 64, 128)")
    _require(1 <= G <= _MAX_G, f"G={G} query heads per KV head > {_MAX_G}")
    _require(slot_positions.device == q.device
             and slot_positions.dtype == torch.int32
             and tuple(slot_positions.shape) == (B, S)
             and slot_positions.is_contiguous(),
             "slot_positions must be contiguous int32 (B, S)")
    _require(lengths.device == q.device and lengths.dtype == torch.int32
             and tuple(lengths.shape) == (B,) and lengths.is_contiguous(),
             "lengths must be contiguous int32 (B,)")
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out.zero_()
    sms = build.sm_count(q.device)
    nsplit = max(1, min(math.ceil(S / 16), math.ceil(2 * sms / (B * Hkv))))
    chunk = math.ceil(S / nsplit)
    nsplit = math.ceil(S / chunk)
    part_m = torch.empty((B, Hkv, nsplit, G), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, nsplit, G, D), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    slot_positions.data_ptr(), lengths.data_ptr(),
                    B, S, Hkv, G, D, nsplit, chunk, 1.0 / math.sqrt(D),
                    part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                    out.data_ptr(), stream)
    build.check(err, "flash_decode_fwd")
    launches += 1
    return out
