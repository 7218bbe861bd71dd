"""Causal flash attention — the CUDA kernel of prefill
(``csrc/flash_attention.cu``; it replaces ``repro/kernels/flash_attention.py``'s
``_kernel``).

``flash_attention`` launches it on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``flash_attention_ref`` and the device dispatch lives
in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal (+ optional sliding-window) attention with queries and keys
    both at positions 0..S-1. q: (B, S, Hq, D); k, v: (B, S, Hkv, D) with
    Hq % Hkv == 0. Returns (B, S, Hq, D) float32."""
    global launches
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.is_contiguous() and t.dim() == 4,
                 f"{name} must be contiguous 4-D float32 on {q.device}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _require(tuple(k.shape) == (B, S, Hkv, D) and v.shape == k.shape,
             f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _require(Hkv >= 1 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    _require(D in (32, 64, 128), f"head dim {D} not in (32, 64, 128)")
    _require(window >= 0, f"window {window} < 0")
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, Hq, Hkv, D, 1.0 / math.sqrt(D), int(window), stream)
    build.check(err, "flash_attention_fwd")
    launches += 1
    return out
