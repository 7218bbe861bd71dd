"""Chunked-prefill attention at an offset — the CUDA kernel of the server's
prefill (``csrc/flash_attention.cu``'s ``flash_attention_chunk_fwd``; the
reference computes it in jnp with ``chunked_attention`` in
``repro/models/transformer.py``'s ``prefill_resume`` mode, beside the
Pallas ``flash_attention`` kernel this source replaces).

``chunk_attention`` launches it on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``chunk_attention_ref`` and the device dispatch lives
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
        fn = build.load("flash_attention").flash_attention_chunk_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"chunk_attention: {msg}")


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos0: torch.Tensor) -> torch.Tensor:
    """Causal attention of an S-token chunk at positions ``pos0[b] + i``
    over each row's whole KV buffer (slot j at position j).
    q: (B, S, Hq, D); k, v: (B, Skv, Hkv, D); pos0: (B,) int32 on the
    device, with ``pos0[b] + S <= Skv`` (unchecked: it lives on the device).
    Returns (B, S, Hq, D) float32; slots above a row's chunk are never
    read."""
    global launches
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.is_contiguous() and t.dim() == 4,
                 f"{name} must be contiguous 4-D float32 on {q.device}")
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _require(tuple(k.shape) == (B, Skv, Hkv, D) and v.shape == k.shape,
             f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _require(Hkv >= 1 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    _require(D in (32, 64, 128), f"head dim {D} not in (32, 64, 128)")
    _require(S <= Skv, f"chunk of {S} longer than the buffer of {Skv}")
    _require(pos0.device == q.device and pos0.dtype == torch.int32
             and tuple(pos0.shape) == (B,) and pos0.is_contiguous(),
             f"pos0 must be a contiguous int32 ({B},) vector on {q.device}")
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos0.data_ptr(),
                    out.data_ptr(), B, S, Skv, Hq, Hkv, D, 1.0 / math.sqrt(D),
                    stream)
    build.check(err, "flash_attention_chunk_fwd")
    launches += 1
    return out
