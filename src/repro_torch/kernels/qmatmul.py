"""Gathered quantized matmul — the CUDA kernel of the sparse mixed-precision
FFN (``csrc/qmatmul.cu``; it replaces ``repro/kernels/qmatmul.py``'s
``_qmm_kernel``).

``qmatmul_gathered`` launches it on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``qmm_gathered_ref`` and the device dispatch lives in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
launches = 0

PRECISIONS = {"fp": 0, "int8": 1, "int4": 2}
LAYOUTS = {"col": 0, "row": 1}
_BK = 32
_BN = 64

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("qmatmul").qmm_gathered
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, L, I, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"qmatmul_gathered: {msg}")


def _plan(M: int, N: int, K: int, device) -> tuple:
    """(splits, k_split, small_m): split K until about two blocks per SM.
    Depends on one row's shape only, never on the row count, so that a row
    sums in the same order alone and in a group."""
    small = M <= 16
    tiles = math.ceil(N / _BN) * math.ceil(M / (16 if small else 64))
    sms = build.sm_count(device)
    splits = max(1, min(math.ceil(2 * sms / tiles), math.ceil(K / _BK)))
    k_split = math.ceil(math.ceil(K / splits) / _BK) * _BK
    return math.ceil(K / k_split), k_split, small


def qmatmul_gathered(x: torch.Tensor, w: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     idx: Optional[torch.Tensor] = None, *,
                     precision: str = "fp", layout: str = "col",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """col: ``x (M, K) @ dequant(w[:, idx])`` -> (M, len(idx)) with w (K, f)
    [int4: (K/2, f)] and a per-column scale (f,).
    row: ``x (M, len(idx)) @ dequant(w[idx, :])`` -> (M, N) with w (f, N)
    [int4: (f, N/2)] and a per-row scale (f,); with ``out`` given the
    product is added into it in place and ``out`` is returned.
    Rows: x (R, M, K) with idx (R, n) gives (R, M, N), each row with its
    own active set. ``idx=None`` takes every column (col) or row (row) in
    order. ``idx`` values must lie in [0, f): the kernel reads them
    unchecked."""
    global launches
    _require(precision in PRECISIONS, f"precision {precision!r}")
    _require(layout in LAYOUTS, f"layout {layout!r}")
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _require(x.dim() in (2, 3) and x.is_contiguous(),
             "x must be contiguous (M, K) or (R, M, K)")
    wdt = torch.float32 if precision == "fp" else torch.int8
    _require(w.device == x.device and w.dtype == wdt,
             f"{precision} weights must be {wdt} on {x.device}")
    _require(w.dim() == 2 and w.is_contiguous(), "w must be contiguous 2-D")
    rows = x.dim() == 3
    R, M, K = x.shape if rows else (1, *x.shape)
    n_idx = None
    if idx is not None:
        _require(idx.device == x.device and idx.dtype == torch.int32
                 and idx.dim() == (2 if rows else 1) and idx.is_contiguous()
                 and (not rows or idx.shape[0] == R),
                 "idx must be a contiguous int32 (n,) vector, or (R, n) for "
                 "x (R, M, K), on the same device")
        n_idx = idx.shape[-1]
    if layout == "col":
        bank_rows = w.shape[0] * (2 if precision == "int4" else 1)
        _require(bank_rows == K, f"w {tuple(w.shape)} does not match K={K}")
        bank = w.shape[1]
        N = bank if idx is None else n_idx
    else:
        bank = w.shape[0]
        _require((bank if idx is None else n_idx) == K,
                 f"x has K={K} but the gather selects "
                 f"{bank if idx is None else n_idx} rows")
        N = w.shape[1] * (2 if precision == "int4" else 1)
    if scale is not None:
        _require(scale.device == x.device and scale.dtype == torch.float32
                 and scale.dim() == 1 and scale.is_contiguous()
                 and scale.numel() == bank,
                 f"scale must be a contiguous float32 ({bank},) vector")
    shape = (R, M, N) if rows else (M, N)
    accumulate = out is not None
    if accumulate:
        _require(out.device == x.device and out.dtype == torch.float32
                 and tuple(out.shape) == shape and out.is_contiguous(),
                 f"out must be a contiguous float32 {shape} tensor")
    else:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if R == 0 or M == 0 or N == 0:
        return out
    if K == 0:
        return out if accumulate else out.zero_()
    splits, k_split, small = _plan(M, N, K, x.device)
    parts = None
    if splits > 1 or accumulate:
        parts = torch.empty((R, splits, M, N), dtype=torch.float32,
                            device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), w.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if idx is None else idx.data_ptr(),
                    R, M, N, K, w.shape[1], PRECISIONS[precision],
                    LAYOUTS[layout], int(accumulate), splits, k_split,
                    int(small), out.data_ptr(),
                    None if parts is None else parts.data_ptr(), stream)
    build.check(err, f"qmm_gathered({precision}, {layout})")
    launches += 1
    return out
