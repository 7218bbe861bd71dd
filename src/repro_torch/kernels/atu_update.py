"""ATU cache-unit update — the CUDA kernel (``csrc/atu_update.cu``; it
replaces ``repro/kernels/atu_update.py``'s ``_atu_kernel``).

``atu_update`` launches it on CUDA tensors only and updates ``unit`` in
place; the plain version is ``kernels/ref.py``'s ``atu_update_ref`` and the
device dispatch lives in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0
launches = 0

#: (bank dtype, unit dtype) -> the C function's ``kind``
_KINDS = {(torch.int8, torch.int8): 1, (torch.float16, torch.float16): 2,
          (torch.bfloat16, torch.bfloat16): 2,
          (torch.float32, torch.float32): 4, (torch.int8, torch.float32): 5}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("atu_update").atu_update
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"atu_update: {msg}")


def atu_update(bank: torch.Tensor, unit: torch.Tensor, src_idx: torch.Tensor,
               dst_idx: torch.Tensor, *, bg: int = 8) -> torch.Tensor:
    """bank (d, f), unit (d, k), src_idx/dst_idx (m,) int32 with m % bg == 0
    and m <= k. Group g copies bank columns ``[src[g*bg]//bg*bg, +bg)`` into
    unit columns ``[dst[g*bg]//bg*bg, +bg)``; when groups share a
    destination the last one wins. ``unit`` is updated in place and
    returned. Index values are read on the device, unchecked: a group
    outside bank or unit is skipped."""
    global launches
    _require(bank.is_cuda, "bank must be a CUDA tensor")
    _require(unit.device == bank.device and src_idx.device == bank.device
             and dst_idx.device == bank.device,
             f"unit and indices must be on {bank.device}")
    kind = _KINDS.get((bank.dtype, unit.dtype))
    _require(kind is not None,
             f"{bank.dtype} -> {unit.dtype} is not a supported copy")
    _require(bank.dim() == 2 and unit.dim() == 2 and bank.is_contiguous()
             and unit.is_contiguous(), "bank and unit must be contiguous 2-D")
    d, f = bank.shape
    _require(unit.shape[0] == d, f"unit {tuple(unit.shape)} does not match "
                                 f"bank {tuple(bank.shape)}")
    k = unit.shape[1]
    for name, t in (("src_idx", src_idx), ("dst_idx", dst_idx)):
        _require(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous(),
                 f"{name} must be a contiguous int32 vector")
    m = src_idx.numel()
    _require(dst_idx.numel() == m, "src_idx and dst_idx differ in length")
    _require(bg >= 1 and 256 % bg == 0, f"bg={bg} must divide 256")
    _require(m % bg == 0 and m <= k, f"m={m} bg={bg} k={k}")
    if m == 0 or d == 0:
        return unit
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    err = _kernel()(bank.data_ptr(), unit.data_ptr(), src_idx.data_ptr(),
                    dst_idx.data_ptr(), d, f, k, m, bg, kind, stream)
    build.check(err, "atu_update")
    launches += 1
    return unit
