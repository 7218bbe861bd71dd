"""Causal flash attention — the CUDA kernels of prefill
(``csrc/flash_attention.cu`` for fp32, ``csrc/flash_attention_bf16.cu`` for
bf16 on the bf16 tensor cores; they replace
``repro/kernels/flash_attention.py``'s ``_kernel``).

``flash_attention`` launches them on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``flash_attention_ref`` and the device dispatch lives
in ``kernels/ops.py``. ``_plan`` and ``_plan_bf16`` (shared with
``chunk_attention``) set a block's shape from one row's shape alone. q, k
and v are all fp32 or all bf16; the output has q's dtype, as the Pallas
kernel's.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0, and of those
#: the ones with a logit softcap
launches = 0
launches_softcap = 0
#: of those, the ones over bf16 q, k and v
launches_bf16 = 0

#: warps of a block at most; each owns 16 query rows of one head
MAX_WARPS = 8
#: keys per K/V tile of the kernel (a key split is a multiple of it)
BKV = 32
#: head dims of the whole-prompt form, and of the chunk form
HEAD_DIMS = (32, 64, 128, 256)
CHUNK_HEAD_DIMS = (32, 64, 128)
#: dynamic shared memory a block may use (the kernel's kMaxSmem)
SMEM_BYTES = 232448 - 1024

_fns = {}
#: the dtypes of q, k and v the kernels take
DTYPES = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    heads_per_block: int  # query heads of one KV head in a block
    qsub: int             # 16-row query sub-tiles of each head in a block
    split: int            # key slots per range of the key axis; 0: one range
    pair: bool = False    # a block takes two query tiles (long and short)


#: key ranges of a split the kernels' combine takes at most (kMaxRanges)
KERNEL_MAX_RANGES = 32


def smem_bytes(D: int, warps: int, bf16: bool = False) -> int:
    """A block's dynamic shared memory, as the kernels reckon it: fp32, a
    warp's 16 Q rows of D + 8 floats beside two stages of a 32-key K tile
    of D + 8 and V tile of D + 4 floats; bf16, the Q rows and three stages
    of K and V tiles of D + 8 bf16, or the split's combine (each row's (m,
    weight) and l of every range, and its denominator) where that is
    more."""
    if not bf16:
        return (warps * 16 * (D + 8) + 2 * BKV * ((D + 8) + (D + 4))) * 4
    tiles = (warps * 16 + 3 * 2 * BKV) * (D + 8) * 2
    return max(tiles, warps * 16 * (2 * KERNEL_MAX_RANGES + 1) * 4)


def max_warps(D: int, bf16: bool = False) -> int:
    """Warps a block may take at head dim D: ``MAX_WARPS``, or as many as
    the shared memory holds (:func:`smem_bytes`): 5 at D = 256 in fp32;
    ``MAX_WARPS`` at every D in bf16."""
    return max(w for w in range(1, MAX_WARPS + 1)
               if smem_bytes(D, w, bf16) <= SMEM_BYTES)


def _plan(S: int, Hq: int, Hkv: int, D: int, sms: int) -> Plan:
    """The whole-prompt form's block from one row's shape and the card's SM
    count, never from B: the G = Hq / Hkv query heads of a KV head in as
    few blocks of at most :func:`max_warps` warps as hold them, spread
    evenly, and as many 16-row sub-tiles of each head as fill those warps
    without passing S; the key axis is never split. When one row's blocks
    fit one wave (a short prompt), a block takes two query tiles, the k-th
    longest and the k-th shortest: a batch of such rows then fits a wave
    too, with even causal work per block (measured faster at S = 128,
    B = 4, and slower at S = 2048, where a row fills the card 8 times).
    D changes the plan only through :func:`max_warps` (G = 10 takes two
    blocks of 5 heads at every D)."""
    return _blocks(S, Hq, Hkv, sms, max_warps(D))


def _plan_bf16(S: int, Hq: int, Hkv: int, D: int, sms: int) -> Plan:
    """:func:`_plan` of the bf16 kernel, whose smaller tiles leave room for
    ``MAX_WARPS`` warps at every D: the same plan but at D = 256 with G > 5
    (one row's shape and the SM count only)."""
    return _blocks(S, Hq, Hkv, sms, max_warps(D, bf16=True))


def _blocks(S: int, Hq: int, Hkv: int, sms: int, warps: int) -> Plan:
    G = Hq // Hkv
    groups = math.ceil(G / warps)
    hb = math.ceil(G / groups)
    qsub = max(1, min(warps // hb, math.ceil(S / 16)))
    q_tiles = math.ceil(S / (16 * qsub))
    return Plan(hb, qsub, 0, q_tiles > 1 and q_tiles * Hkv * groups <= sms)


def _kernel(bf16: bool = False):
    """The whole-prompt C entry point for fp32 (``flash_attention_fwd``) or
    bf16 q, k, v and out (``flash_attention_fwd_bf16``, a library of its
    own)."""
    fn = _fns.get(bf16)
    if fn is None:
        fn = (build.load("flash_attention_bf16").flash_attention_fwd_bf16
              if bf16 else build.load("flash_attention").flash_attention_fwd)
        P, I = ctypes.c_void_p, ctypes.c_int
        F = ctypes.c_float
        fn.argtypes = [P, P, P, P, I, I, I, I, I, F, F, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _fns[bf16] = fn
    return fn


def bf16_p_terms() -> int:
    """The bf16 terms P takes in the bf16 kernels' O += P V, as their
    source sets it: a key tile issues (1 + this) x one product's MMAs."""
    return int(build.load("flash_attention_bf16")
               .flash_attention_bf16_p_terms())


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def check_inputs(q, k, v, require, head_dims=HEAD_DIMS):
    """Shape, dtype and layout checks shared by both forms (before the
    device check, so that they hold on any device), the head dim one of
    ``head_dims``; then CUDA and 16-byte alignment (the kernel copies 16
    bytes at a time)."""
    require(q.dtype in DTYPES,
            f"q must be float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.dtype == q.dtype and t.dim() == 4 and t.is_contiguous(),
                f"{name} must be contiguous 4-D {q.dtype}")
    B, _, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    require(tuple(k.shape) == (B, Skv, Hkv, D) and v.shape == k.shape,
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    require(Hkv >= 1 and Hq % Hkv == 0, f"Hq={Hq} not a multiple of Hkv={Hkv}")
    require(D in head_dims, f"head dim {D} not in {head_dims}")
    require(q.shape[1] <= Skv, f"{q.shape[1]} queries over a buffer of {Skv}")
    require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("k", k), ("v", v)):
        require(t.device == q.device, f"{name} must be on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal (+ optional sliding-window) attention with queries and keys
    both at positions 0..S-1. q: (B, S, Hq, D); k, v: (B, S, Hkv, D) with
    Hq % Hkv == 0; ``softcap`` > 0 caps the scaled scores before the mask
    (tanh(s / c) * c). q, k and v float32 or all bfloat16. Returns (B, S,
    Hq, D) in q's dtype."""
    global launches, launches_softcap, launches_bf16
    _require(window >= 0, f"window {window} < 0")
    _require(softcap >= 0, f"softcap {softcap} < 0")
    check_inputs(q, k, v, _require)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _require(k.shape[1] == S, f"k/v hold {k.shape[1]} keys for {S} queries")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    plan = (_plan_bf16 if bf16 else _plan)(S, Hq, Hkv, D,
                                           build.sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = _kernel(True) if bf16 else _kernel()
    err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hq, Hkv, D, 1.0 / math.sqrt(D), float(softcap),
                 int(window), plan.heads_per_block, plan.qsub,
                 int(plan.pair), stream)
    build.check(err, "flash_attention_fwd")
    launches += 1
    launches_softcap += int(softcap > 0)
    launches_bf16 += int(bf16)
    return out
