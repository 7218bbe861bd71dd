"""Chunked-prefill attention at an offset — the CUDA kernels of the
server's prefill (``csrc/flash_attention.cu``'s ``flash_attention_chunk_fwd``
and, for bf16, ``csrc/flash_attention_bf16.cu``'s
``flash_attention_chunk_fwd_bf16``; the reference computes it in jnp with
``chunked_attention`` in ``repro/models/transformer.py``'s
``prefill_resume`` mode, beside the Pallas ``flash_attention`` kernel these
sources replace).

``chunk_attention`` launches them on CUDA tensors only; the plain version
is ``kernels/ref.py``'s ``chunk_attention_ref`` and the device dispatch
lives in ``kernels/ops.py``. q, k and v are all fp32 or all bf16
(:func:`_plan_bf16`); the output has q's dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (CHUNK_HEAD_DIMS, Plan,
                                                 check_inputs)
from repro_torch.kernels.flash_attention import _plan as _tiles
from repro_torch.kernels.flash_attention import _plan_bf16 as _tiles_bf16

#: launches of the kernel since the count was last set to 0 (a split's
#: combine runs inside the same launch), and of those the ones with a logit
#: softcap
launches = 0
launches_softcap = 0
#: of those, the ones over bf16 q, k and v
launches_bf16 = 0

#: key slots of one range when a chunk splits its key axis (a multiple of
#: 32; 0 never splits)
SPLIT_SLOTS = 32
#: ranges of a split at most (the last block to finish combines them all:
#: a longer buffer takes wider ranges)
MAX_RANGES = 16

_fns = {}
#: per device: the split's counters, all 0 between launches (each launch
#: sets the ones it used back to 0)
_counts: Dict[torch.device, torch.Tensor] = {}


def _plan(S: int, Skv: int, Hq: int, Hkv: int, D: int, sms: int) -> Plan:
    """The chunk form's block from one row's shape and the card's SM count,
    never from B or pos0: the whole-prompt form's heads and sub-tiles, and,
    when one row has fewer blocks than the card has SMs and its buffer is
    longer than ``SPLIT_SLOTS``, the key axis split into ranges of a fixed
    number of absolute slots: ``SPLIT_SLOTS``, or as many 32-slot tiles
    more as keep the ranges to ``MAX_RANGES``."""
    return _split(_tiles(S, Hq, Hkv, D, sms), S, Skv, Hq, Hkv, sms)


def _plan_bf16(S: int, Skv: int, Hq: int, Hkv: int, D: int, sms: int) -> Plan:
    """:func:`_plan` over the bf16 kernel's heads and sub-tiles
    (``flash_attention._plan_bf16``), with the same key split."""
    return _split(_tiles_bf16(S, Hq, Hkv, D, sms), S, Skv, Hq, Hkv, sms)


def _split(tiles: Plan, S: int, Skv: int, Hq: int, Hkv: int, sms: int
           ) -> Plan:
    tiles = tiles._replace(pair=False)
    G = Hq // Hkv
    blocks = (math.ceil(S / (16 * tiles.qsub)) * Hkv
              * math.ceil(G / tiles.heads_per_block))
    if not (0 < SPLIT_SLOTS < Skv and blocks < sms):
        return tiles
    split = max(SPLIT_SLOTS, 32 * math.ceil(Skv / (32 * MAX_RANGES)))
    return tiles._replace(split=split)


def _kernel(bf16: bool = False):
    """The chunk form's C entry point for fp32 (``flash_attention_chunk_fwd``)
    or bf16 q, k, v and out (``flash_attention_chunk_fwd_bf16``)."""
    fn = _fns.get(bf16)
    if fn is None:
        fn = (build.load("flash_attention_bf16").flash_attention_chunk_fwd_bf16
              if bf16
              else build.load("flash_attention").flash_attention_chunk_fwd)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        F = ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, L, P, L, I, I, I, I, I, I, F, F, I,
                       I, I, P]
        fn.restype = ctypes.c_int
        _fns[bf16] = fn
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"chunk_attention: {msg}")


def _scratch(plan: Plan, B: int, S: int, Skv: int, Hq: int, Hkv: int, D: int,
             device):
    """The split's partials (fresh) and counters (cached, zeroed once)."""
    G = Hq // Hkv
    hb = plan.heads_per_block
    slots = B * Hkv * math.ceil(G / hb) * math.ceil(S / (16 * plan.qsub))
    ranges = math.ceil(Skv / plan.split)
    parts = torch.empty(slots * ranges * hb * plan.qsub * 16 * (D + 2),
                        dtype=torch.float32, device=device)
    counts = _counts.get(device)
    if counts is None or counts.numel() < slots:
        counts = torch.zeros(max(slots, 1024), dtype=torch.int32, device=device)
        _counts[device] = counts
    return parts, counts


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos0: torch.Tensor, *, softcap: float = 0.0
                    ) -> torch.Tensor:
    """Causal attention of an S-token chunk at positions ``pos0[b] + i``
    over each row's whole KV buffer (slot j at position j).
    q: (B, S, Hq, D); k, v: (B, Skv, Hkv, D); pos0: (B,) int32 on the
    device, with ``pos0[b] + S <= Skv`` (unchecked: it lives on the device);
    ``softcap`` > 0 caps the scaled scores before the mask (tanh(s / c) * c).
    q, k and v float32 or all bfloat16. Returns (B, S, Hq, D) in q's dtype;
    slots above a row's chunk are never read."""
    global launches, launches_softcap, launches_bf16
    _require(softcap >= 0, f"softcap {softcap} < 0")
    B = q.shape[0] if q.dim() == 4 else -1
    _require(pos0.dtype == torch.int32 and tuple(pos0.shape) == (B,)
             and pos0.is_contiguous(),
             f"pos0 must be a contiguous int32 ({B},) vector")
    # head dim 256 (recurrentgemma-2b) never runs a chunk: its windowed,
    # recurrent layers prefill whole prompts
    check_inputs(q, k, v, _require, CHUNK_HEAD_DIMS)
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _require(pos0.device == q.device, f"pos0 must be on {q.device}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    plan = (_plan_bf16 if bf16 else _plan)(S, Skv, Hq, Hkv, D,
                                           build.sm_count(q.device))
    parts = counts = None
    if plan.split:
        parts, counts = _scratch(plan, B, S, Skv, Hq, Hkv, D, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = _kernel(True) if bf16 else _kernel()
    err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos0.data_ptr(),
                 out.data_ptr(),
                 None if parts is None else parts.data_ptr(),
                 0 if parts is None else parts.numel(),
                 None if counts is None else counts.data_ptr(),
                 0 if counts is None else counts.numel(),
                 B, S, Skv, Hq, Hkv, D, 1.0 / math.sqrt(D), float(softcap),
                 plan.heads_per_block, plan.qsub, plan.split, stream)
    build.check(err, "flash_attention_chunk_fwd")
    launches += 1
    launches_softcap += int(softcap > 0)
    launches_bf16 += int(bf16)
    return out
