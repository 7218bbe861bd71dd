"""Flash-decoding attention — the CUDA kernel of the decode step
(``csrc/flash_decode.cu``; it replaces ``repro/kernels/flash_decode.py``'s
``_flash_kernel``).

``flash_decode`` launches it on CUDA tensors only, one launch a call; the
plain version is ``kernels/ref.py``'s ``flash_decode_ref`` and the device
dispatch lives in ``kernels/ops.py``. q, k and v are all fp32 or all bf16
(``flash_decode_fwd_bf16``: a kernel of its own on the bf16 tensor cores,
each warp streaming its own 16-slot steps of the range through a ring of
its own; the same ranges and head groups); the output is fp32 either way,
as the Pallas kernel's.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

#: launches of the kernel since the count was last set to 0 (the ranges'
#: combine runs inside the same launch), and of those the ones with a logit
#: softcap
launches = 0
launches_softcap = 0
#: of those, the ones over bf16 q, k and v
launches_bf16 = 0

#: slots of a tile: one per lane of a warp
TILE = 32
#: query heads of a block at most (a warp each in the softmax); a KV head's
#: G query heads are spread evenly over ceil(G / MAX_HEADS) blocks
MAX_HEADS = 8
#: query heads per KV head the kernel takes: two blocks of MAX_HEADS
MAX_G = 2 * MAX_HEADS
#: blocks of one row wanted on each SM at most: a row's ranges fit one wave
#: (measured: at 4 K and 32 K slots a block per SM streaming long ranges
#: beats two with half as many tiles, and both beat a wave and a bit)
BLOCKS_PER_SM = 1
#: cp.async ring depth, in tiles (1 to 6; no deeper than the longest range,
#: nor than the shared memory holds at the head dim and dtype:
#: :func:`max_stages`)
STAGES = 3
#: bf16: each warp's ring depth, in steps of ``BF16_STEP`` slots (no deeper
#: than the warp's steps of a range, nor than :func:`max_stages` of D)
STAGES_BF16 = 2
#: bf16: the warps of a block, each taking steps warp, warp + WARPS, ... of
#: a range, and the slots of a step
WARPS = 8
BF16_STEP = 16
#: slots per range when > 0 (a multiple of TILE), whatever the rule says
RANGE_SLOTS = 0
#: query heads of a block when > 0 (it must divide G), whatever the rule says
HEADS_PER_BLOCK = 0
#: a range's tiles and a row's ranges, at most (the kernel's limits)
MAX_RANGE_TILES = 64
MAX_RANGES = 128
#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: dynamic shared memory a block may have on the card, in bytes
SMEM_BYTES = 232448

_fns = {}
#: the dtypes of q, k and v the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: per device: the ranges' partials and counters (the counters all 0
#: between launches: each launch sets the ones it used back to 0)
_scratch_cache: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


class Plan(NamedTuple):
    range_slots: int    # absolute slots a block takes, a multiple of TILE
    stages: int         # cp.async ring depth, in tiles
    groups: int = 1     # blocks a KV head's G query heads are spread over


def head_groups(G: int) -> int:
    """Blocks a KV head's G query heads are spread over: ceil(G /
    MAX_HEADS), each the same number of heads (``HEADS_PER_BLOCK`` > 0 sets
    that number instead); a ValueError where G does not split so."""
    if HEADS_PER_BLOCK:
        groups = G // HEADS_PER_BLOCK if G % HEADS_PER_BLOCK == 0 else 0
    else:
        groups = math.ceil(G / MAX_HEADS)
    _require(1 <= G <= MAX_G and groups >= 1 and G % groups == 0
             and G // groups <= MAX_HEADS,
             f"G={G} query heads per KV head: the kernel takes 1..{MAX_G}, "
             f"split evenly over blocks of at most {MAX_HEADS}")
    return groups


def max_stages(D: int, dtype=torch.float32) -> int:
    """The deepest ring a block's shared memory holds at head dim D for K
    and V of ``dtype``. fp32 (the kernel's ``Smem<D>::kStagesFit``): its
    fixed part (G query rows, the partial scores, p, the softmax state and
    the tile masks) and two 32-slot tiles of rows padded to D + 4 floats a
    stage; 6 at most, 3 at D = 256. bf16 (``SmemB<D>::kStagesFit``): each
    warp's ring, a stage a 16-slot step of K and V in rows padded to D + 8
    values for each of the 8 warps, beside the bf16 query rows, the masks
    and the warps' (m, l); 6, 6, 3 and 1 at D = 32, 64, 128, 256."""
    if dtype == torch.bfloat16:       # bytes: the kernel's SmemB<D>
        row = (D + 8) * 2
        fixed = 16 * row + 4 * MAX_RANGE_TILES + 4 * 2 * (WARPS + 1) * MAX_HEADS
        return min(6, (SMEM_BYTES - fixed) // (WARPS * 2 * BF16_STEP * row))
    fixed = MAX_HEADS * D + MAX_HEADS * MAX_HEADS * TILE + MAX_HEADS * TILE \
        + 3 * MAX_HEADS + MAX_RANGE_TILES
    return min(6, (SMEM_BYTES // 4 - fixed) // (2 * TILE * (D + 4)))


def _plan(S: int, Hkv: int, G: int, D: int, sms: int,
          dtype=torch.float32) -> Plan:
    """A block's range, ring and head groups from one row's shape (and
    dtype) and the card's SM count, never from B, the lengths or the slot
    positions: G's query heads in :func:`head_groups` blocks; ranges of a
    whole number of tiles, as many as fit ``BLOCKS_PER_SM`` blocks of one
    row (every KV head and head group) on every SM and no more, within the
    kernel's limits (``RANGE_SLOTS`` > 0 sets the range instead); a ring of
    ``STAGES`` tiles, or of a range's tiles or :func:`max_stages` of D
    where that is shorter (and of 2 at least for more than one tile); bf16,
    each warp's ring of ``STAGES_BF16`` steps, or of its steps of a range or
    :func:`max_stages` of D where that is shorter. D and the dtype change
    the plan only by the ring, and G up to MAX_HEADS not at all."""
    groups = head_groups(G)
    tiles = math.ceil(S / TILE)
    if RANGE_SLOTS:
        per = RANGE_SLOTS // TILE
    else:
        per = math.ceil(tiles / max(1, BLOCKS_PER_SM * sms // (Hkv * groups)))
    per = min(max(per, math.ceil(tiles / MAX_RANGES)), tiles, MAX_RANGE_TILES)
    if dtype == torch.bfloat16:
        steps = math.ceil(per * TILE / BF16_STEP / WARPS)   # a warp's, at most
        return Plan(per * TILE, max(1, min(STAGES_BF16, steps,
                                           max_stages(D, dtype))), groups)
    # a ring of one stage holds a one-tile range only
    return Plan(per * TILE, max(min(STAGES, per, max_stages(D)), min(2, per)),
                groups)


def ranges(S: int, range_slots: int) -> int:
    """Ranges of a row of S slots: ``range_slots`` each from slot 0, the
    last one the rest of S."""
    return math.ceil(S / range_slots)


def _kernel(bf16: bool = False):
    """The C entry point for fp32 (``flash_decode_fwd``) or bf16 q, k and v
    (``flash_decode_fwd_bf16``); both take the same arguments."""
    fn = _fns.get(bf16)
    if fn is None:
        fn = (build.load("flash_decode_bf16").flash_decode_fwd_bf16 if bf16
              else build.load("flash_decode").flash_decode_fwd)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        F = ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, P, L, P, L, I, I, I, I, I, I, I, I,
                       F, F, P]
        fn.restype = ctypes.c_int
        _fns[bf16] = fn
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def check_inputs(q, k, v, slot_positions, lengths):
    """Shape, dtype and layout checks (before the device's, so that they
    hold on any device), then :func:`_on_device`."""
    _require(q.dtype in DTYPES,
             f"q must be float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.dtype == q.dtype and t.dim() == 4 and t.is_contiguous(),
                 f"{name} must be contiguous 4-D {q.dtype}")
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    _require(tuple(k.shape) == (B, S, Hkv, D) and v.shape == k.shape,
             f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _require(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    head_groups(G)
    _require(slot_positions.dtype == torch.int32
             and tuple(slot_positions.shape) == (B, S)
             and slot_positions.is_contiguous(),
             "slot_positions must be contiguous int32 (B, S)")
    _require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,)
             and lengths.is_contiguous(),
             "lengths must be contiguous int32 (B,)")
    _on_device(q, k, v, slot_positions, lengths)


def _on_device(q, k, v, slot_positions, lengths):
    """Every input on q's device, a CUDA device; q, k and v 16-byte
    aligned (the kernel reads them 16 bytes at a time)."""
    for t in (k, v, slot_positions, lengths):
        _require(t.device == q.device, f"inputs must all be on {q.device}")
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _scratch(floats: int, counters: int, device):
    """The ranges' partials (kept, grown on demand) and counters (kept,
    zeroed once): no allocation or memset per call on one stream."""
    parts, counts = _scratch_cache.get(device, (None, None))
    if parts is None or parts.numel() < floats:
        parts = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                            device=device)
    if counts is None or counts.numel() < counters:
        counts = torch.zeros(max(counters, 1024), dtype=torch.int32,
                             device=device)
    _scratch_cache[device] = (parts, counts)
    return parts, counts


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 slot_positions: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, S, Hkv, D); slot_positions: (B, S) int32
    absolute position per cache slot (-1 = empty); lengths: (B,) int32
    current decode position (inclusive); ``softcap`` > 0 caps the scaled
    scores before the mask (tanh(s / c) * c). q, k and v float32 or all
    bfloat16. Returns (B, Hkv, G, D) float32."""
    global launches, launches_softcap, launches_bf16
    _require(softcap >= 0, f"softcap {softcap} < 0")
    check_inputs(q, k, v, slot_positions, lengths)
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    out = torch.empty((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out.zero_()
    plan = _plan(S, Hkv, G, D, build.sm_count(q.device), q.dtype)
    n = ranges(S, plan.range_slots)
    parts = counts = None
    if n > 1:
        parts, counts = _scratch(B * Hkv * n * G * (D + 2),
                                 B * Hkv * plan.groups, q.device)
    bf16 = q.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    kernel = _kernel(True) if bf16 else _kernel()
    err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 slot_positions.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(),
                 None if parts is None else parts.data_ptr(),
                 0 if parts is None else parts.numel(),
                 None if counts is None else counts.data_ptr(),
                 0 if counts is None else counts.numel(),
                 B, S, Hkv, G, D, plan.range_slots, plan.stages,
                 plan.groups, 1.0 / math.sqrt(D), float(softcap), stream)
    build.check(err, "flash_decode_fwd")
    launches += 1
    launches_softcap += int(softcap > 0)
    launches_bf16 += int(bf16)
    return out
