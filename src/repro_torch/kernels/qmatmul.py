"""Gathered quantized matmul — the CUDA kernels of the sparse mixed-precision
FFN (``csrc/qmatmul.cu``; they replace ``repro/kernels/qmatmul.py``'s
``_qmm_kernel``): kernel A for small M (bound by the weight bytes), kernel B
on the tensor cores for larger M.

``qmatmul_gathered`` launches them on CUDA tensors only; the plain version is
``kernels/ref.py``'s ``qmm_gathered_ref`` and the device dispatch lives in
``kernels/ops.py``. x is fp32 or bf16 (a bf16 model's, whose fp tier is
bf16 too; ``qmm_gathered_bf16`` in ``csrc/qmatmul_bf16.cu``, whose kernel B
runs on the bf16 tensor cores, the same plan), the output fp32 either way,
as the Pallas kernel's.

A bf16 FFN at small M (kernel A's rows) takes three kernels of its own
(``csrc/qmatmul_bf16.cu``): :func:`glu_bf16`, one launch for every tier's
gate and up products and the activation, writing h in bf16, and
:func:`ffn_down_bf16`, the tiers' down products (kernel A's row form)
into one buffer of partials and one launch that sums them in a fixed order
into the bf16 output. Their plain versions are ``kernels/ref.py``'s
``qmm_glu_ref`` and ``ffn_down_ref``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of either kernel since the count was last set to 0
launches = 0
#: launches of kernel A (small M, ``qmm_gemv_col`` / ``qmm_gemv_row``)
launches_gemv = 0
#: launches of kernel B (tensor cores, ``qmm_mma_kernel``)
launches_mma = 0
#: launches of either kernel with bf16 x (``qmm_gathered_bf16``, and the
#: down products of :func:`ffn_down_bf16`, kernel A's row form)
launches_bf16 = 0
#: launches of the fused bf16 GLU (``qmm_glu_bf16``; none of them count
#: above)
launches_glu = 0

PRECISIONS = {"fp": 0, "int8": 1, "int4": 2}
LAYOUTS = {"col": 0, "row": 1}
KERNELS = {"gemv": 0, "mma": 1}
#: kernel A takes one row's M up to this (at most 16, its largest tile),
#: kernel B larger M: one layer's
#: FFN at full width took less device time through kernel A at M = 1 and 4
#: and through kernel B at M = 8 and 16 (chip_smoke.py, kernels phase)
GEMV_MAX_M = 4
_GEMV_TILES = (1, 4, 8, 16)       # kernel A's compiled M bounds
_XS_FLOATS = 12288                # kernel A col: x floats staged per K chunk
_ROW_BLOCK_COLS = 256             # kernel A row: output columns per block
_ROW_IDS, _ROW_HS = 1024, 4096    # kernel A row: a split's staged ids, h
_MMA_ROW_SPAN = 2560              # kernel B row: a split's staged ids
_BK = 32
_BN = 64
#: the activations the fused GLU computes, by the C entry's code
GLU_ACTS = {"silu": 0, "gelu": 1, "relu": 2}
#: rows of M a fused GLU launch takes at most (its compiled M bounds: 1, 4)
GLU_MAX_M = 4

_fns = {}


def _kernel(bf16: bool = False):
    """The C entry point for fp32 x (``qmm_gathered``) or bf16 x
    (``qmm_gathered_bf16``); both take the same arguments."""
    fn = _fns.get(bf16)
    if fn is None:
        fn = (build.load("qmatmul_bf16").qmm_gathered_bf16 if bf16
              else build.load("qmatmul").qmm_gathered)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, L, I, I, I, I, I, I, I, I, I,
                       P, P, P]
        fn.restype = ctypes.c_int
        _fns[bf16] = fn
    return fn


def _ffn_kernels():
    """The small-M bf16 FFN's C entry points: (``qmm_glu_bf16``,
    ``qmm_down_parts_bf16``, ``qmm_down_sum_bf16``)."""
    fns = _fns.get("ffn")
    if fns is None:
        lib = build.load("qmatmul_bf16")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        glu, parts, total = (lib.qmm_glu_bf16, lib.qmm_down_parts_bf16,
                             lib.qmm_down_sum_bf16)
        glu.argtypes = [P] * 12 + [I, I, I, I, I, I, I, P]
        parts.argtypes = [P, P, P, P, I, I, I, I, L, I, I, I, I, I, P, P]
        total.argtypes = [P, I, L, I, I, I, P, P]
        for fn in (glu, parts, total):
            fn.restype = ctypes.c_int
        fns = _fns["ffn"] = (glu, parts, total)
    return fns


def bf16_row_terms() -> int:
    """The bf16 terms h x scale takes in bf16 kernel B's int tiers' row
    form, as its source sets it: those products issue this many MMAs."""
    return int(build.load("qmatmul_bf16").qmm_bf16_row_terms())


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"qmatmul_gathered: {msg}")


def _plan(M: int, N: int, K: int, layout: str, device) -> tuple:
    """(kernel, tile, splits, k_split) from one row's shape only, never
    from the row count, so that a row sums in the same order alone and in
    a group. Kernel A (``gemv``) for M <= GEMV_MAX_M, kernel B (``mma``)
    above. Kernel A col: tile = its M bound,
    k_split = the K chunk of x it stages, no split. Otherwise K (the
    contraction) is split until the row has about two blocks per SM
    (kernel A row, whose split also fits its staged ids and h) or four
    (kernel B, whose blocks are four warps)."""
    kernel = "gemv" if M <= GEMV_MAX_M else "mma"
    sms = build.sm_count(device)
    if kernel == "gemv":
        tile = next(t for t in _GEMV_TILES if t >= M)
        if layout == "col":
            kc = min(math.ceil(K / _BK) * _BK, _XS_FLOATS // tile // _BK * _BK)
            return kernel, tile, 1, kc
        blocks = math.ceil(N / _ROW_BLOCK_COLS)
        want = math.ceil(2 * sms / blocks)
        cap = min(_ROW_IDS, _ROW_HS // tile) // _BK * _BK
    else:
        tile = 16 if M <= 16 else 64
        blocks = math.ceil(N / _BN) * math.ceil(M / tile)
        want = math.ceil(4 * sms / blocks)
        cap = K if layout == "col" else _MMA_ROW_SPAN
    splits = max(1, min(want, math.ceil(K / _BK)), math.ceil(K / cap))
    k_split = min(math.ceil(math.ceil(K / splits) / _BK) * _BK, cap)
    return kernel, tile, math.ceil(K / k_split), k_split


def qmatmul_gathered(x: torch.Tensor, w: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     idx: Optional[torch.Tensor] = None, *,
                     precision: str = "fp", layout: str = "col",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both layouts read neuron-major banks (``core.quantize.
    to_neuron_major``).
    col: ``x (M, K) @ dequant(w[idx, :]).T`` -> (M, len(idx)) with w (f, K)
    [int4: (f, K/2)] and a per-neuron (output) scale (f,).
    row: ``x (M, len(idx)) @ dequant(w[idx, :])`` -> (M, N) with w (f, N)
    [int4: (f, N/2)] and a per-neuron (contraction) scale (f,).
    x is float32 or bfloat16; the fp tier's ``w`` has x's dtype; the
    output is float32.
    With ``out`` given the product is added into it in place and ``out``
    is returned. Rows: x (R, M, K) with idx (R, n) gives (R, M, N), each
    row with its own active set. ``idx=None`` takes every neuron in order.
    ``idx`` values must lie in [0, f): the kernels read them unchecked."""
    global launches, launches_gemv, launches_mma, launches_bf16
    _require(precision in PRECISIONS, f"precision {precision!r}")
    _require(layout in LAYOUTS, f"layout {layout!r}")
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"x must be float32 or bfloat16, got {x.dtype}")
    _require(x.dim() in (2, 3) and x.is_contiguous(),
             "x must be contiguous (M, K) or (R, M, K)")
    bf16 = x.dtype == torch.bfloat16
    wdt = x.dtype if precision == "fp" else torch.int8
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
    bank = w.shape[0]
    width = w.shape[1] * (2 if precision == "int4" else 1)
    if layout == "col":
        _require(width == K, f"w {tuple(w.shape)} does not match K={K}")
        N = bank if idx is None else n_idx
    else:
        _require((bank if idx is None else n_idx) == K,
                 f"x has K={K} but the gather selects "
                 f"{bank if idx is None else n_idx} rows")
        N = width
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
    kern, tile, splits, k_split = _plan(M, N, K, layout, x.device)
    if bf16 and kern == "mma" and x.data_ptr() % 16:
        x = x.clone()           # kernel B's bf16 rows copy from an aligned base
    parts = None
    if splits > 1:
        parts = torch.empty((R, splits, M, N), dtype=torch.float32,
                            device=x.device)
    ldw = w.shape[1] * w.element_size()
    vec_w = w.data_ptr() % 16 == 0 and ldw % 16 == 0
    vec_x = x.data_ptr() % 16 == 0 and K % 4 == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel = _kernel(True) if bf16 else _kernel()
    err = kernel(x.data_ptr(), w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 None if idx is None else idx.data_ptr(),
                 R, M, N, K, ldw, PRECISIONS[precision], LAYOUTS[layout],
                 KERNELS[kern], tile, splits, k_split, int(vec_x),
                 int(vec_w), int(accumulate), out.data_ptr(),
                 None if parts is None else parts.data_ptr(), stream)
    build.check(err,
                f"qmm_gathered({x.dtype}, {precision}, {layout}, {kern})")
    launches += 1
    launches_bf16 += int(bf16)
    if kern == "gemv":
        launches_gemv += 1
    else:
        launches_mma += 1
    return out


def _bank_checks(x, w, scale, precision: str, width: int):
    """A tier's bank beside bf16 x: its dtype and layout, (f, width) values
    (int4: width / 2 bytes), and its scale for an int tier."""
    wdt = torch.bfloat16 if precision == "fp" else torch.int8
    _require(w.device == x.device and w.dtype == wdt and w.dim() == 2
             and w.is_contiguous(),
             f"{precision} weights must be contiguous 2-D {wdt} on {x.device}")
    _require(w.shape[1] * (2 if precision == "int4" else 1) == width,
             f"w {tuple(w.shape)} does not match {width} values a row")
    if precision == "fp":
        _require(scale is None, "the fp tier takes no scale")
    else:
        _require(scale is not None and scale.device == x.device
                 and scale.dtype == torch.float32 and scale.dim() == 1
                 and scale.is_contiguous() and scale.numel() == w.shape[0],
                 f"scale must be a contiguous float32 ({w.shape[0]},) vector")


def _rows_and_idx(x, idx, bank: int):
    """(R, M, K) of x (M, K) or (R, M, K), and the active count n, with
    idx (n,) or (R, n) int32 on x's device, or None (every row of a bank
    of ``bank``)."""
    _require(x.dtype == torch.bfloat16 and x.dim() in (2, 3)
             and x.is_contiguous(),
             f"x must be contiguous bf16 (M, K) or (R, M, K), got {x.dtype} "
             f"{tuple(x.shape)}")
    rows = x.dim() == 3
    R, M, K = x.shape if rows else (1, *x.shape)
    if idx is None:
        return R, M, K, bank
    _require(idx.device == x.device and idx.dtype == torch.int32
             and idx.dim() == (2 if rows else 1) and idx.is_contiguous()
             and (not rows or idx.shape[0] == R),
             "idx must be a contiguous int32 (n,) vector, or (R, n) for "
             "x (R, M, K), on the same device")
    return R, M, K, idx.shape[-1]


def glu_bf16(x: torch.Tensor, tiers, *, act: str = "silu",
             products: bool = False) -> list:
    """The gate and up products and the activation of an FFN's tiers in one
    launch (``qmm_glu_bf16``): x (M, K) or (R, M, K) bf16 with M <=
    GLU_MAX_M; ``tiers``, in the order fp, int8, int4 (any left out), each
    (precision, wg, wu, sg, su, idx): the tier's neuron-major banks (fp:
    bf16 (f, K); int8 (f, K); int4 (f, K/2)), their per-neuron scales (int
    tiers) and the active neurons as ``qmatmul_gathered`` takes them.
    Returns, a tier each, h = activation(bf16(gate)) * bf16(up), bf16 (M,
    n) or (R, M, n), every op of the activation rounded to bf16
    (``models.common``'s); with ``products`` (h, gate, up), the fp32
    products it rounded. Raises before any launch on what the kernel does
    not take."""
    global launches_glu
    _require(act in GLU_ACTS, f"the fused GLU takes {sorted(GLU_ACTS)}, "
                              f"not {act!r}")
    _require(x.is_cuda, "x must be a CUDA tensor")
    order = [PRECISIONS.get(t[0], -1) for t in tiers]
    _require(1 <= len(tiers) <= len(PRECISIONS) and min(order) >= 0
             and order == sorted(set(order)),
             f"tiers {[t[0] for t in tiers]}: each of {list(PRECISIONS)} at "
             f"most once, in that order")
    R = M = K = None
    outs, slots = [], [None] * len(PRECISIONS)
    for precision, wg, wu, sg, su, idx in tiers:
        R, M, K, N = _rows_and_idx(x, idx, wg.shape[0])
        _require(1 <= M <= GLU_MAX_M, f"the fused GLU takes M <= "
                                      f"{GLU_MAX_M}, not {M}")
        for w, s in ((wg, sg), (wu, su)):
            _bank_checks(x, w, s, precision, K)
        _require(wu.shape == wg.shape, "wg and wu must be one shape")
        shape = (R, M, N) if x.dim() == 3 else (M, N)
        h = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
        gate = up = None
        if products:
            gate, up = (torch.empty(shape, dtype=torch.float32,
                                    device=x.device) for _ in range(2))
        outs.append((h, gate, up) if products else h)
        slots[PRECISIONS[precision]] = (wg, wu, sg, su, idx, N, h, gate, up)
    if R == 0 or K == 0 or all(t is None or t[5] == 0 for t in slots):
        for out in outs:
            (out[0] if products else out).zero_()
        return outs
    _, tile, _, k_chunk = _plan(M, max(t[5] for t in slots if t), K, "col",
                                x.device)

    def arr(ctype, values):
        return (ctype * len(values))(*values)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    empty = (None,) * 5 + (0, None, None, None)
    cols = list(zip(*(t or empty for t in slots)))
    wgs, wus = cols[0], cols[1]
    ldw = [w.shape[1] * w.element_size() if w is not None else 0 for w in wgs]
    vec_w = [int(w is not None and w.data_ptr() % 16 == 0
                 and u.data_ptr() % 16 == 0 and b % 16 == 0)
             for w, u, b in zip(wgs, wus, ldw)]
    err = _ffn_kernels()[0](
        x.data_ptr(), arr(P, [ptr(w) for w in wgs]),
        arr(P, [ptr(u) for u in wus]), arr(P, [ptr(s) for s in cols[2]]),
        arr(P, [ptr(s) for s in cols[3]]), arr(P, [ptr(i) for i in cols[4]]),
        arr(I, cols[5]), arr(L, ldw), arr(I, vec_w),
        arr(P, [ptr(h) for h in cols[6]]), arr(P, [ptr(g) for g in cols[7]]),
        arr(P, [ptr(u) for u in cols[8]]), R, M, K, GLU_ACTS[act], tile,
        k_chunk, int(x.data_ptr() % 16 == 0 and K % 8 == 0),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"qmm_glu_bf16({act})")
    launches_glu += 1
    return outs


def ffn_down_bf16(terms) -> torch.Tensor:
    """The down products of an FFN's tiers, summed, in bf16: ``terms``, in
    tier order, (h, w, scale, idx, precision) with h (M, n) or (R, M, n)
    bf16 (M <= GLU_MAX_M) and ``w`` the tier's neuron-major down bank (f,
    N) (int4 (f, N/2)). Each term's product runs through kernel A's row
    form into its own block of partials (its K split as ``_plan`` gives it),
    and one more launch (``qmm_down_sum_bf16``) adds every block, in term
    and split order from 0, and rounds the sum to bf16 once. Returns (M, N)
    or (R, M, N) bf16."""
    global launches, launches_gemv, launches_bf16
    _require(1 <= len(terms) <= len(PRECISIONS),
             f"{len(terms)} terms: one to three tiers")
    h0 = terms[0][0]
    _require(h0.is_cuda, "h must be a CUDA tensor")
    w0, p0 = terms[0][1], terms[0][4]
    N = w0.shape[1] * (2 if p0 == "int4" else 1)
    plans = []
    for h, w, scale, idx, precision in terms:
        _require(precision in PRECISIONS, f"precision {precision!r}")
        R, M, K, n = _rows_and_idx(h, idx, w.shape[0])
        _require(h.dim() == h0.dim() and h.shape[:-1] == h0.shape[:-1],
                 "every term's h must have the first term's rows")
        _require(n == K, f"h has K={K} but the gather selects {n} rows")
        _require(1 <= M <= GLU_MAX_M, f"the down sum takes M <= "
                                      f"{GLU_MAX_M}, not {M}")
        _bank_checks(h, w, scale, precision, N)
        kern, tile, splits, k_split = _plan(M, N, K, "row", h.device)
        _require(kern == "gemv", "the down sum takes kernel A's row form")
        plans.append((tile, splits, k_split))
    R, M = (h0.shape[0], h0.shape[1]) if h0.dim() == 3 else (1, h0.shape[0])
    shape = (R, M, N) if h0.dim() == 3 else (M, N)
    y = torch.empty(shape, dtype=torch.bfloat16, device=h0.device)
    if R == 0 or N == 0:
        return y
    splits = [p[1] for p in plans] + [0] * (3 - len(plans))
    parts = torch.empty(R * M * N * sum(splits), dtype=torch.float32,
                        device=h0.device)
    stream = torch.cuda.current_stream(h0.device).cuda_stream
    _, down, total = _ffn_kernels()
    at = 0
    for (h, w, scale, idx, precision), (tile, s, k_split) in zip(terms,
                                                                 plans):
        ldw = w.shape[1] * w.element_size()
        vec_w = w.data_ptr() % 16 == 0 and ldw % 16 == 0
        err = down(h.data_ptr(), w.data_ptr(),
                   None if scale is None else scale.data_ptr(),
                   None if idx is None else idx.data_ptr(), R, M, N,
                   h.shape[-1], ldw, PRECISIONS[precision], tile, s, k_split,
                   int(vec_w), parts[at:].data_ptr(), stream)
        build.check(err, f"qmm_down_parts_bf16({precision})")
        at += R * s * M * N
        launches += 1
        launches_gemv += 1
        launches_bf16 += 1
    err = total(parts.data_ptr(), R, M * N, *splits, y.data_ptr(), stream)
    build.check(err, "qmm_down_sum_bf16")
    return y
