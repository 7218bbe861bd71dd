#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line:
  1. device   — the card's name and power limit, torch/CUDA versions, and
                the wall seconds of building every CUDA kernel from
                ``src/repro_torch/csrc``;
  2. kernels  — each kernel at the shapes the full-width main path gives
                it, held against its plain PyTorch version on the card
                (max|d| <= 1e-5 * max(1, max|plain|): fp32 sums in another
                order), and timed (CUDA events, warm, median) beside the
                plain version, a yardstick library call and the least time
                the card could take;
  3. tiny     — qwen2.5-14b tiny served through ``repro_torch.launch.serve``
                on ``cuda`` (kernels) and on ``cpu`` (plain versions) from
                the same weights: tokens equal, last logits within 1e-4
                (abs and rel), every kernel launched;
  4. full     — qwen2.5-14b at full width, depth cut to 4 layers, served
                with batch 4, prompt 128, 16 new tokens; its launch counts
                are those of the ``launch/serve`` path;
  5. server_tiny — qwen2.5-14b tiny through ``repro_torch.launch.server``
                (continuous batching, block-chunked prefill, radix prefix
                cache) on ``cuda`` against ``cpu`` from the same weights:
                tokens per request and the modeled-clock summary equal;
                batched decode on equals off;
  6. server_full — the server at full width (4 layers), 8 shared-prefix
                requests arriving together, cold then warm (the radix tree
                persisted by the first run), and with the prefix cache off:
                tokens equal, prefix hits, wall and device time per decode
                step and per prefill chunk, the device-busy share; its launch
                counts are those of the server path;
  7. server_obs_full — server_full's traffic (prefix cache cold) with every
                observability output on (trace, metrics with an interval,
                block trace, ledger, health), runs off/on/on/off: tokens
                equal on and off, the ledger conserves, every request has
                its queued, prefill and decode spans, the block trace reads
                back, the ledger rebuilt from the trace equals it; the
                median decode-step wall on and off;
  8. cluster_full — the same traffic on two replicas behind the prefix
                router (modeled devices rtx3090 and m40, one params tree on
                the card): a valid cluster summary, each replica's tokens
                equal to a standalone run of its sub-trace, both replicas
                served;
  9. divergence — the KV-divergence probe, tiny on cuda against cpu
                (overlaps and first divergence equal, logit differences
                within 1e-4), then the reference's probe settings (seeds
                0-3, 24-token prompts, 8 steps, top-5) at full width for
                int8 and int4, numbers of random weights with no gate.
Phases 7-9 share one set of full-width weights; each prints its seconds,
and a ``timing`` line gives every phase's.
The kernel phase (2) also holds the server path's kernels at its shapes
(per-row qmatmul, chunked-prefill attention) and the two kernels no path
runs yet (atu_update, mp_glu_ffn). qmatmul has two kernels (A for small
M, B on the tensor cores): every qmatmul row is held and profiled through
each kernel that takes its M, beside a second bound at the TF32 peak, and
one layer's FFN at M = 1, 4, 8, 16 through both gives the crossover; the
full-width paths must launch both. Both forms of prefill attention run on
the tensor cores too (second bound: 3 TF32 products per fp32 product) and
are also held at G = 5 and ragged shapes, at scores of about +-60 (against
the plain version and against the function in float64), a row alone
against the same row in a group of four, each key split of the chunk form
and paired and unpaired query tiles of the whole prompt (profiled too),
and timed at a 2048-token prompt beside SDPA (rows ``*_long``).
flash_decode, one kernel a call, is held at the serve decode step's
shapes (with a ring buffer, a row without a valid slot, NaN and Inf in
masked slots, a row alone against the same row in its group), over a
server decode batch, and at 4 K and 32 K slots beside SDPA, each with a
sweep of its range size (and ring depth at 4 K and 32 K); ``full`` and
``server_full`` print one decode forward's kernels and host ms
(``decode_forward``). Then the card's name and power limit
(nvidia-smi), one JSON line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM TF32 tensor cores, dense
FULL_LAYERS = 4
#: server_full's traffic: 8 chat requests over 4 shared 64-token system
#: prompts (reuse 0.75), 16 new tokens each, all arriving at once
SERVER_FULL = ["--arch", "qwen2.5-14b", "--workload", "shared-prefix",
               "--requests", "8", "--shared-prefix-len", "64",
               "--prefix-reuse", "0.75", "--gen-len", "16", "16",
               "--rate", "1e9", "--max-batch", "4", "--prefill-bucket", "4",
               "--dram-gb", "6"]
#: a decode batch of server_full: 4 rows at their own positions in the
#: engine's power-of-two bucket buffer (prompts of 73 to 87 tokens, up to 16
#: new tokens each)
SERVER_BUCKET = 128
SERVER_DECODE_LENGTHS = [88, 80, 93, 82]
#: flash_decode's rows: (slots, the rows' lengths); the serve row is the
#: full phase's decode cache (prompt 128 + 16 new + 1) with 4 empty slots
#: in row 1, the long ones are measurement only
DECODE_ROWS = {"flash_decode": (145, [128, 133, 138, 143]),
               "flash_decode_rows": (SERVER_BUCKET, SERVER_DECODE_LENGTHS),
               "flash_decode_long": (4096, [3968, 4000, 4064, 4095]),
               "flash_decode_32k": (32768, [32767])}


def log(obj):
    print(json.dumps(obj, default=float), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event timings around one call, warm. Where the
    host's launch work outlasts the kernel, this is the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def device_profile(fn, reps: int = 5) -> dict:
    """Device time per call from torch.profiler (CUDA kernel events only),
    the share of the wall the device was busy, and the kernels that took
    the most. Where the profiler sees no device time, says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per = {}
    # a second session where the first saw no CUDA kernel (it happened once,
    # to the index_select + index_copy_ yardstick)
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t > 0:
                per[ev.key[:80]] = t / 1e3 / reps
        if per:
            break
    if not per:
        return {"device_ms": "not measured", "why": "no CUDA kernel events "
                "in two profiler sessions"}
    dev_ms = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return {"device_ms": dev_ms, "profiled_wall_ms": wall_ms,
            "busy_share": dev_ms / wall_ms, "top_kernels_ms": top,
            "kernels_per_call": sum(1 for e in prof.events()
                                    if e.device_type == DeviceType.CUDA) / reps,
            "profiler_sessions": attempt + 1}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over ``peak`` (fp32 outside the tensor cores unless
    told otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_products(k16: int, k8: int, k4: int) -> int:
    """TF32 MMAs kernel B issues per fp32 product it replaces, summed over
    one layer's neurons: 3 for the fp tier (3xTF32), 2 for the int tiers
    (only the activation is split)."""
    return 3 * k16 + 2 * (k8 + k4)


def tf32_bound(nbytes: float, M: int, d: int, k16: int, k8: int,
               k4: int) -> dict:
    """The FFN's bound on the tensor cores: gate, up and down at M rows,
    each multiply-add issued as many times as the split needs, at 495
    TFLOP/s dense TF32."""
    ms, by = bound(nbytes, 2 * M * d * 3 * tf32_products(k16, k8, k4),
                   TF32_FLOPS)
    return {"bound_tf32_ms": ms, "bound_tf32_by": by,
            "bound_tf32_note": "TF32 dense peak x the split's products "
                               "(fp tier 3, int tiers 2)"}


def attention_row(run, plain, lib, nbytes: float, flops: float,
                  plain_reps: int = 20) -> dict:
    """Times of one attention kernel call beside its plain version and the
    library call, device profiles of the kernel and the library, and both
    bounds: fp32 outside the tensor cores, and the 3 TF32 products the
    kernel issues per fp32 product at the TF32 peak."""
    b_ms, b_by = bound(nbytes, flops)
    t_ms, t_by = bound(nbytes, 3 * flops, TF32_FLOPS)
    return {"ms": time_ms(run), "plain_ms": time_ms(plain, reps=plain_reps),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "bound_tf32_ms": t_ms, "bound_tf32_by": t_by,
            "bound_tf32_note": "TF32 dense peak x 3 products (both operands "
                               "split) per fp32 product",
            "profile": device_profile(run), "library_profile": device_profile(lib)}


@contextlib.contextmanager
def pairing(pair: bool):
    """Route every flash_attention call through a plan that pairs query
    tiles (or not), whatever the row's shape says."""
    from repro_torch.kernels import flash_attention
    saved = flash_attention._plan
    flash_attention._plan = lambda *a: saved(*a)._replace(pair=pair)
    try:
        yield
    finally:
        flash_attention._plan = saved


def by_pair(run, want) -> dict:
    """Device ms of ``run`` with query tiles paired and not; both held
    against ``want`` to the bit-for-bit result of the plan's own choice."""
    import torch
    out = {}
    for pair in (True, False):
        with pairing(pair):
            got = run()
            require(torch.equal(got, want),
                    f"flash_attention: pair={pair} changed the result")
            out[str(pair)] = device_profile(run).get("device_ms")
    return out


@contextlib.contextmanager
def split_slots(slots: int):
    """Route every chunk_attention call through a key split of ``slots``
    slots per range (0: the whole key axis in one block)."""
    from repro_torch.kernels import chunk_attention
    saved = chunk_attention.SPLIT_SLOTS
    chunk_attention.SPLIT_SLOTS = slots
    try:
        yield
    finally:
        chunk_attention.SPLIT_SLOTS = saved


def attention_f64(q, k, v, pos0=None):
    """Causal attention of queries at ``pos0[b] + i`` (0 when None) over
    slots at positions 0..Skv-1, all in float64: the yardstick of the
    large-score checks, where the plain versions' own fp32 rounding of
    the scores is of the order of the tolerance."""
    import torch
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    p0 = (torch.zeros(B, dtype=torch.long, device=q.device) if pos0 is None
          else pos0.long())
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / D ** 0.5
    q_pos = p0[:, None] + torch.arange(S, device=q.device)[None]
    mask = torch.arange(Skv, device=q.device)[None, None] <= q_pos[:, :, None]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, S, Hq, D)


def max_score(q, k) -> float:
    """max |q . k| / sqrt(D) of query head 0 against KV head 0."""
    import torch
    s = torch.einsum("bqd,bkd->bqk", q[:, :, 0], k[:, :, 0])
    return float(s.abs().max()) / q.shape[-1] ** 0.5


@contextlib.contextmanager
def kernel_choice(kernel):
    """Route every qmatmul call to kernel A ("gemv", M <= 16) or kernel B
    ("mma") by moving the crossover; None keeps the crossover."""
    from repro_torch.kernels import qmatmul
    saved = qmatmul.GEMV_MAX_M
    qmatmul.GEMV_MAX_M = {"gemv": 16, "mma": 0, None: saved}[kernel]
    try:
        yield
    finally:
        qmatmul.GEMV_MAX_M = saved


def per_kernel(check, label, M, fn, want) -> dict:
    """Each kernel that takes M (A up to 16, B always) held against the
    plain result and profiled on the device."""
    out = {}
    for kern in (("gemv", "mma") if M <= 16 else ("mma",)):
        with kernel_choice(kern):
            check(f"{label} [{kern}]", fn(), want, 1e-5)
            out[kern] = device_profile(fn)
    return {f"{k}_device_ms": v.get("device_ms") for k, v in out.items()} | {
        "per_kernel_profile": out}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def checker(checks: list):
    """check(name, got, want, tol_rel): fail unless ``got`` is finite and
    within tol_rel * max(1, max|want|) of ``want``; records the check in
    ``checks`` and returns max|got - want|."""
    import torch

    def check(name, got, want, tol_rel):
        err = max_err(got, want)
        tol = tol_rel * max(1.0, float(want.abs().max()))
        checks.append({"check": name, "max_abs_err": err, "tol": tol})
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{name}: max|d|={err:.3g} > tol {tol:.3g}")
        return err
    return check


@contextlib.contextmanager
def decode_plan(range_slots: int = 0, stages: int = 0):
    """Route every flash_decode call through ranges of ``range_slots``
    slots and a ring of ``stages`` tiles (0 keeps the plan's own)."""
    from repro_torch.kernels import flash_decode
    saved = flash_decode.RANGE_SLOTS, flash_decode.STAGES
    flash_decode.RANGE_SLOTS = range_slots or saved[0]
    flash_decode.STAGES = stages or saved[1]
    try:
        yield
    finally:
        flash_decode.RANGE_SLOTS, flash_decode.STAGES = saved


def decode_inputs(randn, dev, S, hkv, G, D, lengths, holes=False):
    """q, k, v of a decode step over S slots for rows at ``lengths``, and
    the slot positions the decode step's mask gives them (slot i at
    position i up to the row's length, -1 above; with ``holes`` also four
    empty slots in row 1)."""
    import torch
    B = len(lengths)
    q = randn(B, hkv, G, D)
    kc, vc = randn(B, S, hkv, D), randn(B, S, hkv, D)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    if holes:
        slots[1, 5:9] = -1
    ln = torch.tensor(lengths, device=dev, dtype=torch.int32)
    return q, kc, vc, torch.where(slots <= ln[:, None], slots, -1), ln


def decode_row(check, randn, dev, label, S, hkv, G, D, lengths, *,
               holes=False, full_checks=False, sweep=(), stages=(),
               plain_reps=20) -> dict:
    """flash_decode over B = len(lengths) rows of S slots (slot i at
    position i, as the decode step's mask gives them; with ``holes`` four
    empty slots in row 1) against its plain version; with ``full_checks``
    also a row with no valid slot, NaN and Inf in every masked slot (bit
    for bit), and a row alone against the same row in the group. Each range
    size of ``sweep`` and ring depth of ``stages`` is held and profiled.
    Timed beside the plain version and SDPA, with the bound counted over
    the valid slots only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_decode import _plan, flash_decode
    B = len(lengths)
    hq = hkv * G
    q, kc, vc, slots, ln = decode_inputs(randn, dev, S, hkv, G, D, lengths,
                                         holes)
    run = lambda: flash_decode(q, kc, vc, slots, ln)
    got, want = run(), ref.flash_decode_ref(q, kc, vc, slots, ln)
    errs = [check(f"{label} B={B} S={S}", got, want, 1e-5)]
    require(torch.equal(run(), got), f"{label}: two calls differ")
    prof = device_profile(run)
    require(prof.get("kernels_per_call") == 1,
            f"{label}: a call ran {prof.get('kernels_per_call')} kernels")
    valid = (slots >= 0) & (slots <= ln[:, None])
    if full_checks:
        none = slots.clone()
        none[0] = -1
        errs.append(check(f"{label} row 0 without a valid slot",
                          flash_decode(q, kc, vc, none, ln),
                          ref.flash_decode_ref(q, kc, vc, none, ln), 1e-5))
        kn, vn = kc.clone(), vc.clone()
        kn[~valid], vn[~valid] = float("nan"), float("inf")
        require(torch.equal(flash_decode(q, kn, vn, slots, ln), got),
                f"{label}: NaN/Inf in masked slots changed the result")
        del kn, vn
        b = B - 1
        alone = flash_decode(q[b:b + 1].contiguous(), kc[b:b + 1].contiguous(),
                             vc[b:b + 1].contiguous(),
                             slots[b:b + 1].contiguous(), ln[b:b + 1])
        require(torch.equal(alone[0], got[b]),
                f"{label}: a row alone differs from the same row in a group")
    sms = build.sm_count(dev)
    by_range, by_stages = {}, {}
    for key, table, kw in ([(r, by_range, {"range_slots": r}) for r in sweep]
                           + [(n, by_stages, {"stages": n}) for n in stages]):
        with decode_plan(**kw):
            plan = _plan(S, hkv, G, D, sms)
            errs.append(check(f"{label} {kw}", run(), want, 1e-5))
            table[plan.range_slots if "range_slots" in kw else key] = \
                device_profile(run).get("device_ms")
    n_valid = int(valid.sum())
    qt = q.reshape(B, hq, 1, D)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
    nbytes = (q.numel() * 2 + slots.numel() + B) * 4 + 2 * n_valid * hkv * D * 4
    b_ms, b_by = bound(nbytes, 4 * n_valid * hq * D)
    row = {"max_abs_err": max(errs), "B": B, "S": S, "lengths": lengths,
           "valid_slots": n_valid, "plan": _plan(S, hkv, G, D, sms)._asdict(),
           "device_ms_by_range": by_range, "device_ms_by_stages": by_stages,
           "kv_mb": 2 * kc.numel() * 4 / 1e6,
           "l2_note": "inputs exceed the 50 MB L2" if kc.numel() * 8 > 50e6
           else "inputs stay in the 50 MB L2 across repetitions",
           "ms": time_ms(run), "plain_ms": time_ms(
               lambda: ref.flash_decode_ref(q, kc, vc, slots, ln),
               reps=plain_reps),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "profile": prof, "library_profile": device_profile(lib)}
    del q, kc, vc, kt, vt
    return row


# ---------------------------------------------------------------------------
# Phase 2: kernels at the main path's shapes


def phase_kernels(cfg, dev, B: int, P: int, gen_len: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks, to_neuron_major,
                                           unpack_int4)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.qmatmul import qmatmul_gathered

    g = torch.Generator(device=dev).manual_seed(1234)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = hq // hkv
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    dense = build_neuron_banks(randn(d, f, scale=d ** -0.5),
                               randn(d, f, scale=d ** -0.5),
                               randn(f, d, scale=f ** -0.5))
    banks = to_neuron_major(dense)          # the port's layout
    # scattered active set, as a trained (non-zero) predictor gives
    idx = torch.randperm(f, generator=g, device=dev)[:k]
    out, checks = {}, []
    check = checker(checks)

    # --- gathered qmatmul, piece by piece (col, row, identity, odd int4)
    x4 = randn(B, d)
    errs = []
    for prec, sfx, lo, n in (("fp", "_fp", 0, k16), ("int8", "_i8", k16, k8),
                             ("int4", "_i4", k16 + k8, k4)):
        t_idx = idx[lo:lo + n].to(torch.int32).contiguous()
        sc = None if prec == "fp" else banks[f"wg{sfx}_s"]
        errs.append(check(f"qmm col {prec} k={n}",
                          qmatmul_gathered(x4, banks[f"wg{sfx}"], sc, t_idx,
                                           precision=prec, layout="col"),
                          ref.qmm_gathered_ref(x4, banks[f"wg{sfx}"], sc, t_idx,
                                               precision=prec, layout="col"),
                          1e-5))
        h = randn(B, n)
        sd = None if prec == "fp" else banks[f"wd{sfx}_s"]
        y0 = randn(B, d)
        errs.append(check(f"qmm row {prec} k={n}",
                          qmatmul_gathered(h, banks[f"wd{sfx}"], sd, t_idx,
                                           precision=prec, layout="row",
                                           out=y0.clone()),
                          ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], sd, t_idx,
                                               precision=prec, layout="row",
                                               out=y0.clone()),
                          1e-5))
        errs.append(check(f"qmm identity {prec} vs qmatmul_ref",
                          qmatmul_gathered(x4, banks[f"wu{sfx}"],
                                           None if prec == "fp" else
                                           banks[f"wu{sfx}_s"],
                                           precision=prec, layout="col"),
                          ref.qmatmul_ref(x4, dense[f"wu{sfx}"],
                                          None if prec == "fp" else
                                          banks[f"wu{sfx}_s"], precision=prec),
                          1e-5))
    del dense
    odd = idx[:37].to(torch.int32).contiguous()
    for layout, w, s in (("col", "wg_i4", "wg_i4_s"), ("row", "wd_i4", "wd_i4_s")):
        xin = randn(3, d if layout == "col" else 37)
        errs.append(check(f"qmm {layout} int4 odd k=37",
                          qmatmul_gathered(xin, banks[w], banks[s], odd,
                                           precision="int4", layout=layout),
                          ref.qmm_gathered_ref(xin, banks[w], banks[s], odd,
                                               precision="int4", layout=layout),
                          1e-5))

    # --- the FFN of one layer at decode (M = B) and prefill (M = B*P) shapes
    # yardstick: torch.matmul over weights already gathered and dequantized
    lib_w = {}
    i16, i8, i4 = idx[:k16], idx[k16:k16 + k8], idx[k16 + k8:]
    for w in ("wg", "wu"):
        lib_w[w] = torch.cat([
            banks[f"{w}_fp"][i16],
            banks[f"{w}_i8"][i8].float() * banks[f"{w}_i8_s"][i8][:, None],
            unpack_int4(banks[f"{w}_i4"][i4], 1).float()
            * banks[f"{w}_i4_s"][i4][:, None]], dim=0).t().contiguous()
    lib_w["wd"] = torch.cat([
        banks["wd_fp"][i16],
        banks["wd_i8"][i8].float() * banks["wd_i8_s"][i8][:, None],
        unpack_int4(banks["wd_i4"][i4], 1).float() * banks["wd_i4_s"][i4][:, None]],
        dim=0).contiguous()
    ffn = {}
    for label, S in (("decode", 1), ("prefill", P)):
        x = randn(B, S, d)
        got = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        errs.append(check(f"mp_ffn {label} M={B * S}", got, want, 1e-5))
        x2 = x.reshape(B * S, d)

        def lib():
            h = F.silu(x2 @ lib_w["wg"]) * (x2 @ lib_w["wu"])
            return h @ lib_w["wd"]
        M = B * S
        nbytes = (3 * d * (k16 * 4 + k8 + k4 / 2)       # the active weights
                  + 3 * 4 * (k8 + k4) + 4 * k           # scales and ids
                  + 2 * M * d * 4)                      # x in, y out
        b_ms, b_by = bound(nbytes, 2 * M * d * k * 3)
        ffn[label] = {
            "M": M, **tf32_bound(nbytes, M, d, k16, k8, k4),
            **per_kernel(check, f"mp_ffn {label} M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act),
                         want),
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "weight_bytes": 3 * d * (k16 * 4 + k8 + k4 / 2),
            "profile": device_profile(
                lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gemv"] = dict(ffn["decode"], max_abs_err=max(errs))
    out["qmatmul_mma"] = dict(ffn["prefill"], max_abs_err=max(errs))

    # --- the crossover: one layer's FFN (shared set) at M = 1, 4, 8, 16
    # through kernel A and through kernel B
    cross = {}
    for M in (1, 4, 8, 16):
        x = randn(1, M, d)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        got = per_kernel(check, f"crossover mp_ffn M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act),
                         want)
        cross[M] = {k: got.pop(f"{k}_device_ms") for k in ("gemv", "mma")}
        cross[M]["top_kernels_ms"] = {
            k: p.get("top_kernels_ms") for k, p in
            got["per_kernel_profile"].items()}
    out["qmatmul_mma"]["crossover_device_ms"] = cross

    # --- flash_decode at the decode step's shapes (cache of P + gen + 1),
    # plus ragged D = 32, a ring buffer, a row with no valid slot, NaN in
    # masked slots and a row alone against the row in the group; its range
    # sizes; then 4 rows of 4 K slots and one row of 32 K (measurement)
    S, lengths = DECODE_ROWS["flash_decode"]
    require(S == P + gen_len + 1 and len(lengths) == B,
            "flash_decode: the serve row is not the full phase's cache")
    out["flash_decode"] = decode_row(check, randn, dev, "flash_decode", S,
                                     hkv, G, D, lengths, holes=True,
                                     sweep=(32, 64, 160), full_checks=True)
    qs = randn(3, 2, 4, 32)
    ks_, vs_ = randn(3, 37, 2, 32), randn(3, 37, 2, 32)
    sl = torch.arange(37, device=dev, dtype=torch.int32)[None].repeat(3, 1)
    ln = torch.tensor([0, 17, 36], device=dev, dtype=torch.int32)
    err = check("flash_decode ragged S=37 D=32",
                flash_decode(qs, ks_, vs_, sl, ln),
                ref.flash_decode_ref(qs, ks_, vs_, sl, ln), 1e-5)
    now = 300                           # a ring wrapped past 256 slots
    ring = now - torch.remainder(now - torch.arange(256, device=dev), 256)
    ring = ring.to(torch.int32)[None].repeat(2, 1).contiguous()
    qr_, kr_, vr_ = randn(2, 1, 2, 32), randn(2, 256, 1, 32), randn(2, 256, 1, 32)
    lr = torch.tensor([now, now - 60], device=dev, dtype=torch.int32)
    err = max(err, check("flash_decode ring buffer S=256",
                         flash_decode(qr_, kr_, vr_, ring, lr),
                         ref.flash_decode_ref(qr_, kr_, vr_, ring, lr), 1e-5))
    out["flash_decode"]["max_abs_err"] = max(out["flash_decode"]["max_abs_err"],
                                             err)
    for name, sweep in (("flash_decode_long", (64, 128, 256, 512, 1024)),
                        ("flash_decode_32k", (512, 1024, 2048))):
        S, lengths = DECODE_ROWS[name]
        out[name] = decode_row(check, randn, dev, name, S, hkv, G, D, lengths,
                               sweep=sweep, stages=(2, 3, 4), plain_reps=5)

    # --- flash_attention at the prefill's shapes, plus ragged, windowed,
    # G = 5 at a ragged S and scores of about +-60; a row alone against the
    # same row in the group
    q = randn(B, P, hq, D)
    kp, vp = randn(B, P, hkv, D), randn(B, P, hkv, D)
    got = flash_attention(q, kp, vp)
    errs = [check("flash_attention", got, ref.flash_attention_ref(q, kp, vp),
                  1e-5)]
    alone = flash_attention(q[1:2].contiguous(), kp[1:2].contiguous(),
                            vp[1:2].contiguous())
    require(torch.equal(alone[0], got[1]),
            "flash_attention: a row alone differs from the same row in a group")
    qr, kr, vr = randn(2, 45, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
    errs.append(check("flash_attention ragged S=45 D=64",
                      flash_attention(qr, kr, vr),
                      ref.flash_attention_ref(qr, kr, vr), 1e-5))
    errs.append(check("flash_attention window=20",
                      flash_attention(qr, kr, vr, window=20),
                      ref.flash_attention_ref(qr, kr, vr, window=20), 1e-5))
    q5, k5, v5 = randn(1, 77, 10, D), randn(1, 77, 2, D), randn(1, 77, 2, D)
    errs.append(check("flash_attention G=5 ragged S=77",
                      flash_attention(q5, k5, v5),
                      ref.flash_attention_ref(q5, k5, v5), 1e-5))
    ql, kl = q * 3.5, kp * 3.5
    big = max_score(ql, kl)
    require(big > 50, f"flash_attention: large scores reach only {big:.3g}")
    got_l, want64 = flash_attention(ql, kl, vp), attention_f64(ql, kl, vp)
    want32 = ref.flash_attention_ref(ql, kl, vp)
    errs.append(check(f"flash_attention scores to {big:.0f}", got_l, want32,
                      1e-5))
    errs.append(check(f"flash_attention scores to {big:.0f} vs float64",
                      got_l, want64, 1e-5))
    plain_err64 = max_err(want32, want64)
    del ql, kl, got_l, want32, want64
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _plan as whole_plan
    out["flash_attention"] = {
        "by_pair_device_ms": by_pair(lambda: flash_attention(q, kp, vp), got),
        "max_abs_err": max(errs), "B": B, "S": P, "max_score_checked": big,
        "plan": whole_plan(P, hq, hkv, D, build.sm_count(dev))._asdict(),
        "plain_max_abs_err_vs_f64_at_large_scores": plain_err64,
        **attention_row(lambda: flash_attention(q, kp, vp),
                        lambda: ref.flash_attention_ref(q, kp, vp),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True),
                        (2 * q.numel() + 2 * kp.numel()) * 4,
                        4 * B * hq * D * P * (P + 1) / 2)}

    # --- the same form at a 2048-token prompt (measurement only: the
    # products grow with S^2)
    SL = 2048
    q, kp, vp = randn(1, SL, hq, D), randn(1, SL, hkv, D), randn(1, SL, hkv, D)
    got = flash_attention(q, kp, vp)
    err = check(f"flash_attention S={SL}", got,
                ref.flash_attention_ref(q, kp, vp), 1e-5)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    out["flash_attention_long"] = {
        "by_pair_device_ms": by_pair(lambda: flash_attention(q, kp, vp), got),
        "max_abs_err": err, "B": 1, "S": SL,
        "plan": whole_plan(SL, hq, hkv, D, build.sm_count(dev))._asdict(),
        **attention_row(lambda: flash_attention(q, kp, vp),
                        lambda: ref.flash_attention_ref(q, kp, vp),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True),
                        (2 * q.numel() + 2 * kp.numel()) * 4,
                        4 * hq * D * SL * (SL + 1) / 2, plain_reps=5)}
    del q, kp, vp, qt, kt, vt, got
    log({"phase": "kernels", "checks": checks, "kernels": out})
    del banks, lib_w
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 2, continued: the server path's kernels and the two no path runs


def chunk_rows(check, randn, dev, *, pos0, chunk, sbuf, hq, hkv, D,
               splits) -> dict:
    """chunk_attention at ``pos0`` over ``sbuf`` slots against its plain
    version; with several rows also garbage above the fronts, a row alone
    against the row in the group, G = 5 at fronts inside a key tile and a
    key range, and scores of about +-60; each key split of ``splits`` held
    and profiled; then timed beside the plain version, SDPA and the bounds.
    """
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.chunk_attention import _plan, chunk_attention
    R = len(pos0)
    q = randn(R, chunk, hq, D)
    kb, vb = randn(R, sbuf, hkv, D), randn(R, sbuf, hkv, D)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    label = f"chunk_attention pos0={pos0} S_buf={sbuf}"
    got = chunk_attention(q, kb, vb, p0)
    want = ref.chunk_attention_ref(q, kb, vb, p0)
    errs = [check(label, got, want, 1e-5)]
    row = {}
    if R > 1:
        kg, vg = kb.clone(), vb.clone()
        for b, p in enumerate(pos0):         # non-finite bytes above the front
            kg[b, p + chunk:] = float("nan")
            vg[b, p + chunk:] = float("inf")
        require(torch.equal(chunk_attention(q, kg, vg, p0), got),
                "chunk_attention: bytes above the prefill front changed the "
                "result")
        del kg, vg
        b = R - 1
        alone = chunk_attention(q[b:b + 1].contiguous(), kb[b:b + 1].contiguous(),
                                vb[b:b + 1].contiguous(), p0[b:b + 1].contiguous())
        require(torch.equal(alone[0], got[b]),
                "chunk_attention: a row alone differs from the same row in a "
                "group")
        qr, kr, vr = randn(2, 16, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
        pr = torch.tensor([3, 29], dtype=torch.int32, device=dev)
        errs.append(check("chunk_attention ragged Skv=45 D=64",
                          chunk_attention(qr, kr, vr, pr),
                          ref.chunk_attention_ref(qr, kr, vr, pr), 1e-5))
        q5, k5, v5 = randn(2, 16, 10, D), randn(2, 77, 2, D), randn(2, 77, 2, D)
        p5 = torch.tensor([5, 61], dtype=torch.int32, device=dev)
        errs.append(check("chunk_attention G=5 fronts 20, 76 of Skv=77",
                          chunk_attention(q5, k5, v5, p5),
                          ref.chunk_attention_ref(q5, k5, v5, p5), 1e-5))
        ql, kl = q * 3.5, kb * 3.5
        big = max_score(ql, kl)
        require(big > 50, f"chunk_attention: large scores reach only {big:.3g}")
        got_l = chunk_attention(ql, kl, vb, p0)
        want32 = ref.chunk_attention_ref(ql, kl, vb, p0)
        want64 = attention_f64(ql, kl, vb, p0)
        errs.append(check(f"chunk_attention scores to {big:.0f}", got_l,
                          want32, 1e-5))
        errs.append(check(f"chunk_attention scores to {big:.0f} vs float64",
                          got_l, want64, 1e-5))
        row["max_score_checked"] = big
        row["plain_max_abs_err_vs_f64_at_large_scores"] = max_err(want32,
                                                                  want64)
        del ql, kl, got_l, want32, want64
    by_split = {}
    for slots in splits:
        with split_slots(slots):
            plan = _plan(chunk, sbuf, hq, hkv, D, build.sm_count(dev))
            errs.append(check(f"{label} split={plan.split}",
                              chunk_attention(q, kb, vb, p0), want, 1e-5))
            prof = device_profile(lambda: chunk_attention(q, kb, vb, p0))
            by_split[plan.split] = {
                "device_ms": prof.get("device_ms"),
                "ms": time_ms(lambda: chunk_attention(q, kb, vb, p0))}
    q_pos = p0.long()[:, None] + torch.arange(chunk, device=dev)[None]
    mask = (torch.arange(sbuf, device=dev)[None, None, :]
            <= q_pos[:, :, None])[:, None]             # (R, 1, S, sbuf)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
    keys = sum(p + chunk for p in pos0)                # slots up to each front
    pairs = sum(p + i + 1 for p in pos0 for i in range(chunk))
    plan = _plan(chunk, sbuf, hq, hkv, D, build.sm_count(dev))
    row.update({
        "max_abs_err": max(errs), "R": R, "S": chunk, "S_buf": sbuf,
        "pos0": pos0, "plan": plan._asdict(),
        "by_split": by_split, "split_extra_launches": 0,
        **attention_row(lambda: chunk_attention(q, kb, vb, p0),
                        lambda: ref.chunk_attention_ref(q, kb, vb, p0),
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True),
                        2 * q.numel() * 4 + 2 * keys * hkv * D * 4 + R * 4,
                        4 * pairs * hq * D)})
    return row


def phase_kernels_server(cfg, dev, R: int = 4, chunk: int = 16,
                         sbuf: int = 256) -> dict:
    """Per-row gathered qmatmul (R rows with their own active sets, M = 1
    and M = chunk), chunked-prefill attention at pos0 0/48/96/112 over a
    ``sbuf``-slot buffer (and one chunk at the end of 2048 slots), atu_update
    and mp_glu_ffn, each against its plain version, timed beside it, a
    library call and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import (build_neuron_banks, to_neuron_major,
                                           unpack_int4)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.atu_update import atu_update
    from repro_torch.kernels.qmatmul import qmatmul_gathered

    g = torch.Generator(device=dev).manual_seed(4321)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    wd = randn(f, d, scale=f ** -0.5)
    banks = to_neuron_major(build_neuron_banks(wg, wu, wd))
    out, checks = {}, []
    check = checker(checks)

    # --- per-row qmatmul: R rows, each with its own scattered active set
    idx = torch.stack([torch.randperm(f, generator=g, device=dev)[:k]
                       for _ in range(R)])
    errs = []
    tiers = (("fp", "_fp", 0, k16, 4.0), ("int8", "_i8", k16, k8, 1.0),
             ("int4", "_i4", k16 + k8, k4, 0.5))
    for M in (1, chunk):
        x = randn(R, M, d)
        for prec, sfx, lo, n, _ in tiers:
            t_idx = idx[:, lo:lo + n].to(torch.int32).contiguous()
            sc = None if prec == "fp" else banks[f"wg{sfx}_s"]
            got = qmatmul_gathered(x, banks[f"wg{sfx}"], sc, t_idx,
                                   precision=prec, layout="col")
            errs.append(check(f"qmm rows col {prec} R={R} M={M}", got,
                              ref.qmm_gathered_ref(x, banks[f"wg{sfx}"], sc,
                                                   t_idx, precision=prec),
                              1e-5))
            alone = qmatmul_gathered(x[1:2].contiguous(), banks[f"wg{sfx}"],
                                     sc, t_idx[1:2].contiguous(),
                                     precision=prec, layout="col")
            require(torch.equal(alone[0], got[1]),
                    f"qmm rows col {prec} M={M}: a row alone differs from "
                    "the same row in a group")
            h, y0 = randn(R, M, n), randn(R, M, d)
            sd = None if prec == "fp" else banks[f"wd{sfx}_s"]
            errs.append(check(f"qmm rows row {prec} R={R} M={M}",
                              qmatmul_gathered(h, banks[f"wd{sfx}"], sd, t_idx,
                                               precision=prec, layout="row",
                                               out=y0.clone()),
                              ref.qmm_gathered_ref(h, banks[f"wd{sfx}"], sd,
                                                   t_idx, precision=prec,
                                                   layout="row",
                                                   out=y0.clone()), 1e-5))

    # yardstick: one batched product per weight over per-row weights already
    # gathered and dequantized
    def dense_rows(w, cols):
        parts = []
        for r in range(R):
            i16, i8, i4 = (idx[r, :k16], idx[r, k16:k16 + k8],
                           idx[r, k16 + k8:])
            rows = torch.cat([             # (k, width): neuron-major banks
                banks[f"{w}_fp"][i16],
                banks[f"{w}_i8"][i8].float() * banks[f"{w}_i8_s"][i8][:, None],
                unpack_int4(banks[f"{w}_i4"][i4], 1).float()
                * banks[f"{w}_i4_s"][i4][:, None]], dim=0)
            parts.append(rows.t() if cols else rows)
        return torch.stack(parts).contiguous()
    lib_w = {"wg": dense_rows("wg", True), "wu": dense_rows("wu", True),
             "wd": dense_rows("wd", False)}
    # the bytes a row set must move: each distinct (tier, neuron) once, its
    # scales and ids, x in and y out; a simple kernel re-reads what rows share
    union = sum(len(torch.unique(idx[:, lo:lo + n])) * 3 * d * bpe
                for _, _, lo, n, bpe in tiers)
    per_row = R * 3 * d * (k16 * 4 + k8 + k4 / 2)
    shapes = {}
    for label, M in (("decode", 1), ("chunk", chunk)):
        x = randn(R, M, d)
        got = ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)
        want = ref.mp_ffn_gathered_ref(x, banks, idx, sizes, cfg.ffn_act)
        errs.append(check(f"mp_ffn rows {label} R={R} M={M}", got, want,
                          1e-5))

        def lib():
            h = F.silu(torch.bmm(x, lib_w["wg"])) * torch.bmm(x, lib_w["wu"])
            return torch.bmm(h, lib_w["wd"])
        nbytes = union + R * (3 * 4 * (k8 + k4) + 4 * k) + 2 * R * M * d * 4
        b_ms, b_by = bound(nbytes, 2 * R * M * d * k * 3)
        shapes[label] = {
            "R": R, "M": M,
            **tf32_bound(nbytes, R * M, d, k16, k8, k4),
            **per_kernel(check, f"mp_ffn rows {label} R={R} M={M}", M,
                         lambda: ops.mp_ffn(x, banks, idx, sizes,
                                            cfg.ffn_act), want),
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                             cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "union_weight_bytes": union, "kernel_weight_bytes": per_row,
            "profile": device_profile(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                                         cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gemv_rows"] = dict(shapes["decode"], max_abs_err=max(errs))
    out["qmatmul_mma_rows"] = dict(shapes["chunk"], max_abs_err=max(errs))
    del lib_w

    # --- chunked-prefill attention at pos0 0/48/96/112 over sbuf slots
    out["chunk_attention"] = chunk_rows(check, randn, dev, pos0=[0, 48, 96,
                                                                 112][:R],
                                        chunk=chunk, sbuf=sbuf, hq=hq,
                                        hkv=hkv, D=D, splits=(0, 32, 64, 128))
    # --- one chunk at the end of a 2048-slot buffer (measurement only)
    out["chunk_attention_long"] = chunk_rows(check, randn, dev, pos0=[2032],
                                             chunk=chunk, sbuf=2048, hq=hq,
                                             hkv=hkv, D=D,
                                             splits=(0, 128, 256, 512))

    # --- flash_decode over a decode batch of server_full
    S, lengths = DECODE_ROWS["flash_decode_rows"]
    out["flash_decode_rows"] = decode_row(
        check, randn, dev, "flash_decode_rows", S, hkv, hq // hkv, D,
        lengths[:R], full_checks=True, sweep=(32, 64, 128))

    # --- atu_update: m = 832 changed columns (104 groups of 8) of the fp32
    # bank into a (d, k4 + k8 + k16 + ...) unit, one duplicate destination
    bg, m = 8, 832
    unit_k = 4152
    groups = torch.randperm(f // bg, generator=g, device=dev)[:m // bg]
    dests = torch.randperm(unit_k // bg, generator=g, device=dev)[:m // bg]
    src = (groups[:, None] * bg + torch.arange(bg, device=dev)).reshape(-1)
    dst = (dests[:, None] * bg + torch.arange(bg, device=dev)).reshape(-1)
    src, dst = src.to(torch.int32).contiguous(), dst.to(torch.int32).contiguous()
    unit = randn(d, unit_k)
    want = ref.atu_update_ref(wg, unit.clone(), src.cpu(), dst.cpu(), bg=bg)
    got = atu_update(wg, unit.clone(), src, dst, bg=bg)
    require(torch.equal(got, want), "atu_update differs from its plain version")
    dup_dst = dst.clone()
    dup_dst[:bg] = dst[bg:2 * bg]              # groups 0 and 1 share a block
    want = ref.atu_update_ref(wg, unit.clone(), src.cpu(), dup_dst.cpu(), bg=bg)
    require(torch.equal(atu_update(wg, unit.clone(), src, dup_dst, bg=bg), want),
            "atu_update with a duplicate destination differs (last must win)")
    src_l, dst_l = src.long(), dst.long()
    scratch = unit.clone()

    def lib_copy():
        scratch.index_copy_(1, dst_l, wg.index_select(1, src_l))
    nbytes = 2 * m * d * 4 + 2 * m * 4
    b_ms, b_by = bound(nbytes, 0.0)
    out["atu_update"] = {
        "max_abs_err": 0.0, "d": d, "f": f, "k": unit_k, "m": m, "bg": bg,
        "ms": time_ms(lambda: atu_update(wg, scratch, src, dst, bg=bg)),
        "plain_ms": time_ms(lambda: ref.atu_update_ref(wg, scratch, src, dst,
                                                       bg=bg), reps=5),
        "library_ms": time_ms(lib_copy), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: atu_update(wg, scratch, src, dst,
                                                     bg=bg)),
        "library_profile": device_profile(lib_copy)}

    # --- mp_glu_ffn over compact banks of one active set: tiers 1037/1037/
    # 2072 (int4 packs along the contraction, so its width must be even;
    # the model's 2073 drops its last neuron here)
    csizes = dict(sizes, int4=k4 // 2 * 2)
    compact = ops.make_compact_banks(wg, wu, wd, csizes, idx[0])
    x = randn(R, d)
    want = ref.mp_glu_ffn_ref(x, compact, cfg.ffn_act)
    errs = [check("mp_glu_ffn", ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act),
                  want, 1e-5)]
    deq = {}                   # compact banks are output-major: (out, in)
    for tier, tb in compact.items():
        for w, sc in (("wg", "sg"), ("wu", "su"), ("wd", "sd")):
            v = (unpack_int4(tb[w], 1) if tier == "int4" else tb[w]).float()
            if tier != "fp":
                v = v * tb[sc][:, None]
            deq.setdefault(tier, {})[w] = v.t().contiguous()

    def lib_glu():
        y = 0.0
        for tb in deq.values():
            y = y + (F.silu(x @ tb["wg"]) * (x @ tb["wu"])) @ tb["wd"]
        return y
    wbytes = sum(t.numel() * t.element_size() for tb in compact.values()
                 for t in tb.values())
    kc = k16 + k8 + csizes["int4"]
    b_ms, b_by = bound(wbytes + 2 * x.numel() * 4, 2 * R * d * kc * 3)
    out["mp_glu_ffn"] = {
        "max_abs_err": max(errs), "B": R, "tiers": [k16, k8, csizes["int4"]],
        **per_kernel(check, "mp_glu_ffn", R,
                     lambda: ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act),
                     want),
        "ms": time_ms(lambda: ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act)),
        "plain_ms": time_ms(lambda: ref.mp_glu_ffn_ref(x, compact,
                                                       cfg.ffn_act)),
        "library_ms": time_ms(lib_glu), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: ops.mp_glu_ffn(
            x, compact, act_name=cfg.ffn_act)),
        "library_profile": device_profile(lib_glu)}
    log({"phase": "kernels_server", "checks": checks, "kernels": out})
    del banks, compact, deq, wg, wu, wd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through repro_torch.launch.serve


#: the kernels each main path launches at full width (the rest must stay
#: at 0 there): qmatmul's kernel A at decode, kernel B at prefill
PATH_KERNELS = {"serve": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                          "flash_attention"),
                "server": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                           "chunk_attention"),
                # the KV-divergence probe: whole-prompt prefill, then decode
                "divergence": ("qmatmul_gemv", "qmatmul_mma", "flash_decode",
                               "flash_attention")}
_QMM = ("qmatmul_gemv", "qmatmul_mma")


def counters():
    """name -> (module, counter attribute); "qmatmul" counts both of its
    kernels."""
    from repro_torch.kernels import (atu_update, chunk_attention,
                                     flash_attention, flash_decode, qmatmul)
    return {"qmatmul": (qmatmul, "launches"),
            "qmatmul_gemv": (qmatmul, "launches_gemv"),
            "qmatmul_mma": (qmatmul, "launches_mma"),
            "flash_decode": (flash_decode, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "chunk_attention": (chunk_attention, "launches"),
            "atu_update": (atu_update, "launches")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def require_path_kernels(phase: str, path: str, counts: dict,
                         each_qmm_kernel: bool = True):
    """Every kernel of the path ran; no kernel off the path did. With
    ``each_qmm_kernel`` off (the tiny phases, whose prefill chunks may stay
    below the crossover) qmatmul counts as one kernel."""
    want = set(PATH_KERNELS[path])
    if each_qmm_kernel:
        ran = {n for n, c in counts.items() if c > 0 and n != "qmatmul"}
    else:
        want = (want - set(_QMM)) | {"qmatmul"}
        ran = {n for n, c in counts.items() if c > 0 and n not in _QMM}
    require(ran == want,
            f"{phase}: kernels launched {sorted(ran)}, the {path} path "
            f"runs {sorted(want)}: {counts}")


def draw_pred_a(params, gen, device):
    """A trained predictor's A is non-zero; the reference's init zeroes it
    (so every active set would be 0..k-1). Draw it so the gathers are real."""
    import torch
    for layer in params["layers"]:
        A = layer["ffn"]["pred"]["A"]
        layer["ffn"]["pred"]["A"] = torch.randn(
            A.shape, generator=gen, device=device) * A.shape[0] ** -0.5


def serve_args(**kw):
    from repro_torch.launch.serve import build_parser
    argv = []
    for key, val in kw.items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if val is True else [flag, str(val)]
    return build_parser().parse_args(argv)


def phase_tiny():
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    params_gpu = _tree_to(params, "cuda")
    kw = dict(arch="qwen2.5-14b", tiny=True, batch=2, prompt_len=16,
              gen_len=8, dram_gb=0.5)
    runs = {}
    for device, p in (("cuda", params_gpu), ("cpu", params)):
        tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
        try:
            reset_counts()
            summary, res, eng = run(serve_args(device=device, **kw), cfg=cfg,
                                    params=p, ssd_dir=tmp)
            runs[device] = (res, eng.runner.last_logits.cpu(), read_counts(),
                            summary)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    (rg, lg, cg, sg), (rc, lc, _, sc) = runs["cuda"], runs["cpu"]
    err = float((lg - lc).abs().max())
    tol = 1e-4
    line = {"phase": "tiny", "config": cfg.name, "tokens_equal":
            bool((rg.tokens == rc.tokens).all()), "last_logits_max_abs_err": err,
            "tol_abs_rel": tol, "launches_cuda": cg,
            "modeled_s_equal": sg["modeled_s"] == sc["modeled_s"],
            "tokens": rg.tokens.tolist()}
    log(line)
    require(line["tokens_equal"], "tiny: cuda and cpu tokens differ")
    require(torch.allclose(lg, lc, atol=tol, rtol=tol),
            f"tiny: last logits differ by {err:.3g}")
    require_path_kernels("tiny", "serve", cg, each_qmm_kernel=False)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_full(B: int, P: int, gen_len: int) -> dict:
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models import transformer as T
    full = get_config("qwen2.5-14b")
    cfg = dataclasses.replace(full, num_layers=FULL_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    draw_pred_a(params, torch.Generator(device="cuda").manual_seed(1), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(params)) / 1e9
    kw = dict(arch="qwen2.5-14b", batch=B, prompt_len=P, gen_len=gen_len,
              device="cuda")
    tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        summary, res, eng = run(serve_args(**kw), cfg=cfg, params=params,
                                ssd_dir=tmp)
        serve_s = time.perf_counter() - t0
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ssd_gb = sum(p.stat().st_size for p in Path(tmp).glob("*.bin")) / 1e9
        last = eng.runner.last_logits
        wall = eng.runner.wall_s
        finite = bool(torch.isfinite(last).all())
        in_vocab = bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
        _, res2, _ = run(serve_args(**kw), cfg=cfg, params=params, ssd_dir=tmp)
        same = bool((res.tokens == res2.tokens).all())
        profiles = profile_steps(eng.runner, params, cfg, B, P)
        cost = decode_forward_cost(cfg, params, [P + gen_len // 2] * B,
                                   P + gen_len + 1, rows=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {
        "phase": "full", "config": cfg.name,
        "depth_cut": f"num_layers {full.num_layers} -> {FULL_LAYERS}",
        "widths": {"d_model": cfg.d_model, "heads": cfg.num_heads,
                   "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab_size},
        "pred_A": "drawn N(0, 1/d) on the device generator for this run "
                  "(the reference's init zeroes it)",
        "batch": B, "prompt_len": P, "gen_len": gen_len,
        "param_gb": param_gb, "init_s": init_s, "ssd_bank_files_gb": ssd_gb,
        "serve_wall_s": serve_s, "prefill_wall_s": wall["prefill"],
        "decode_wall_s_median": statistics.median(wall["decode"]),
        "decode_wall_s": wall["decode"], "peak_mem_gb": peak_gb,
        "launches": counts,
        "tokens_per_s_modeled": summary["tokens_per_s_modeled"],
        "carbon_g_modeled": summary["carbon_g"],
        "finite_logits": finite, "tokens_in_vocab": in_vocab,
        "second_run_tokens_equal": same, "profile": profiles,
        "decode_forward": cost,
        "tokens": res.tokens.tolist()}
    log(line)
    require(finite, "full: non-finite logits")
    require(in_vocab, "full: token outside the vocabulary")
    require(same, "full: a second run gave other tokens")
    require_path_kernels("full", "serve", counts)
    return counts


def decode_forward_cost(cfg, params, lengths, sbuf: int, rows: bool,
                        reps: int = 10) -> dict:
    """One ``forward(mode="decode")`` at the rows' ``lengths`` over an
    ``sbuf``-slot cache (``rows``: the server's per-row batch): the device
    activities it starts (CUDA kernels, and copies or fills apart) from
    torch.profiler, their device ms, and the median host ms until forward
    returns and until the device is done. Uses only what every version of
    the port has, so that ``scripts/decode_step_cost.py`` can run it on
    another tree."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    B = len(lengths)
    dev = params["embed"].device
    cache = T.init_cache(cfg, B, sbuf, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)

    def step():
        cache["pos"] = (torch.tensor(lengths, dtype=torch.int64) if rows
                        else lengths[0])
        T.forward(cfg, params, tok, cache=cache, mode="decode", rows=rows)
    step()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = collections.Counter()
    dev_ms = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:60]] += 1
            dev_ms += (e.time_range.end - e.time_range.start) / 1e3
    copies = sum(n for k, n in names.items()
                 if k.startswith(("Memcpy", "Memset")))
    del cache
    return {"rows": B, "lengths": list(lengths), "sbuf": sbuf,
            "layers": cfg.num_layers,
            "cuda_kernels": sum(names.values()) - copies,
            "copies_and_fills": copies, "device_ms": dev_ms,
            "host_ms_median": statistics.median(host),
            "wall_ms_median": statistics.median(wall),
            "most_launched": dict(names.most_common(12))}


def profile_steps(runner, params, cfg, B: int, P: int) -> dict:
    """Device time, busy share and top kernels of one prefill and of one
    decode step at the full-width shapes (after the counted run)."""
    import torch
    from repro_torch.launch.serve import make_prompts
    prompts = torch.as_tensor(make_prompts(cfg, B, P, 0), device="cuda")
    state = {}

    def prefill():
        state["last"], state["cache"], _ = runner._prefill(params, prompts)

    def decode():
        if state["cache"]["pos"] >= runner.max_seq:
            prefill()
        tok = torch.argmax(state["last"], dim=-1)[:, None]
        state["last"], state["cache"], _ = runner._decode(
            params, state["cache"], tok)
    out = {"prefill": device_profile(prefill, reps=2)}
    prefill()
    out["decode_step"] = device_profile(decode, reps=5)
    return out


# ---------------------------------------------------------------------------
# Phases 5 and 6: the main path through repro_torch.launch.server


def server_args(argv, **kw):
    from repro_torch.launch.server import parse_args
    for key, val in kw.items():
        flag = "--" + key.replace("_", "-")
        argv = argv + ([flag] if val is True else [flag, str(val)])
    return parse_args(argv)


def _tokens(rep) -> dict:
    return {r.rid: r.final_tokens() for r in rep.requests}


def last_logits(sess):
    """A session's last logits, in its decode-batch row if it has one."""
    return sess._batch.last[sess._row] if sess._batch is not None \
        else sess.last[0]


def phase_server_tiny():
    """The tiny server on cuda against cpu (same weights): shared-prefix
    turns with prefix reuse, and a burst that fills the decode batch."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.server import run
    from repro_torch.models import transformer as T
    cfg = get_config("qwen2.5-14b", tiny=True)
    params = T.init_params(cfg, seed=0, device="cpu")
    draw_pred_a(params, torch.Generator().manual_seed(1), "cpu")
    params_gpu = _tree_to(params, "cuda")
    shared = ["--arch", "qwen2.5-14b", "--tiny", "--workload", "shared-prefix",
              "--prefix-cache", "--turns", "2", "--requests", "8",
              "--prefill-chunk", "8", "--gen-len", "3", "6",
              "--shared-prefix-len", "24", "--max-batch", "4", "--rate", "50",
              "--dram-gb", "0.5"]
    burst = shared[:shared.index("--turns")] + shared[
        shared.index("--requests"):shared.index("--rate")] + [
        "--rate", "1e6", "--dram-gb", "0.5"]
    line = {"phase": "server_tiny", "config": cfg.name}
    for name, argv in (("shared_prefix", shared), ("burst", burst)):
        runs = {}
        for device, p in (("cuda", params_gpu), ("cpu", params)):
            for extra in ([], ["--no-batched-decode", "--prefill-bucket", "1"]):
                if extra and device == "cpu":
                    continue
                tmp = tempfile.mkdtemp(prefix="m2cache_ssd_")
                try:
                    reset_counts()
                    out, rep, eng, _ = run(server_args(argv + extra,
                                                       device=device),
                                           cfg=cfg, params=p, ssd_dir=tmp)
                    runs[(device, bool(extra))] = (out, _tokens(rep),
                                                   read_counts())
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
        (og, tg, cg), (oc, tc, _), (_, ts, _) = (
            runs[("cuda", False)], runs[("cpu", False)], runs[("cuda", True)])
        og, oc = (json.loads(json.dumps(o, default=float)) for o in (og, oc))
        res = {"tokens_equal_cuda_cpu": tg == tc,
               "modeled_fields_equal": {k: og[k] == oc[k] for k in
                                        ("summary", "kv", "cache", "prefix",
                                         "carbon_g")},
               "tokens_equal_batched_vs_per_session": tg == ts,
               "prefix_hit_tokens": og["summary"].get("prefix_hit_tokens"),
               "decode_rows_per_step": og["summary"]["total_tokens"]
               / max(og["summary"]["decode_steps"], 1),
               "launches_cuda": cg}
        line[name] = res
        require(res["tokens_equal_cuda_cpu"],
                f"server_tiny {name}: cuda and cpu tokens differ")
        require(all(res["modeled_fields_equal"].values()),
                f"server_tiny {name}: modeled fields differ: "
                f"{res['modeled_fields_equal']}")
        require(res["tokens_equal_batched_vs_per_session"],
                f"server_tiny {name}: batched decode changed the tokens")
        require_path_kernels(f"server_tiny {name}", "server", cg,
                             each_qmm_kernel=False)
    require(line["shared_prefix"]["prefix_hit_tokens"] > 0,
            "server_tiny: no prefix hit")
    require(line["burst"]["decode_rows_per_step"] > 1.5,
            "server_tiny: the burst never batched decode rows")
    log(line)


class StepClock:
    """Wall time of every engine decode_step and prefill_step (synchronised
    before and after), each inside a profiler range of its own name, and
    of the model forwards inside them (DecodeBatch.step, the runner's
    block-chunk prefill), so that a step splits into the forward and the
    engine's own host work (scheduling of rows, active-set unions, the
    modeled clock)."""

    def __init__(self):
        self.decode, self.prefill = [], []      # (wall s, forwards)
        self.forward = {"decode": [], "prefill": []}    # wall s per forward

    def __enter__(self):
        import torch
        from repro_torch.core.engine import M2CacheEngine
        from repro_torch.core.engine_model import DecodeBatch, RealModelRunner
        self._orig = [(M2CacheEngine, "decode_step"),
                      (M2CacheEngine, "prefill_step"),
                      (DecodeBatch, "step"),
                      (RealModelRunner, "_prefill_block"),
                      (RealModelRunner, "_prefill_block_rows")]
        self._orig = [(c, n, getattr(c, n)) for c, n in self._orig]

        def timed_step(name, fn, store):
            def wrapper(eng, *a, **kw):
                torch.cuda.synchronize()
                d0, p0 = eng.decode_dispatches, eng.prefill_dispatches
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    out = fn(eng, *a, **kw)
                    torch.cuda.synchronize()
                n = (eng.decode_dispatches - d0) + (eng.prefill_dispatches - p0)
                if n:
                    store.append((time.perf_counter() - t0, n))
                return out
            return wrapper

        def timed_forward(fn, store):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                store.append(time.perf_counter() - t0)
                return out
            return wrapper
        (dec, pre, step, block, rows) = (f for _, _, f in self._orig)
        M2CacheEngine.decode_step = timed_step("chip_smoke::decode_step", dec,
                                               self.decode)
        M2CacheEngine.prefill_step = timed_step("chip_smoke::prefill_step",
                                                pre, self.prefill)
        DecodeBatch.step = timed_forward(step, self.forward["decode"])
        RealModelRunner._prefill_block = timed_forward(
            block, self.forward["prefill"])
        RealModelRunner._prefill_block_rows = timed_forward(
            rows, self.forward["prefill"])
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._orig:
            setattr(cls, name, fn)

    def summary(self) -> dict:
        dec = [w for w, _ in self.decode]
        pre = [w / n for w, n in self.prefill]
        med = (lambda xs: statistics.median(xs) * 1e3 if xs else None)
        return {"decode_steps": len(dec),
                "decode_step_wall_ms_median": med(dec),
                "decode_forward_wall_ms_median": med(self.forward["decode"]),
                "decode_step_wall_s_total": sum(dec),
                "decode_forward_wall_s_total": sum(self.forward["decode"]),
                "prefill_forwards": sum(n for _, n in self.prefill),
                "prefill_chunk_wall_ms_median": med(pre),
                "prefill_forward_wall_ms_median": med(self.forward["prefill"]),
                "prefill_step_wall_s_total": sum(w for w, _ in self.prefill),
                "prefill_forward_wall_s_total": sum(self.forward["prefill"])}


def step_device_time(prof) -> dict:
    """Per kind of engine step (the ``chip_smoke::`` ranges StepClock
    opens): steps, summed wall ms, summed device ms of the CUDA kernels
    that ran inside the steps' ranges, the busy share, and the kernels that
    took the most. Says "not measured" where the profiler saw no kernel."""
    import bisect
    from torch.autograd import DeviceType
    evs = prof.events()
    # a range shows twice: on the host and as an annotation on the device
    ours = [e.name.startswith("chip_smoke::") for e in evs]
    spans = [(e.time_range.start, e.time_range.end, e.name.split("::")[1])
             for e, o in zip(evs, ours) if o and e.device_type == DeviceType.CPU]
    kern = sorted((e.time_range.start, e.time_range.end, e.name[:60])
                  for e, o in zip(evs, ours)
                  if not o and e.device_type == DeviceType.CUDA)
    starts = [k[0] for k in kern]
    out = {}
    for s0, s1, kind in spans:
        d = out.setdefault(kind, {"steps": 0, "wall_ms": 0.0,
                                  "device_ms": 0.0, "top_kernels_ms": {}})
        d["steps"] += 1
        d["wall_ms"] += (s1 - s0) / 1e3
        for k0, k1, name in kern[bisect.bisect_left(starts, s0):
                                 bisect.bisect_right(starts, s1)]:
            d["device_ms"] += (k1 - k0) / 1e3
            top = d["top_kernels_ms"]
            top[name] = top.get(name, 0.0) + (k1 - k0) / 1e3
    for d in out.values():
        if not d["device_ms"]:
            d.update(device_ms="not measured", top_kernels_ms={})
            continue
        d["busy_share"] = d["device_ms"] / d["wall_ms"]
        d["device_ms_per_step"] = d["device_ms"] / d["steps"]
        d["top_kernels_ms"] = dict(sorted(d["top_kernels_ms"].items(),
                                          key=lambda kv: -kv[1])[:8])
    return out


def phase_server_full(full, cfg, params) -> dict:
    """qwen2.5-14b at full width, 4 layers (``full_model``), through the
    server: cold with the prefix cache (the counted run), warm from the tree
    it persisted (profiled), and with the prefix cache off."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.server import run
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="m2cache_server_")
    persist = str(Path(tmp) / "radix")
    res = {}
    try:
        def serve(label, argv, ssd):
            with StepClock() as clock:
                t0 = time.perf_counter()
                out, rep, eng, _ = run(server_args(argv, device="cuda"),
                                       cfg=cfg, params=params,
                                       ssd_dir=str(Path(tmp) / ssd))
                wall = time.perf_counter() - t0
            res[label] = {"out": json.loads(json.dumps(out, default=float)),
                          "tokens": _tokens(rep), "wall_s": wall,
                          "steps": clock.summary(),
                          "restored": eng.prefix_restored_tokens,
                          "finite": all(bool(torch.isfinite(last_logits(
                              r.session)).all()) for r in rep.requests)}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        serve("cold", SERVER_FULL + ["--prefix-cache", "--prefix-persist",
                                     persist], "cold")
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve("warm", SERVER_FULL + ["--prefix-cache", "--prefix-persist",
                                         persist], "warm")
        serve("off", SERVER_FULL, "off")
        cost = decode_forward_cost(cfg, params, SERVER_DECODE_LENGTHS,
                                   SERVER_BUCKET, rows=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    toks = {k: res[k]["tokens"] for k in res}
    line = {
        "phase": "server_full", "config": cfg.name,
        "depth_cut": f"num_layers {full.num_layers} -> {FULL_LAYERS}",
        "args": SERVER_FULL, "peak_mem_gb": peak_gb, "launches": counts,
        "tokens_equal_cold_warm_off": toks["cold"] == toks["warm"]
        == toks["off"],
        "rids_differing": sorted(r for r in toks["cold"] if not (
            toks["cold"][r] == toks["warm"].get(r) == toks["off"].get(r))),
        "prefix_hit_tokens": {k: res[k]["out"]["summary"].get(
            "prefix_hit_tokens") for k in ("cold", "warm")},
        "prefix_restored_tokens": {k: res[k]["restored"]
                                   for k in ("cold", "warm")},
        "persist": res["warm"]["out"]["persist"],
        "wall_s": {k: res[k]["wall_s"] for k in res},
        "steps_cold": res["cold"]["steps"], "steps_off": res["off"]["steps"],
        "steps_warm_profiled": res["warm"]["steps"],
        "device_in_steps_warm": step_device_time(prof),
        "decode_forward": cost,
        "summary_cold": res["cold"]["out"]["summary"],
        "finite_logits": all(res[k]["finite"] for k in res),
        "tokens": res["cold"]["tokens"]}
    log(line)
    require(line["finite_logits"], "server_full: non-finite logits")
    require(line["tokens_equal_cold_warm_off"],
            "server_full: tokens differ between cold, warm and prefix-off")
    require((line["prefix_hit_tokens"]["warm"] or 0) > 0,
            "server_full: the warm run hit no prefix")
    require_path_kernels("server_full", "server", counts)
    return counts



# ---------------------------------------------------------------------------
# Phases 7 to 9: the observed server, the fleet and the divergence probe


def full_model(device: str = "cuda"):
    """qwen2.5-14b at full width, depth cut to FULL_LAYERS, the weights of
    server_full: seed 0, predictor A drawn from seed 1 on the device."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    full = get_config("qwen2.5-14b")
    cfg = dataclasses.replace(full, num_layers=FULL_LAYERS)
    params = T.init_params(cfg, seed=0, device=device)
    draw_pred_a(params, torch.Generator(device=device).manual_seed(1), device)
    return full, cfg, params


#: the observability outputs of server_obs_full: flag -> file name
OBS_OUTPUTS = {"--trace-out": "run.trace.json", "--metrics-out": "run.prom",
               "--block-trace-out": "run.blocks.jsonl",
               "--ledger": "run.ledger.json",
               "--health-out": "run.alerts.jsonl"}


def check_observed_run(tmp: Path, rep, sched) -> dict:
    """The requirements on one observed server run: its ledger conserves,
    every request has its queued, prefill and decode spans, the block trace
    reads back, and the ledger rebuilt from the trace alone equals the
    live one. Returns what was read."""
    from repro_torch.obs import (events_from_chrome, read_block_trace,
                                 reconstruct)
    doc = json.loads((tmp / OBS_OUTPUTS["--trace-out"]).read_text())
    events = events_from_chrome(doc)
    spans = {}
    for ev in events:
        if ev["kind"] == "span" and ev["track"].startswith("req"):
            spans.setdefault(ev["track"], set()).add(ev["name"])
    blocks = list(read_block_trace(tmp / OBS_OUTPUTS["--block-trace-out"]))
    with open(tmp / OBS_OUTPUTS["--block-trace-out"]) as f:
        header = json.loads(f.readline())
    live, back = sched.ledger.summary(), reconstruct(events).summary()
    keys = ("time_s", "gco2_g", "span_s", "horizon_s", "gco2_total_g")
    got = {"ledger_check": sched.ledger.check(),
           "requests_with_all_spans": sum(
               {"queued", "prefill", "decode"} <= spans.get(f"req:{r.rid}",
                                                            set())
               for r in rep.requests),
           "requests": len(rep.requests),
           "block_events_read": len(blocks),
           "block_events_header": header["events"],
           "ledger_from_trace_equal": all(back[k] == live[k] for k in keys),
           "trace_events": len(doc["traceEvents"]),
           "metric_snapshots": len((tmp / (OBS_OUTPUTS["--metrics-out"]
                                           + ".jsonl")).read_text()
                                   .splitlines())}
    require(not got["ledger_check"],
            f"server_obs_full: the ledger does not conserve: "
            f"{got['ledger_check']}")
    require(got["requests_with_all_spans"] == got["requests"],
            "server_obs_full: a request lacks its queued, prefill or decode "
            "span in the trace")
    require(0 < got["block_events_read"] == got["block_events_header"],
            "server_obs_full: the block trace does not read back")
    require(got["ledger_from_trace_equal"],
            "server_obs_full: the ledger rebuilt from the trace differs")
    return got


def phase_server_obs_full(cfg, params) -> dict:
    """server_full's traffic at full width (prefix cache cold) with every
    observability output on, against the same run with every output off:
    the same tokens, and the host cost of the outputs (runs off, on, on,
    off in one call)."""
    import torch
    from repro_torch.launch.server import run
    t_phase = time.perf_counter()
    argv = SERVER_FULL + ["--prefix-cache"]
    tmp = Path(tempfile.mkdtemp(prefix="m2cache_obs_"))
    res, counts = {}, None
    try:
        for i, on in enumerate((False, True, True, False)):
            label = f"{'on' if on else 'off'}{i}"
            extra = []
            if on:
                out_dir = tmp / label
                out_dir.mkdir()
                extra = ["--metrics-interval", "0.01"]
                for flag, name in OBS_OUTPUTS.items():
                    extra += [flag, str(out_dir / name)]
            first_on = on and counts is None
            if first_on:
                reset_counts()
            with StepClock() as clock:
                t0 = time.perf_counter()
                out, rep, eng, sched = run(
                    server_args(argv + extra, device="cuda"), cfg=cfg,
                    params=params, ssd_dir=str(tmp / f"ssd{i}"))
                wall = time.perf_counter() - t0
            if first_on:
                counts = read_counts()
            res[label] = {"out": json.loads(json.dumps(out, default=float)),
                          "tokens": _tokens(rep), "wall_s": wall,
                          "steps": clock.summary(),
                          "finite": all(bool(torch.isfinite(last_logits(
                              r.session)).all()) for r in rep.requests)}
            if on:
                res[label]["read"] = check_observed_run(out_dir, rep, sched)
            shutil.rmtree(tmp / f"ssd{i}", ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    toks = [r["tokens"] for r in res.values()]
    med = {k: statistics.median(
        r["steps"]["decode_step_wall_ms_median"] for l, r in res.items()
        if l.startswith(k)) for k in ("on", "off")}
    on = res["on1"]["out"]
    line = {
        "phase": "server_obs_full", "config": cfg.name,
        "args": argv + ["--metrics-interval", "0.01"] + list(OBS_OUTPUTS),
        "launches": counts, "tokens_equal_on_off": all(t == toks[0]
                                                       for t in toks),
        "obs": on["obs"], "ledger": on["ledger"], "health": on["health"],
        "read_back": res["on1"]["read"],
        "decode_step_wall_ms_median": {l: r["steps"][
            "decode_step_wall_ms_median"] for l, r in res.items()},
        "prefill_chunk_wall_ms_median": {l: r["steps"][
            "prefill_chunk_wall_ms_median"] for l, r in res.items()},
        "decode_step_wall_ms_median_on_off": med,
        "obs_decode_step_host_cost_ms": med["on"] - med["off"],
        "run_wall_s": {l: r["wall_s"] for l, r in res.items()},
        "finite_logits": all(r["finite"] for r in res.values()),
        "seconds": time.perf_counter() - t_phase}
    log(line)
    require(line["finite_logits"], "server_obs_full: non-finite logits")
    require(line["tokens_equal_on_off"],
            "server_obs_full: the outputs changed the tokens")
    require(on["ledger"]["conserved"], "server_obs_full: ledger not conserved")
    require_path_kernels("server_obs_full", "server", counts)
    return counts


def phase_cluster_full(cfg, params) -> dict:
    """Two replicas behind the prefix router at full width (one params tree
    on the card; the modeled devices an RTX 3090 and an M40) over
    server_full's traffic; each replica's tokens against a standalone run
    of its sub-trace."""
    import torch
    from repro_torch.launch.server import build_replica, run_cluster
    from repro_torch.serving import validate_cluster_summary
    t_phase = time.perf_counter()
    argv = SERVER_FULL + ["--replicas", "2", "--router", "prefix",
                          "--replica-devices", "rtx3090,m40"]
    args = server_args(argv, device="cuda")
    tmp = Path(tempfile.mkdtemp(prefix="m2cache_fleet_"))
    try:
        reset_counts()
        t0 = time.perf_counter()
        out, router = run_cluster(args, cfg=cfg, params=params,
                                  ssd_dir=str(tmp / "fleet"))
        fleet_s = time.perf_counter() - t0
        counts = read_counts()
        out = json.loads(json.dumps(out, default=float))
        shutil.rmtree(tmp / "fleet", ignore_errors=True)
        solo = {}
        for r in router.replicas:
            t0 = time.perf_counter()
            alone = build_replica(args, f"solo-{r.name}", r.device_name,
                                  r.carbon_trace, cfg=cfg, params=params,
                                  ssd_dir=str(tmp / r.name))
            alone.events = list(r.events)
            alone.run(vocab_size=cfg.vocab_size, horizon_s=args.horizon)
            solo[r.name] = {"tokens_equal": alone.tokens() == r.tokens(),
                            "summary_equal": alone.report.summary()
                            == r.report.summary(),
                            "wall_s": time.perf_counter() - t0}
            shutil.rmtree(tmp / r.name, ignore_errors=True)
        finite = all(bool(torch.isfinite(last_logits(q.session)).all())
                     for r in router.replicas for q in r.report.requests)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"phase": "cluster_full", "config": cfg.name, "args": argv,
            "launches": counts, "summary": out["summary"],
            "replicas": out["replicas"], "router": out["router"],
            "standalone": solo,
            "fleet_wall_s": fleet_s, "finite_logits": finite,
            "seconds": time.perf_counter() - t_phase}
    log(line)
    validate_cluster_summary(out["summary"], context="cluster_full")
    require(finite, "cluster_full: non-finite logits")
    require(all(v["tokens_equal"] for v in solo.values()),
            "cluster_full: a replica's tokens differ from a standalone run "
            f"of its sub-trace: {solo}")
    require(all(v["summary"]["requests"] > 0
                for v in out["replicas"].values()),
            "cluster_full: a replica served no request")
    require_path_kernels("cluster_full", "server", counts)
    return counts


#: the reference's probe settings (tests/test_kv_residency.py)
DIVERGENCE_SEEDS = range(4)
DIVERGENCE = dict(gen_len=8, k=5)


def _probes(cfg, params, device: str) -> dict:
    import numpy as np
    from repro_torch.eval import kv_divergence_probe
    out = {}
    for prec in ("int8", "int4"):
        for seed in DIVERGENCE_SEEDS:
            prompt = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, 24).tolist()
            out[prec, seed] = kv_divergence_probe(
                cfg, params, prompt, precision=prec, device=device,
                **DIVERGENCE).to_dict()
    return out


def phase_divergence(cfg, params) -> dict:
    """The KV-divergence probe: tiny on the card against the CPU (same
    weights), then the reference's probe settings at full width. The
    full-width numbers are of random weights and carry no gate."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    tiny = get_config("qwen2.5-14b", tiny=True)
    tp = T.init_params(tiny, seed=0, device="cpu")
    draw_pred_a(tp, torch.Generator().manual_seed(1), "cpu")
    on_card, on_cpu = (_probes(tiny, p, d) for p, d in
                       ((_tree_to(tp, "cuda"), "cuda"), (tp, "cpu")))
    exact = ("topk_overlap_mean", "topk_overlap_min",
             "first_token_divergence", "token_match_rate")
    tiny_equal = all(on_card[key][f] == on_cpu[key][f]
                     for key in on_cpu for f in exact)
    tiny_err = max(abs(on_card[key][f] - on_cpu[key][f]) for key in on_cpu
                   for f in ("max_abs_diff", "mean_abs_diff"))
    reset_counts()
    t0 = time.perf_counter()
    full = _probes(cfg, params, "cuda")
    full_s = time.perf_counter() - t0
    counts = read_counts()
    per_prec = {}
    for prec in ("int8", "int4"):
        reps = [full[prec, s] for s in DIVERGENCE_SEEDS]
        per_prec[prec] = {
            "topk_overlap_mean": statistics.mean(
                r["topk_overlap_mean"] for r in reps),
            "topk_overlap_per_seed": [r["topk_overlap_mean"] for r in reps],
            "max_abs_diff_worst": max(r["max_abs_diff"] for r in reps),
            "first_token_divergence_per_seed": [
                r["first_token_divergence"] for r in reps],
            "token_match_rate_mean": statistics.mean(
                r["token_match_rate"] for r in reps)}
    line = {"phase": "divergence", "config": cfg.name,
            "probe": {"seeds": list(DIVERGENCE_SEEDS), "prompt_len": 24,
                      **DIVERGENCE},
            "tiny_cuda_equals_cpu": tiny_equal,
            "tiny_logit_diff_max_abs_err": tiny_err, "tiny_tol": 1e-4,
            "tiny": {f"{p}/{s}": on_card[p, s] for p, s in on_card},
            "full_width_random_weights": per_prec, "launches": counts,
            "full_width_s": full_s,
            "finite": all(all(math.isfinite(v) for v in r.values()
                              if isinstance(v, float)) for r in full.values()),
            "seconds": time.perf_counter() - t_phase}
    log(line)
    require(tiny_equal, "divergence: tiny probe on the card differs from "
                        "the CPU in overlaps or first divergence")
    require(tiny_err <= 1e-4,
            f"divergence: tiny logit differences differ by {tiny_err:.3g}")
    require(line["finite"], "divergence: non-finite full-width numbers")
    require_path_kernels("divergence", "divergence", counts)
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    log({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0],
         "kernel_build_s": time.perf_counter() - t0,
         "ptxas": {n: [l.strip() for l in txt.splitlines()
                       if "registers" in l or "spill" in l]
                   for n, txt in build.build_log.items()}})
    B, P, gen_len = 4, 128, 16
    cfg = get_config("qwen2.5-14b")
    seconds = {"device": time.perf_counter() - t0}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out
    kern = timed("kernels", phase_kernels, cfg, torch.device("cuda"), B, P,
                 gen_len)
    kern.update(timed("kernels_server", phase_kernels_server, cfg,
                      torch.device("cuda")))
    timed("tiny", phase_tiny)
    paths = {"serve_full": timed("full", phase_full, B, P, gen_len)}
    timed("server_tiny", phase_server_tiny)
    full, full_cfg, params = timed("full_model", full_model)
    paths["server_full"] = timed("server_full", phase_server_full, full,
                                 full_cfg, params)
    for name, fn in (("server_obs_full", phase_server_obs_full),
                     ("cluster_full", phase_cluster_full),
                     ("divergence", phase_divergence)):
        paths[name] = timed(name, fn, full_cfg, params)
    del params
    log({"phase": "timing", "seconds": seconds,
         "total_s": time.perf_counter() - t0})

    # name -> (source, the TPU kernel it replaces, counter, paths that run it)
    k = "src/repro/kernels/"
    c = "src/repro_torch/csrc/"
    server_paths = ("server_full", "server_obs_full", "cluster_full")
    decode_paths = ("serve_full",) + server_paths + ("divergence",)
    rows = {
        "qmatmul_gemv": (c + "qmatmul.cu", k + "qmatmul.py:38",
                         "qmatmul_gemv", ("serve_full", "divergence")),
        "qmatmul_mma": (c + "qmatmul.cu", k + "qmatmul.py:38",
                        "qmatmul_mma", ("serve_full", "divergence")),
        "qmatmul_gemv_rows": (c + "qmatmul.cu", k + "qmatmul.py:38",
                              "qmatmul_gemv", server_paths),
        "qmatmul_mma_rows": (c + "qmatmul.cu", k + "qmatmul.py:38",
                             "qmatmul_mma", server_paths),
        "flash_decode": (c + "flash_decode.cu", k + "flash_decode.py:26",
                         "flash_decode", decode_paths),
        # the same kernel over a server decode batch, and at 4 K and 32 K
        # slots: its launches are those of the row above
        "flash_decode_rows": (c + "flash_decode.cu", k + "flash_decode.py:26",
                              "flash_decode", server_paths),
        "flash_decode_long": (c + "flash_decode.cu", k + "flash_decode.py:26",
                              "flash_decode", decode_paths),
        "flash_decode_32k": (c + "flash_decode.cu", k + "flash_decode.py:26",
                             "flash_decode", decode_paths),
        "flash_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "flash_attention",
                            ("serve_full", "divergence")),
        "chunk_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "chunk_attention",
                            server_paths),
        # the two forms at a 2048-token prompt: the same kernels, whose
        # launches are those of the rows above
        "flash_attention_long": (c + "flash_attention.cu",
                                 k + "flash_attention.py:26",
                                 "flash_attention", ("serve_full",
                                                     "divergence")),
        "chunk_attention_long": (c + "flash_attention.cu",
                                 k + "flash_attention.py:26",
                                 "chunk_attention", server_paths),
        "atu_update": (c + "atu_update.cu", k + "atu_update.py:24",
                       "atu_update", ()),
        "mp_glu_ffn": (c + "qmatmul.cu", k + "ops.py:54", None, ()),
    }
    table = []
    for name, (src, replaces, counter, on) in rows.items():
        kk = kern[name]
        by_path = {p: paths[p][counter] for p in on}
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": kk["max_abs_err"], "ms": kk["ms"],
            "plain_ms": kk["plain_ms"], "bound_ms": kk["bound_ms"],
            "bound_by": kk["bound_by"], "library_ms": kk["library_ms"],
            "device_ms": kk["profile"].get("device_ms"),
            "library_device_ms": kk.get("library_profile", {}).get(
                "device_ms", "not measured"),
            **{key: kk[key] for key in ("gemv_device_ms", "mma_device_ms",
                                        "bound_tf32_ms", "bound_tf32_by")
               if key in kk}})
    print(nvidia_smi(), flush=True)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
