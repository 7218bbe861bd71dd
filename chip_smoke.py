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
                counts are those of the server path.
The kernel phase (2) also holds the server path's kernels at its shapes
(per-row qmatmul, chunked-prefill attention) and the two kernels no path
runs yet (atu_update, mp_glu_ffn). Then the card's name and power limit
(nvidia-smi), one JSON line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
that line. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
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
FULL_LAYERS = 4
#: server_full's traffic: 8 chat requests over 4 shared 64-token system
#: prompts (reuse 0.75), 16 new tokens each, all arriving at once
SERVER_FULL = ["--arch", "qwen2.5-14b", "--workload", "shared-prefix",
               "--requests", "8", "--shared-prefix-len", "64",
               "--prefix-reuse", "0.75", "--gen-len", "16", "16",
               "--rate", "1e9", "--max-batch", "4", "--prefill-bucket", "4",
               "--dram-gb", "6"]


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            per[ev.key[:80]] = t / 1e3 / reps
    if not per:
        return {"device_ms": "not measured", "why": "no CUDA kernel events"}
    dev_ms = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return {"device_ms": dev_ms, "profiled_wall_ms": wall_ms,
            "busy_share": dev_ms / wall_ms, "top_kernels_ms": top}


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


# ---------------------------------------------------------------------------
# Phase 2: kernels at the main path's shapes


def phase_kernels(cfg, dev, B: int, P: int, gen_len: int) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import build_neuron_banks, unpack_int4
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
    banks = build_neuron_banks(randn(d, f, scale=d ** -0.5),
                               randn(d, f, scale=d ** -0.5),
                               randn(f, d, scale=f ** -0.5))
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
                          ref.qmatmul_ref(x4, banks[f"wu{sfx}"],
                                          None if prec == "fp" else
                                          banks[f"wu{sfx}_s"], precision=prec),
                          1e-5))
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
            banks[f"{w}_fp"][:, i16],
            banks[f"{w}_i8"][:, i8].float() * banks[f"{w}_i8_s"][i8],
            unpack_int4(banks[f"{w}_i4"][:, i4], 0).float() * banks[f"{w}_i4_s"][i4]],
            dim=1).contiguous()
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
            "M": M,
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "weight_bytes": 3 * d * (k16 * 4 + k8 + k4 / 2),
            "profile": device_profile(
                lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gathered"] = dict(ffn["decode"], max_abs_err=max(errs),
                                   prefill=ffn["prefill"])

    # --- flash_decode at the decode step's shapes (cache of P + gen + 1)
    S = P + gen_len + 1
    q = randn(B, hkv, G, D)
    kc, vc = randn(B, S, hkv, D), randn(B, S, hkv, D)
    slots = torch.arange(S, device=dev, dtype=torch.int32)[None].repeat(B, 1)
    slots[1, 5:9] = -1                                  # empty slots
    lengths = torch.tensor([P + i * (gen_len // max(B - 1, 1)) for i in range(B)],
                           device=dev, dtype=torch.int32)
    errs = [check("flash_decode", flash_decode(q, kc, vc, slots, lengths),
                  ref.flash_decode_ref(q, kc, vc, slots, lengths), 1e-5)]
    qs = randn(3, 2, 4, 32)
    ks_, vs_ = randn(3, 37, 2, 32), randn(3, 37, 2, 32)
    sl = torch.arange(37, device=dev, dtype=torch.int32)[None].repeat(3, 1)
    ln = torch.tensor([0, 17, 36], device=dev, dtype=torch.int32)
    errs.append(check("flash_decode ragged S=37 D=32",
                      flash_decode(qs, ks_, vs_, sl, ln),
                      ref.flash_decode_ref(qs, ks_, vs_, sl, ln), 1e-5))
    valid = (slots >= 0) & (slots <= lengths[:, None])
    n_valid = int(valid.sum())
    qt = q.reshape(B, hq, 1, D)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    nbytes = (q.numel() * 2 + slots.numel() + B) * 4 + 2 * n_valid * hkv * D * 4
    b_ms, b_by = bound(nbytes, 4 * n_valid * hq * D)
    out["flash_decode"] = {
        "max_abs_err": max(errs), "B": B, "S": S,
        "ms": time_ms(lambda: flash_decode(q, kc, vc, slots, lengths)),
        "plain_ms": time_ms(lambda: ref.flash_decode_ref(q, kc, vc, slots,
                                                         lengths)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: flash_decode(q, kc, vc, slots,
                                                       lengths)),
        "library_profile": device_profile(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))}

    # --- flash_attention at the prefill's shapes, plus ragged and windowed
    q = randn(B, P, hq, D)
    kp, vp = randn(B, P, hkv, D), randn(B, P, hkv, D)
    errs = [check("flash_attention", flash_attention(q, kp, vp),
                  ref.flash_attention_ref(q, kp, vp), 1e-5)]
    qr, kr, vr = randn(2, 45, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
    errs.append(check("flash_attention ragged S=45 D=64",
                      flash_attention(qr, kr, vr),
                      ref.flash_attention_ref(qr, kr, vr), 1e-5))
    errs.append(check("flash_attention window=20",
                      flash_attention(qr, kr, vr, window=20),
                      ref.flash_attention_ref(qr, kr, vr, window=20), 1e-5))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kp.transpose(1, 2).contiguous(), vp.transpose(1, 2).contiguous()
    nbytes = (2 * q.numel() + 2 * kp.numel()) * 4
    b_ms, b_by = bound(nbytes, 4 * B * hq * D * P * (P + 1) / 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    out["flash_attention"] = {
        "max_abs_err": max(errs), "B": B, "S": P,
        "ms": time_ms(lambda: flash_attention(q, kp, vp)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, kp, vp)),
        "library_ms": time_ms(sdpa), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: flash_attention(q, kp, vp)),
        "library_profile": device_profile(sdpa)}
    log({"phase": "kernels", "checks": checks, "kernels": out})
    del banks, lib_w
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 2, continued: the server path's kernels and the two no path runs


def phase_kernels_server(cfg, dev, R: int = 4, chunk: int = 16,
                         sbuf: int = 256) -> dict:
    """Per-row gathered qmatmul (R rows with their own active sets, M = 1
    and M = chunk), chunked-prefill attention at pos0 0/48/96/112 over a
    ``sbuf``-slot buffer, atu_update and mp_glu_ffn, each against its plain
    version, timed beside it, a library call and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import build_neuron_banks, unpack_int4
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.atu_update import atu_update
    from repro_torch.kernels.chunk_attention import chunk_attention
    from repro_torch.kernels.qmatmul import qmatmul_gathered

    g = torch.Generator(device=dev).manual_seed(4321)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sizes = tier_sizes(f, cfg)
    k, k16, k8, k4 = sizes["k"], sizes["fp16"], sizes["int8"], sizes["int4"]
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    wd = randn(f, d, scale=f ** -0.5)
    banks = build_neuron_banks(wg, wu, wd)
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
            if cols:
                parts.append(torch.cat([
                    banks[f"{w}_fp"][:, i16],
                    banks[f"{w}_i8"][:, i8].float() * banks[f"{w}_i8_s"][i8],
                    unpack_int4(banks[f"{w}_i4"][:, i4], 0).float()
                    * banks[f"{w}_i4_s"][i4]], dim=1))
            else:
                parts.append(torch.cat([
                    banks[f"{w}_fp"][i16],
                    banks[f"{w}_i8"][i8].float() * banks[f"{w}_i8_s"][i8][:, None],
                    unpack_int4(banks[f"{w}_i4"][i4], 1).float()
                    * banks[f"{w}_i4_s"][i4][:, None]], dim=0))
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
        errs.append(check(f"mp_ffn rows {label} R={R} M={M}", got,
                          ref.mp_ffn_gathered_ref(x, banks, idx, sizes,
                                                  cfg.ffn_act), 1e-5))

        def lib():
            h = F.silu(torch.bmm(x, lib_w["wg"])) * torch.bmm(x, lib_w["wu"])
            return torch.bmm(h, lib_w["wd"])
        nbytes = union + R * (3 * 4 * (k8 + k4) + 4 * k) + 2 * R * M * d * 4
        b_ms, b_by = bound(nbytes, 2 * R * M * d * k * 3)
        shapes[label] = {
            "R": R, "M": M,
            "ms": time_ms(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                             cfg.ffn_act)),
            "plain_ms": time_ms(lambda: ref.mp_ffn_gathered_ref(
                x, banks, idx, sizes, cfg.ffn_act)),
            "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "union_weight_bytes": union, "kernel_weight_bytes": per_row,
            "profile": device_profile(lambda: ops.mp_ffn(x, banks, idx, sizes,
                                                         cfg.ffn_act)),
            "library_profile": device_profile(lib)}
    out["qmatmul_gathered_rows"] = dict(shapes["decode"], max_abs_err=max(errs),
                                        chunk=shapes["chunk"])
    del lib_w

    # --- chunked-prefill attention at pos0 0/48/96/112 over sbuf slots
    pos0 = [0, 48, 96, 112][:R]
    q = randn(R, chunk, hq, D)
    kb, vb = randn(R, sbuf, hkv, D), randn(R, sbuf, hkv, D)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
    got = chunk_attention(q, kb, vb, p0)
    errs = [check("chunk_attention", got, ref.chunk_attention_ref(q, kb, vb, p0),
                  1e-5)]
    kg, vg = kb.clone(), vb.clone()
    for b, p in enumerate(pos0):             # non-finite bytes above the front
        kg[b, p + chunk:] = float("nan")
        vg[b, p + chunk:] = float("inf")
    require(torch.equal(chunk_attention(q, kg, vg, p0), got),
            "chunk_attention: bytes above the prefill front changed the result")
    qr, kr, vr = randn(2, 16, 8, 64), randn(2, 45, 2, 64), randn(2, 45, 2, 64)
    pr = torch.tensor([3, 29], dtype=torch.int32, device=dev)
    errs.append(check("chunk_attention ragged Skv=45 D=64",
                      chunk_attention(qr, kr, vr, pr),
                      ref.chunk_attention_ref(qr, kr, vr, pr), 1e-5))
    q_pos = p0.long()[:, None] + torch.arange(chunk, device=dev)[None]
    mask = (torch.arange(sbuf, device=dev)[None, None, :]
            <= q_pos[:, :, None])[:, None]             # (R, 1, S, sbuf)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = kb.transpose(1, 2).contiguous(), vb.transpose(1, 2).contiguous()
    keys = sum(p + chunk for p in pos0)                # slots up to each front
    pairs = sum(p + i + 1 for p in pos0 for i in range(chunk))
    nbytes = 2 * q.numel() * 4 + 2 * keys * hkv * D * 4 + R * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * hq * D)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    out["chunk_attention"] = {
        "max_abs_err": max(errs), "R": R, "S": chunk, "S_buf": sbuf,
        "pos0": pos0,
        "ms": time_ms(lambda: chunk_attention(q, kb, vb, p0)),
        "plain_ms": time_ms(lambda: ref.chunk_attention_ref(q, kb, vb, p0)),
        "library_ms": time_ms(sdpa), "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: chunk_attention(q, kb, vb, p0)),
        "library_profile": device_profile(sdpa)}

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
    errs = [check("mp_glu_ffn", ops.mp_glu_ffn(x, compact, act_name=cfg.ffn_act),
                  ref.mp_glu_ffn_ref(x, compact, cfg.ffn_act), 1e-5)]
    deq = {}
    for tier, tb in compact.items():
        if tier == "fp":
            deq[tier] = {w: tb[w] for w in ("wg", "wu", "wd")}
        elif tier == "int8":
            deq[tier] = {w: tb[w].float() * tb[s] for w, s in
                         (("wg", "sg"), ("wu", "su"), ("wd", "sd"))}
        else:
            deq[tier] = {w: unpack_int4(tb[w], 0).float() * tb[s] for w, s in
                         (("wg", "sg"), ("wu", "su"), ("wd", "sd"))}

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


#: the kernels each main path launches (the rest must stay at 0 there)
PATH_KERNELS = {"serve": ("qmatmul", "flash_decode", "flash_attention"),
                "server": ("qmatmul", "flash_decode", "chunk_attention")}


def counters():
    from repro_torch.kernels import (atu_update, chunk_attention,
                                     flash_attention, flash_decode, qmatmul)
    return {"qmatmul": qmatmul, "flash_decode": flash_decode,
            "flash_attention": flash_attention,
            "chunk_attention": chunk_attention, "atu_update": atu_update}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in counters().items()}


def require_path_kernels(phase: str, path: str, counts: dict):
    """Every kernel of the path ran; no kernel off the path did."""
    ran = {n for n, c in counts.items() if c > 0}
    require(ran == set(PATH_KERNELS[path]),
            f"{phase}: kernels launched {sorted(ran)}, the {path} path "
            f"runs {sorted(PATH_KERNELS[path])}: {counts}")


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
    require_path_kernels("tiny", "serve", cg)


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
        "tokens": res.tokens.tolist()}
    log(line)
    require(finite, "full: non-finite logits")
    require(in_vocab, "full: token outside the vocabulary")
    require(same, "full: a second run gave other tokens")
    require_path_kernels("full", "serve", counts)
    return counts


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
        require_path_kernels(f"server_tiny {name}", "server", cg)
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


def phase_server_full() -> dict:
    """qwen2.5-14b at full width, 4 layers, through the server: cold with
    the prefix cache (the counted run), warm from the tree it persisted
    (profiled), and with the prefix cache off."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.launch.server import run
    from repro_torch.models import transformer as T
    full = get_config("qwen2.5-14b")
    cfg = dataclasses.replace(full, num_layers=FULL_LAYERS)
    params = T.init_params(cfg, seed=0, device="cuda")
    draw_pred_a(params, torch.Generator(device="cuda").manual_seed(1), "cuda")
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
    kern = phase_kernels(cfg, torch.device("cuda"), B, P, gen_len)
    kern.update(phase_kernels_server(cfg, torch.device("cuda")))
    phase_tiny()
    paths = {"serve_full": phase_full(B, P, gen_len)}
    phase_server_tiny()
    paths["server_full"] = phase_server_full()

    # name -> (source, the TPU kernel it replaces, counter, paths that run it)
    k = "src/repro/kernels/"
    c = "src/repro_torch/csrc/"
    rows = {
        "qmatmul_gathered": (c + "qmatmul.cu", k + "qmatmul.py:38", "qmatmul",
                             ("serve_full",)),
        "qmatmul_gathered_rows": (c + "qmatmul.cu", k + "qmatmul.py:38",
                                  "qmatmul", ("server_full",)),
        "flash_decode": (c + "flash_decode.cu", k + "flash_decode.py:26",
                         "flash_decode", ("serve_full", "server_full")),
        "flash_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "flash_attention",
                            ("serve_full",)),
        "chunk_attention": (c + "flash_attention.cu",
                            k + "flash_attention.py:26", "chunk_attention",
                            ("server_full",)),
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
                "device_ms", "not measured")})
    print(nvidia_smi(), flush=True)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
