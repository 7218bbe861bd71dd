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
                with batch 4, prompt 128, 16 new tokens; the launch counts
                of this run are the ones reported.
Then the card's name and power limit (nvidia-smi), one JSON line with the
kernel table, and as the last line ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero before that line. Imports no JAX.
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
    out = {}
    checks = []

    def check(name, got, want, tol_rel):
        err = max_err(got, want)
        tol = tol_rel * max(1.0, float(want.abs().max()))
        checks.append({"check": name, "max_abs_err": err, "tol": tol})
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{name}: max|d|={err:.3g} > tol {tol:.3g}")
        return err

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
                lambda: ops.mp_ffn(x, banks, idx, sizes, cfg.ffn_act))}
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
                                                       lengths))}

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
    out["flash_attention"] = {
        "max_abs_err": max(errs), "B": B, "S": P,
        "ms": time_ms(lambda: flash_attention(q, kp, vp)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, kp, vp)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "profile": device_profile(lambda: flash_attention(q, kp, vp))}
    log({"phase": "kernels", "checks": checks, "kernels": out})
    del banks, lib_w
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main path through repro_torch.launch.serve


def counters():
    from repro_torch.kernels import flash_attention, flash_decode, qmatmul
    return {"qmatmul_gathered": qmatmul, "flash_decode": flash_decode,
            "flash_attention": flash_attention}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in counters().items()}


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
    require(all(n > 0 for n in cg.values()), f"tiny: a kernel never ran: {cg}")


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
    require(all(n > 0 for n in counts.values()),
            f"full: a kernel of the path never ran: {counts}")
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
    phase_tiny()
    counts = phase_full(B, P, gen_len)

    sources = {
        "qmatmul_gathered": ("src/repro_torch/csrc/qmatmul.cu",
                             "src/repro/kernels/qmatmul.py:38"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:26"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:26"),
    }
    table = []
    for name, (src, replaces) in sources.items():
        k = kern[name]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    print(nvidia_smi(), flush=True)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
