#!/usr/bin/env python3
"""Where the bf16 tensor-core kernels' time goes, on one NVIDIA GPU.

  python3 scripts/bf16_variants.py [VARIANT ...]   # default: all

Builds text variants of ``src/repro_torch/csrc/qmatmul_bf16.cu`` (kernel B,
``qmm:`` variants; the small-M FFN's fused GLU, ``glu:`` variants) and
``flash_attention_bf16.cu`` (``attn:`` variants),
one nvcc each, in parallel, into ``build/variants/``, swaps each into its
wrapper (``repro_torch.kernels.qmatmul``, ``.flash_attention``,
``.chunk_attention``) and prints one JSON line per variant: device time per
call (``torch.profiler``) at the main paths' shapes and the largest error
against the plain version, as a share of the kernel tests' tolerance
(1e-5 x max(1, max|plain|); the attention forms' bf16 outputs half a bf16
unit more). Kernel B: one layer's FFN of qwen2.5-14b (d 5120, tiers
1037/1037/2073 of 13824, 9 calls) at x (512, 5120) and at R = 4 rows of a
16-token chunk, each call's kernel time by name, and the error of the int8
tier's row form (h times the scales, split into bf16 terms). Attention: the
whole prompt at q (4, 128, 40, 128) and (1, 2048, 40, 128), the chunk at q
(4, 16, 40, 128) over 256 slots. Variants that drop work give wrong results
on purpose: they show what that work costs. The fp32 form of the FFN is
profiled too (``fp32_form``), kernel by kernel: its int tiers' row form
issues two TF32 MMAs per 8 deep, the alternative to the bf16 terms. The
fused GLU: one layer's FFN at x (1, 5120) (the m2 long_500k step's M = 1)
and R = 4 rows of M = 1, each kernel's time by name, and the error of the
FFN's output against the base build's, as a share of the tolerance.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: the P V products' MMA in flash_attention_bf16.cu (one line, every term)
_PV = "for (int n = 0; n < 4; ++n) mma_bf16(part[n], a, b0[n], b1[n]);"
#: name -> (source, [(text in the source, its replacement)])
VARIANTS = {
    "qmm:base": ("qmatmul_bf16", []),
    # no MMAs (and so no fragments): the tile pipeline alone
    "qmm:no_mma": ("qmatmul_bf16", [
        ("mma_bf16(part[i][jn], a[i], b[jn][0], b[jn][1]);", ";"),
        ("mma_bf16(part[i][jn], ae, b[jn][0], b[jn][1]);", ";")]),
    # no copies: the fragments and MMAs over whatever the ring holds
    "qmm:no_load": ("qmatmul_bf16", [
        ("// values e and e + 1 of a bf16 row",
         "__device__ __forceinline__ void no_copy(void*, const void*, int) {}\n"
         "// values e and e + 1 of a bf16 row"),
        ("      cp_async16(As + (tid / kAU", "      no_copy(As + (tid / kAU"),
        ("      cp_async16(As + tid * kALdB", "      no_copy(As + tid * kALdB"),
        ("          cp_async16(Bs + nn * RB + bu", "          no_copy(Bs + nn * RB + bu"),
        ("          cp_async16(Bs + kk * RB + bu", "          no_copy(Bs + kk * RB + bu")]),
    # a 4-deep ring (two blocks an SM where three fit with 3 stages)
    "qmm:stages4": ("qmatmul_bf16", [("constexpr int kStagesB = 3;",
                                      "constexpr int kStagesB = 4;")]),
    # registers for two blocks an SM (255 a thread), not three (168)
    "qmm:two_blocks": ("qmatmul_bf16", [
        ("__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)",
         "__global__ void __launch_bounds__(kMmaThreads, 2)")]),
    # k tiles of 128 (8 MMAs in fresh registers, two blocks an SM)
    "qmm:bk128": ("qmatmul_bf16", [
        ("constexpr int kBKB = 64;", "constexpr int kBKB = 128;"),
        ("constexpr int kALdB = 88;", "constexpr int kALdB = 152;"),
        ("__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)",
         "__global__ void __launch_bounds__(kMmaThreads, 2)")]),
    # the int tiers' row form in two bf16 terms (hi + mid)
    "qmm:two_terms": ("qmatmul_bf16", [("constexpr int kRowTerms = 3;",
                                        "constexpr int kRowTerms = 2;")]),
    "glu:base": ("qmatmul_bf16", []),
    # 1, 2, 3 or 4 units of each row in flight a lane (the base: 2)
    **{f"glu:unroll{n}": ("qmatmul_bf16", [(
        "constexpr int kGluUnroll = 2;", f"constexpr int kGluUnroll = {n};")])
       for n in (1, 3, 4)},
    # the int values' conversion dropped (wrong results): the word's bits
    "glu:no_convert": ("qmatmul_bf16", [
        ("  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - bias;",
         "  return __uint_as_float(u + i);")]),
    # no weight byte read (wrong results): every unit zero
    "glu:no_weights": ("qmatmul_bf16", [
        ("                ? __ldg(reinterpret_cast<const uint4*>(wr[j]) + u0 + uu)",
         "                ? make_uint4(uu, u0, 0u, 0u)")]),
    "attn:base": ("flash_attention_bf16", []),
    # P V in three bf16 terms (hi + mid + lo: fp32's 24 bits), and in one
    # (hi: wrong past ~2^-9 of each weight)
    "attn:three_terms": ("flash_attention_bf16", [
        ("constexpr int kPTerms = 2;", "constexpr int kPTerms = 3;")]),
    "attn:one_term": ("flash_attention_bf16", [
        ("constexpr int kPTerms = 2;", "constexpr int kPTerms = 1;")]),
    # no P V at all: what S, the softmax and the tile pipeline cost
    "attn:no_pv": ("flash_attention_bf16", [(_PV, "")]),
    # a 2-deep ring
    "attn:stages2": ("flash_attention_bf16", [
        ("constexpr int kStagesBf16 = 3;", "constexpr int kStagesBf16 = 2;")]),
}


def build(names):
    from repro_torch.kernels import build as kb
    out_dir = kb.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, edits = VARIANTS[name]
        text = (kb.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                sys.exit(f"bf16_variants: {name}: {old!r} not in the source")
            text = text.replace(old, new)
        stem = name.replace(":", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{stem}.so"
        procs[name] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"bf16_variants: nvcc {name}:\n{log}")
        spills = [int(l.split("bytes spill stores")[0].split(",")[-1])
                  for l in log.splitlines() if "spill stores" in l]
        libs[name] = (ctypes.CDLL(str(so)), max(spills or [0]))
    return libs


def bind(name, lib):
    """Point the bf16 wrappers of the variant's source at its library."""
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qmatmul as qm
    if name.startswith("qmm:"):
        fn = lib.qmm_gathered_bf16
        fn.argtypes = qm._kernel(True).argtypes
        fn.restype = ctypes.c_int
        qm._fns[True] = fn
        return
    if name.startswith("glu:"):
        fns = []
        for sym, base in zip(("qmm_glu_bf16", "qmm_down_parts_bf16",
                              "qmm_down_sum_bf16"), qm._ffn_kernels()):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = base.argtypes, ctypes.c_int
            fns.append(fn)
        qm._fns["ffn"] = tuple(fns)
        return
    for mod, sym in ((fa, "flash_attention_fwd_bf16"),
                     (ca, "flash_attention_chunk_fwd_bf16")):
        fn = getattr(lib, sym)
        fn.argtypes = mod._kernel(True).argtypes
        fn.restype = ctypes.c_int
        mod._fns[True] = fn


def main():
    import torch
    from chip_smoke import device_profile, nvidia_smi
    from repro_torch.configs.base import get_config
    from repro_torch.core.mp_ffn import tier_sizes
    from repro_torch.core.quantize import build_neuron_banks, to_neuron_major
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import qmatmul as qm
    if not torch.cuda.is_available():
        sys.exit("bf16_variants: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(27)
    cfg = get_config("qwen2.5-14b")
    d, f = cfg.d_model, cfg.d_ff
    banks = to_neuron_major(build_neuron_banks(
        *(torch.randn(s, generator=g, device="cuda").mul_(s[0] ** -0.5).to(bf)
          for s in ((d, f), (d, f), (f, d)))))
    sizes = tier_sizes(f, cfg)
    k16, k8, k = sizes["fp16"], sizes["int8"], sizes["k"]

    def sets(R):
        return torch.stack([torch.randperm(f, generator=g, device="cuda")[:k]
                            for _ in range(R)]).to(torch.int32)
    x512, idx512 = torch.randn(512, d, generator=g, device="cuda").to(bf), \
        sets(1)[0]
    xrows, idxrows = torch.randn(4, 16, d, generator=g, device="cuda").to(bf), \
        sets(4)
    h8 = torch.randn(512, k8, generator=g, device="cuda").to(bf)
    i8 = idx512[k16:k16 + k8].contiguous()
    want8 = ref.qmm_gathered_ref(h8, banks["wd_i8"], banks["wd_i8_s"], i8,
                                 precision="int8", layout="row")
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(bf)  # noqa: E731
    q, kk, vv = rn(4, 128, 40, 128), rn(4, 128, 8, 128), rn(4, 128, 8, 128)
    ql, kl, vl = rn(1, 2048, 40, 128), rn(1, 2048, 8, 128), rn(1, 2048, 8, 128)
    qc, kc, vc = rn(4, 16, 40, 128), rn(4, 256, 8, 128), rn(4, 256, 8, 128)
    p0 = torch.tensor([0, 48, 96, 112], dtype=torch.int32, device="cuda")
    want = ref.flash_attention_ref(q.float(), kk.float(), vv.float())
    wantc = ref.chunk_attention_ref(qc.float(), kc.float(), vc.float(), p0)

    def share(got, want, rounded=False):
        """The largest error as a share of the tests' tolerance."""
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        err = (got.float() - want).abs()
        if rounded:
            err = err - want.abs() * 2.0 ** -8
        return float(err.max()) / tol

    def kernels(fn, reps=10):
        p = device_profile(fn, reps=reps)
        return p.get("device_ms"), {n[:60]: v for n, v in
                                    p.get("top_kernels_ms", {}).items()}
    print(json.dumps({"nvidia_smi": nvidia_smi()}), flush=True)
    x1, xr1 = rn(1, 1, d), rn(4, 1, d)
    glu_ffn = {"m1": lambda: ops.mp_ffn(x1, banks, idx512, sizes,
                                        cfg.ffn_act),
               "rows_m1": lambda: ops.mp_ffn(xr1, banks, idxrows, sizes,
                                             cfg.ffn_act)}
    glu_want = {label: fn().float() for label, fn in glu_ffn.items()}
    ffn = {"m512": lambda: ops.mp_ffn(x512[None], banks, idx512, sizes,
                                      cfg.ffn_act),
           "rows": lambda: ops.mp_ffn(xrows, banks, idxrows, sizes,
                                      cfg.ffn_act)}
    fp32_banks = {n: (t.float() if t.dtype == bf else t)
                  for n, t in banks.items()}
    xf = x512.float()[None]
    ms, top = kernels(lambda: ops.mp_ffn(xf, fp32_banks, idx512, sizes,
                                         cfg.ffn_act))
    print(json.dumps({"variant": "fp32_form", "m512_ms": ms,
                      "m512_kernels_ms": top}), flush=True)
    del fp32_banks, xf
    for name in names:
        lib, spills = libs[name]
        bind(name, lib)
        r = {"variant": name, "spill_store_bytes": spills}
        if name.startswith("qmm:"):
            saved = qm.GEMV_MAX_M
            qm.GEMV_MAX_M = 0
            r["row_int8_error_share"] = share(qm.qmatmul_gathered(
                h8, banks["wd_i8"], banks["wd_i8_s"], i8, precision="int8",
                layout="row"), want8)
            qm.GEMV_MAX_M = saved
            for label, fn in ffn.items():
                r[f"{label}_ms"], r[f"{label}_kernels_ms"] = kernels(fn)
            qm._fns.pop(True)
        elif name.startswith("glu:"):
            for label, fn in glu_ffn.items():
                r[f"{label}_error_share"] = share(fn(), glu_want[label])
                r[f"{label}_ms"], r[f"{label}_kernels_ms"] = kernels(fn)
            qm._fns.pop("ffn")
        else:
            r.update(
                whole_error_share=share(fa.flash_attention(q, kk, vv), want,
                                        True),
                chunk_error_share=share(ca.chunk_attention(qc, kc, vc, p0),
                                        wantc, True),
                whole_ms=kernels(lambda: fa.flash_attention(q, kk, vv))[0],
                whole_S2048_ms=kernels(
                    lambda: fa.flash_attention(ql, kl, vl), 3)[0],
                chunk_ms=kernels(lambda: ca.chunk_attention(qc, kc, vc,
                                                            p0))[0])
            fa._fns.pop(True)
            ca._fns.pop(True)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
