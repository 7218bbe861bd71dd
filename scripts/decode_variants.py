#!/usr/bin/env python3
"""Where flash decoding's time goes, on one NVIDIA GPU.

  python3 scripts/decode_variants.py [VARIANT ...]   # default: all
  python3 scripts/decode_variants.py --bf16 [VARIANT ...]   # the bf16 form

Builds text variants of ``src/repro_torch/csrc/flash_decode.cu`` (one nvcc
each, in parallel, into ``build/kernels/``), swaps each into
``repro_torch.kernels.flash_decode`` and prints one JSON line per variant:
the device time per call (``torch.profiler``) at chip_smoke.py's four
flash_decode rows (serve decode, a server decode batch, 4 rows of 4 K
slots, one row of 32 K) at the plan's range and ring and at those in
``PLANS``, the error against the plain version, and ptxas's registers.
Variants that drop work give wrong results on purpose: they show what
that work costs. ``timeline`` stamps each block's phases with the global
timer (start, slot mask and busy tiles ready, first tile landed, tile loop
done, partial and counter done, the last block's weights and its
elements) and prints their medians and spread. ``--bf16`` builds the
variants of ``BF16_VARIANTS`` as the bf16 form (the source with
FLASH_DECODE_BF16 defined, as ``flash_decode_bf16.cu`` builds it) and
times them at the bf16 rows ``BF16_ROWS`` (long_500k's 8192-slot ring and
the serve step), each at the ring depths ``BF16_STAGES``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: (range slots, ring stages) timed per row beside the plan's own (0: the
#: plan's; ranges a multiple of 32)
PLANS = {"flash_decode": ((32, 3), (64, 0), (160, 0)),
         "flash_decode_rows": ((32, 3), (64, 0)),
         "flash_decode_long": ((128, 0), (512, 0), (1024, 0), (256, 2),
                               (256, 4)),
         "flash_decode_32k": ((1024, 0), (2048, 2), (2048, 4))}

_TIMER = ("__device__ unsigned long long g_t[8192][8];\n"
          "__device__ __forceinline__ unsigned long long gt() {\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}\n")
_BID = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"


def _stamp(i: int) -> str:
    return f"  if (threadIdx.x == 0) g_t[{_BID}][{i}] = gt();\n"


#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    "fast_exp": [("expf(", "__expf(")],
    # the last block skips the combine: what it costs (wrong result)
    "no_combine": [("  if (tid == 0) p.counts[bh] = 0;      // ready for the next launch\n",
                    "  if (tid == 0) p.counts[bh] = 0;      // ready for the next launch\n"
                    "  return;\n")],
    # every slot's K and V copied, masked or not (the mask still applies)
    "copy_masked": [("                   ok ? (isv ? vb : kb) + off : p.k, ok ? 16 : 0);",
                     "                   (isv ? vb : kb) + off,\n"
                     "                   s0 + t * kTile + slot < p.S ? 16 : 0);")],
    # the tile's math dropped (wrong results): scores all 0, or no P V
    "no_score_math": [("          sc = fmaf(qv.x, kr[i].x, sc);\n"
                       "          sc = fmaf(qv.y, kr[i].y, sc);\n"
                       "          sc = fmaf(qv.z, kr[i].z, sc);\n"
                       "          sc = fmaf(qv.w, kr[i].w, sc);\n", "")],
    "no_pv_math": [("      for (int n = 0; n < SPG; ++n) fma4(acc[g], pg[n], vv[n]);\n", "")],
    "timeline": [
        ("constexpr float kNegInf = -1e30f;\n",
         "constexpr float kNegInf = -1e30f;\n" + _TIMER),
        ("  const int ntiles = (s1 - s0 + kTile - 1) / kTile;\n\n",
         "  const int ntiles = (s1 - s0 + kTile - 1) / kTile;\n"
         "  if (tid == 0) for (int i = 0; i < 8; ++i) g_t[" + _BID + "][i] = 0;\n"
         + _stamp(0)),
        ("  int t_copy = next_busy(0);\n", "  int t_copy = next_busy(0);\n" + _stamp(1)),
        ("    if (j > 0) issue(j + p.stages - 1);     // into tile j - 1's slot\n",
         "    if (j > 0) issue(j + p.stages - 1);     // into tile j - 1's slot\n"
         "    if (j == 0) " + _stamp(2).lstrip()),
        ("  __syncthreads();                     // the ring is free\n",
         "  __syncthreads();                     // the ring is free\n" + _stamp(3)),
        ("  if (tid == 0) last_s = atomic_add_acq_rel(p.counts + bh, 1) == p.ranges - 1;\n"
         "  __syncthreads();\n",
         "  if (tid == 0) last_s = atomic_add_acq_rel(p.counts + bh, 1) == p.ranges - 1;\n"
         "  __syncthreads();\n" + _stamp(4)),
        ("      big_m[g] = mx;\n    }\n  }\n  __syncthreads();\n",
         "      big_m[g] = mx;\n    }\n  }\n  __syncthreads();\n" + _stamp(5)),
        ("        make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n  }\n}\n",
         "        make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n  }\n"
         "  __syncthreads();\n" + _stamp(7) + "}\n"),
        ('extern "C" int flash_decode_fwd(',
         'extern "C" int read_timeline(unsigned long long* h, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, g_t, n * 64);\n}\n\n'
         'extern "C" int flash_decode_fwd(')],
}


#: the bf16 form's variants (flash_decode_mma: each warp its own 16-slot
#: steps, Q K^T and P V as bf16 MMAs)
BF16_VARIANTS = {
    "base": [],
    "fast_exp": VARIANTS["fast_exp"],
    # no K/V byte read: every copy zero-fills (wrong results)
    "no_copies": [("                     ok ? 16 : 0);\n",
                   "                     0);\n")],
    # the MMAs of Q K^T, or of P V, dropped (wrong results)
    "no_s_mma": [("      mma_bf16(s[0], qa, r[0], r[1]);\n"
                  "      mma_bf16(s[1], qa, r[2], r[3]);\n", "")],
    "no_pv_mma": [("        mma_bf16(f0, pa, r[0], r[1]);\n"
                   "        mma_bf16(f1, pa, r[2], r[3]);\n", "")],
    # one block an SM whatever the ring (registers uncapped)
    "min_blocks_1": [("__launch_bounds__(kThreads, SmemB<D>::kMinBlocks)",
                      "__launch_bounds__(kThreads, 1)")],
    # P in one bf16 term (2^-9 of it lost) or two (2^-18)
    "p_terms_1": [("constexpr int kPTerms = 3;", "constexpr int kPTerms = 1;")],
    "p_terms_2": [("constexpr int kPTerms = 3;", "constexpr int kPTerms = 2;")],
    "timeline": [
        ("constexpr float kNegInf = -1e30f;\n",
         "constexpr float kNegInf = -1e30f;\n" + _TIMER),
        ("  const int nsteps = 2 * ntiles;\n",
         "  const int nsteps = 2 * ntiles;\n"
         "  if (tid == 0) for (int i = 0; i < 8; ++i) g_t[" + _BID + "][i] = 0;\n"
         + _stamp(0)),
        ("  bool busy = false;                   // a valid slot in the range\n",
         _stamp(1) + "  bool busy = false;                   // a valid slot in the range\n"),
        ("    __syncwarp();                      // step k landed, for every lane\n",
         "    __syncwarp();                      // step k landed, for every lane\n"
         "    if (k == 0) " + _stamp(2).lstrip()),
        ("  __syncthreads();                     // every warp's ring is free\n",
         "  __syncthreads();                     // every warp's ring is free\n"
         + _stamp(3)),
        ("  if (tid == 0) last_s = atomic_add_acq_rel(p.counts + bh, 1) == p.ranges - 1;\n"
         "  __syncthreads();\n",
         "  if (tid == 0) last_s = atomic_add_acq_rel(p.counts + bh, 1) == p.ranges - 1;\n"
         "  __syncthreads();\n" + _stamp(4)),
        ("      big_m[g] = mx;\n    }\n  }\n  __syncthreads();\n",
         "      big_m[g] = mx;\n    }\n  }\n  __syncthreads();\n" + _stamp(5)),
        ("        make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n  }\n}\n",
         "        make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n  }\n"
         "  __syncthreads();\n" + _stamp(7) + "}\n"),
        ('extern "C" int flash_decode_fwd_bf16(',
         'extern "C" int read_timeline(unsigned long long* h, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, g_t, n * 64);\n}\n\n'
         'extern "C" int flash_decode_fwd_bf16(')],
}
#: the bf16 rows: (B, S, lengths, a wrapped ring)
BF16_ROWS = {"ring_8k": (8192, [8719], True),
             "serve": (145, [128, 133, 138, 143], False)}
#: bf16 ring depths (each warp's) timed per row beside the plan's (0)
BF16_STAGES = (0, 1, 2)


def build(names, bf16=False):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "flash_decode.cu").read_text()
    if bf16:
        src = "#define FLASH_DECODE_BF16\n" + src
    table = BF16_VARIANTS if bf16 else VARIANTS
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in table[name]:
            if old not in text:
                sys.exit(f"decode_variants: {name}: {old!r} not in the source")
            text = text.replace(old, new)
        tag = f"{name}_bf16" if bf16 else name
        cu = kb.BUILD_DIR / f"decode_{tag}.cu"
        cu.write_text(text)
        so = kb.BUILD_DIR / f"libdecode_{tag}.so"
        procs[name] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-I", str(kb.CSRC), "-o", str(so),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"decode_variants: nvcc {name}:\n{log}")
        regs = [int(l.split("Used ")[1].split()[0]) for l in log.splitlines()
                if "registers" in l]
        spills = max([int(l.split(" bytes spill stores")[0].split()[-1])
                      for l in log.splitlines() if "spill stores" in l] or [0])
        out[name] = (ctypes.CDLL(str(so)), regs + [f"spill stores {spills}"])
    return out


def bind(lib, bf16=False):
    """Point the wrapper at a variant's library."""
    from repro_torch.kernels import flash_decode as fd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.flash_decode_fwd_bf16 if bf16 else lib.flash_decode_fwd
    f.argtypes = [P, P, P, P, P, P, P, L, P, L, I, I, I, I, I, I, I, I,
                  ctypes.c_float, ctypes.c_float, P]
    f.restype = I
    fd._fns[bf16] = f


def timeline(lib, fn, nblocks: int) -> dict:
    """Per-block phase times of one call (microseconds, global timer)."""
    import numpy as np
    import torch
    lib.read_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    buf = np.zeros((nblocks, 8), dtype=np.uint64)
    if lib.read_timeline(buf.ctypes.data, nblocks):
        sys.exit("decode_variants: reading the timeline failed")
    b = buf.astype(np.int64)
    t0 = b[:, 0].min()
    us = lambda x: round(float(x) / 1e3, 3)
    med = lambda a, i, j: us(np.median(b[a, j] - b[a, i])) if a.any() else None
    busy = b[:, 2] > 0
    every = np.ones(len(b), dtype=bool)
    last = b[:, 7] > 0
    split = b[:, 4] > 0
    out = {"blocks": int(len(b)), "busy_blocks": int(busy.sum()),
           "start_spread_us": us(b[:, 0].max() - t0),
           "mask_us_median": med(every, 0, 1),
           "first_tile_us_median": med(busy, 1, 2),
           "loop_us_median": med(busy, 2, 3),
           "loop_us_max": us(np.max(b[busy, 3] - b[busy, 2])) if busy.any() else None,
           "partial_us_median": med(split, 3, 4),
           "last_block_end_of_loop_us": us(b[last, 3].max() - t0) if last.any() else None,
           "combine_weights_us_median": med(last, 4, 5),
           "combine_elements_us_median": med(last, 5, 7),
           "end_us": us(b[:, 1:].max() - t0)}
    return out


def main_bf16(names):
    """The bf16 variants at BF16_ROWS: device ms at the plan's ring and at
    BF16_STAGES, the error against the plain version, whether the output
    equals the fp32 form on the widened inputs bit for bit."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    libs = build(names, bf16=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    rows = {name: cs.decode_inputs(randn, dev, S, 8, 5, 128, lengths,
                                   ring=ring)
            for name, (S, lengths, ring) in BF16_ROWS.items()}
    fp32 = {name: fd.flash_decode(*(t.float() for t in x[:3]), *x[3:])
            for name, x in rows.items()}
    want = {name: ref.flash_decode_ref(*x) for name, x in rows.items()}
    print(json.dumps({"nvidia_smi": cs.nvidia_smi()}), flush=True)
    for name in names:
        lib, regs = libs[name]
        bind(lib, bf16=True)
        r = {"variant": name, "registers": regs}
        for row, x in rows.items():
            run = lambda: fd.flash_decode(*x)  # noqa: E731
            got = run()
            r[f"{row}_max_abs_err"] = float((got - want[row]).abs().max())
            r[f"{row}_equals_fp32_form"] = bool(torch.equal(got, fp32[row]))
            S, B = x[1].shape[1], x[1].shape[0]
            for st in BF16_STAGES:
                saved = fd.STAGES_BF16
                fd.STAGES_BF16 = st or saved
                try:
                    plan = fd._plan(S, 8, 5, 128, fd.build.sm_count(dev),
                                    torch.bfloat16)
                    key = f"{row}_range{plan.range_slots}_stages{plan.stages}"
                    r[f"{key}_ms"] = cs.device_profile(run, reps=20).get(
                        "device_ms")
                    if name == "timeline":
                        n = B * 8 * fd.ranges(S, plan.range_slots)
                        r[f"{key}_timeline"] = timeline(lib, run, n)
                finally:
                    fd.STAGES_BF16 = saved
        fd._fns.clear()
        print(json.dumps(r), flush=True)


def main():
    import math
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        sys.exit("decode_variants: needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--bf16"]:
        return main_bf16(sys.argv[2:] or list(BF16_VARIANTS))
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    rows = {name: cs.decode_inputs(randn, dev, S, 8, 5, 128, lengths,
                                   holes=name == "flash_decode")
            for name, (S, lengths) in cs.DECODE_ROWS.items()}
    want = {name: ref.flash_decode_ref(*x) for name, x in rows.items()}
    sms = kb.sm_count(dev)
    print(json.dumps({"nvidia_smi": cs.nvidia_smi()}), flush=True)
    for name in names:
        lib, regs = libs[name]
        bind(lib)
        r = {"variant": name, "registers": regs}
        for row, x in rows.items():
            run = lambda: fd.flash_decode(*x)
            r[f"{row}_max_abs_err"] = float((run() - want[row]).abs().max())
            S, B = x[1].shape[1], x[1].shape[0]
            for rs, st in ((0, 0),) + PLANS[row]:
                with cs.decode_plan(range_slots=rs, stages=st):
                    plan = fd._plan(S, 8, 5, 128, sms)
                    key = f"{row}_range{plan.range_slots}_stages{plan.stages}"
                    r[f"{key}_ms"] = cs.device_profile(run, reps=20).get(
                        "device_ms")
                    if name == "timeline":
                        n = B * 8 * fd.ranges(S, plan.range_slots)
                        r[f"{key}_timeline"] = timeline(lib, run, n)
        fd._fns.clear()
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
