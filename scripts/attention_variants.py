#!/usr/bin/env python3
"""Where the prefill attention kernel's time goes, on one NVIDIA GPU.

  python3 scripts/attention_variants.py [VARIANT ...]   # default: all

Builds text variants of ``src/repro_torch/csrc/flash_attention.cu`` (one
nvcc each, in parallel, into ``build/kernels/``), swaps each into the
wrappers of ``repro_torch.kernels.flash_attention`` and ``.chunk_attention``
and prints one JSON line per variant: the device time per call
(``torch.profiler``) of the whole-prompt form at the serve path's shapes
(q (4, 128, 40, 128)) and at a 2048-token prompt, of the chunk form at the
server's shapes (q (4, 16, 40, 128) at pos0 0/48/96/112 over 256 slots)
with its key split whole and at 32 and 64 slots, and of one chunk at the
end of 2048 slots; the error against the plain version; and ptxas's
registers. Variants that drop work give wrong results on purpose: they
show what that work costs. ``timeline`` stamps each block's phases with
the global timer (start, first tile landed, tile loop done, partial
written, and the combine's three steps) and prints their spread.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

_QK = ["mma_tf32(part[jn], alo, bhi[jn]);", "mma_tf32(part[jn], ahi, blo[jn]);",
       "mma_tf32(part[jn], ahi, bhi[jn]);"]
_PV = ["mma_tf32(part[n], plo[ks], bhi[n]);", "mma_tf32(part[n], phi[ks], blo[n]);",
       "mma_tf32(part[n], phi[ks], bhi[n]);"]
_TIMER = ("__device__ unsigned long long g_t[8192][8];\n"
          "__device__ __forceinline__ unsigned long long gt() {\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}\n")
#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    # one TF32 MMA per product (hi * hi) and no lo split: wrong, ~3 digits
    "one_mma": [(x, ";") for x in _QK[:2] + _PV[:2]],
    # hi truncated to TF32 instead of rounded: one integer op less a split
    "trunc_split": [("hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
                     "hi = __float_as_uint(v) & 0xffffe000u;")],
    # the small terms in their own accumulators: shorter MMA chains
    "sep_acc": [("      float part[4][4];\n#pragma unroll\n      for (int jn",
                 "      float part[4][4], px[4][4];\n#pragma unroll\n      for (int jn"),
                ("c < 4; ++c) part[jn][c] = 0.f;", "c < 4; ++c) part[jn][c] = px[jn][c] = 0.f;"),
                (_QK[0], _QK[0].replace("part", "px")),
                (_QK[1], _QK[1].replace("part", "px")),
                ("s[jn][c] += part[jn][c];", "s[jn][c] += part[jn][c] + px[jn][c];")],
    # at most 204 registers, so that two blocks of 5 warps share an SM
    # (only G = 5 shapes run here: a block of 8 warps would not launch)
    "two_blocks_per_sm": [("__launch_bounds__(kMaxWarps * 32, 1)",
                           "__launch_bounds__(5 * 32, 2)")],
    # the combine's element pass with its loads replaced by zeros, and with
    # every range read from the block's own partial
    "combine_no_loads": [("          x[j][i] = __ldcg(reinterpret_cast<const float4*>(\n"
                          "              src[i] + min(r0 + j, nr - 1) * range_floats));",
                          "          x[j][i] = make_float4(0.f, 0.f, 0.f, 0.f);")],
    "combine_own_partial": [("              src[i] + min(r0 + j, nr - 1) * range_floats));",
                             "              src[i] + (rg - r_lo) * range_floats));")],
    # the combine's element pass run twice, stamped after each: a second
    # pass as slow as the first is the work, a fast one the cold start
    "combine_twice": None,
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "fast_exp": [("expf(", "__expf(")],
    "no_qk_mma": [(x, ";") for x in _QK],
    "no_pv_mma": [(x, ";") for x in _PV],
    "no_mma": [(x, ";") for x in _QK + _PV],
    "timeline": [
        ("constexpr float kNegInf = -1e30f;\n",
         "constexpr float kNegInf = -1e30f;\n" + _TIMER),
        ("  float* Qs = smem;\n",
         "  float* Qs = smem;\n  const int bid = blockIdx.x + gridDim.x * "
         "(blockIdx.y + gridDim.y * blockIdx.z);\n  if (tid == 0) {\n"
         "    g_t[bid][0] = gt();\n    g_t[bid][1] = g_t[bid][2] = "
         "g_t[bid][3] = g_t[bid][4] = g_t[bid][5] = g_t[bid][6] = "
         "g_t[bid][7] = 0;\n  }\n"),
        ("    ls[e] = r < nr ? l : 0.f;\n  }\n  __syncthreads();\n",
         "    ls[e] = r < nr ? l : 0.f;\n  }\n  __syncthreads();\n"
         "  if (tid == 0) g_t[bid][5] = gt();\n"),
        ("    den[row] = fmaxf(lsum, 1e-20f);\n  }\n  __syncthreads();\n",
         "    den[row] = fmaxf(lsum, 1e-20f);\n  }\n  __syncthreads();\n"
         "  if (tid == 0) g_t[bid][6] = gt();\n"),
        ("    __syncthreads();                     // tile i landed; tile i-1 is free\n",
         "    __syncthreads();                     // tile i landed; tile i-1 is free\n"
         "    if (tid == 0 && i == 0) g_t[bid][1] = gt();\n"),
        ("  cp_async_wait<0>();\n\n  const int qr0",
         "  cp_async_wait<0>();\n  __syncthreads();\n  if (tid == 0) g_t[bid][2] = gt();\n"
         "\n  const int qr0"),
        ("  __syncthreads();\n  if (!is_last) return;",
         "  __syncthreads();\n  if (tid == 0) g_t[bid][3] = gt();\n  if (!is_last) return;"),
        ("  if (tid == 0) p.counts[slot] = 0;",
         "  __syncthreads();\n  if (tid == 0) g_t[bid][4] = gt();\n"
         "  if (tid == 0) p.counts[slot] = 0;"),
        ('extern "C" int flash_attention_fwd(',
         'extern "C" int read_timeline(unsigned long long* h, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, g_t, n * 64);\n}\n\n'
         'extern "C" int flash_attention_fwd(')],
}


VARIANTS["combine_twice"] = VARIANTS["timeline"] + [
    ("  for (int e0 = tid; e0 < rows * C4; e0 += kE * blockDim.x) {\n",
     "  for (int pass = 0; pass < 2; ++pass) {\n  if (pass == 1) {\n"
     "    __syncthreads();\n    if (tid == 0) g_t[bid][7] = gt();\n  }\n"
     "  for (int e0 = tid; e0 < rows * C4; e0 += kE * blockDim.x) {\n"),
    ("make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n    }\n  }\n",
     "make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);\n    }\n  }\n  }\n")]


def build(names):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "flash_attention.cu").read_text()
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                sys.exit(f"attention_variants: {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = kb.BUILD_DIR / f"attention_{name}.cu"
        cu.write_text(text)
        so = kb.BUILD_DIR / f"libattention_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"attention_variants: nvcc {name}:\n{log}")
        regs = [int(l.split("Used ")[1].split()[0]) for l in log.splitlines()
                if "registers" in l]
        spills = [int(l.split("bytes spill stores")[0].split(",")[-1])
                  for l in log.splitlines() if "spill stores" in l]
        out[name] = (ctypes.CDLL(str(so)), regs, spills)
    return out


def bind(lib):
    """Point both wrappers at a variant's library."""
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import flash_attention as fa
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    f1, f2 = lib.flash_attention_fwd, lib.flash_attention_chunk_fwd
    f1.argtypes = [P, P, P, P, I, I, I, I, I, F, F, I, I, I, I, P]
    f2.argtypes = [P, P, P, P, P, P, L, P, L, I, I, I, I, I, I, F, F, I, I, I,
                  P]
    f1.restype = f2.restype = I
    fa._fns[False], ca._fns[False] = f1, f2


def timeline(lib, fn, nblocks: int) -> dict:
    """Per-block phase times of one call (microseconds, from the global
    timer): start spread, first tile landed, the tile loop, the partial
    and the combine (split only)."""
    import numpy as np
    import torch
    lib.read_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    buf = np.zeros((nblocks, 8), dtype=np.uint64)
    if lib.read_timeline(buf.ctypes.data, nblocks):
        sys.exit("attention_variants: reading the timeline failed")
    b = buf.astype(np.int64)
    ran = b[:, 1] > 0
    t0 = b[ran, 0].min()
    us = lambda x: float(x) / 1e3
    out = {"blocks_with_keys": int(ran.sum()),
           "start_spread_us": us(b[ran, 0].max() - t0),
           "first_tile_us_median": us(np.median(b[ran, 1] - b[ran, 0])),
           "tile_loop_us_median": us(np.median(b[ran, 2] - b[ran, 1])),
           "tile_loop_us_max": us(np.max(b[ran, 2] - b[ran, 1])),
           "end_us": us(np.maximum.reduce([b[ran, 2], b[ran, 3], b[ran, 4]]).max()
                        - t0)}
    split = ran & (b[:, 3] > 0)
    if split.any():
        last = b[:, 4] > 0
        out.update(partial_us_median=us(np.median(b[split, 3] - b[split, 2])),
                   combine_us_median=us(np.median(b[last, 4] - b[last, 3])),
                   combine_us_max=us(np.max(b[last, 4] - b[last, 3])),
                   combine_ml_us_median=us(np.median(b[last, 5] - b[last, 3])),
                   combine_weights_us_median=us(np.median(b[last, 6] - b[last, 5])),
                   combine_elements_us_median=us(np.median(b[last, 4] - b[last, 6])))
        if (b[last, 7] > 0).all():
            out.update(
                first_pass_us_median=us(np.median(b[last, 7] - b[last, 6])),
                second_pass_us_median=us(np.median(b[last, 4] - b[last, 7])))
    return out


def main():
    import torch
    from chip_smoke import device_profile, nvidia_smi
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    g = torch.Generator(device="cuda").manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q, k, v = rn(4, 128, 40, 128), rn(4, 128, 8, 128), rn(4, 128, 8, 128)
    qc, kc, vc = rn(4, 16, 40, 128), rn(4, 256, 8, 128), rn(4, 256, 8, 128)
    p0 = torch.tensor([0, 48, 96, 112], dtype=torch.int32, device="cuda")
    ql, kl, vl = rn(1, 2048, 40, 128), rn(1, 2048, 8, 128), rn(1, 2048, 8, 128)
    qx, kx, vx = rn(1, 16, 40, 128), rn(1, 2048, 8, 128), rn(1, 2048, 8, 128)
    px = torch.tensor([2032], dtype=torch.int32, device="cuda")
    want = ref.flash_attention_ref(q, k, v)
    wantc = ref.chunk_attention_ref(qc, kc, vc, p0)
    dev = lambda fn, reps=20: device_profile(fn, reps=reps).get("device_ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    saved = ca.SPLIT_SLOTS
    print(json.dumps({"nvidia_smi": nvidia_smi()}), flush=True)
    for name in names:
        lib, regs, spills = libs[name]
        bind(lib)
        r = {"variant": name, "registers": regs, "spill_store_bytes": spills,
             "whole_max_abs_err": float((fa.flash_attention(q, k, v) - want)
                                        .abs().max()),
             "chunk_max_abs_err": float((ca.chunk_attention(qc, kc, vc, p0)
                                         - wantc).abs().max()),
             "whole_ms": dev(lambda: fa.flash_attention(q, k, v))}
        for slots in (0, 32, 64):
            ca.SPLIT_SLOTS = slots
            r[f"chunk_split{slots}_ms"] = dev(
                lambda: ca.chunk_attention(qc, kc, vc, p0))
            if name in ("timeline", "combine_twice"):
                r[f"chunk_split{slots}_timeline"] = timeline(
                    lib, lambda: ca.chunk_attention(qc, kc, vc, p0),
                    4 * 8 * (256 // slots if slots else 1))
        ca.SPLIT_SLOTS = saved
        r["whole_S2048_ms"] = dev(lambda: fa.flash_attention(ql, kl, vl), 3)
        r["chunk_at_2032_ms"] = dev(lambda: ca.chunk_attention(qx, kx, vx, px))
        if name in ("timeline", "combine_twice"):
            for label, (x, y, z) in (("whole", (q, k, v)),
                                     ("whole_S2048", (ql, kl, vl))):
                plan = fa._plan(x.shape[1], 40, 8, 128, sms)
                tiles = x.shape[1] // 16
                blocks = ((tiles + 1) // 2 if plan.pair else tiles) * 8 * x.shape[0]
                r[f"{label}_timeline"] = timeline(
                    lib, lambda: fa.flash_attention(x, y, z), blocks)
        fa._fns.clear()
        ca._fns.clear()
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
