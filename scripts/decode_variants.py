#!/usr/bin/env python3
"""Where flash decoding's time goes, on one NVIDIA GPU.

  python3 scripts/decode_variants.py [VARIANT ...]   # default: all

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
elements) and prints their medians and spread.
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


def build(names):
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "flash_decode.cu").read_text()
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                sys.exit(f"decode_variants: {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = kb.BUILD_DIR / f"decode_{name}.cu"
        cu.write_text(text)
        so = kb.BUILD_DIR / f"libdecode_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"decode_variants: nvcc {name}:\n{log}")
        regs = [int(l.split("Used ")[1].split()[0]) for l in log.splitlines()
                if "registers" in l]
        out[name] = (ctypes.CDLL(str(so)), regs)
    return out


def bind(lib):
    """Point the wrapper at a variant's library."""
    from repro_torch.kernels import flash_decode as fd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = lib.flash_decode_fwd
    f.argtypes = [P, P, P, P, P, P, P, L, P, L, I, I, I, I, I, I, I,
                  ctypes.c_float, ctypes.c_float, P]
    f.restype = I
    fd._fns[False] = f


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


def main():
    import math
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        sys.exit("decode_variants: needs an NVIDIA GPU")
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
