#!/usr/bin/env python3
"""What the card gives the ATU copy's access pattern: rows of 32 bytes, a
row stride apart, gathered from a bank and scattered into a unit.

At the ATU row's shape (an fp32 bank (5120, 13824), a unit (5120, 4152),
104 groups of bg = 8 columns, the groups' bases drawn from a seed) it times
on the card, each with ``torch.profiler``'s kernel time a call:

- ``port``: the port's ``atu_update`` kernel (``csrc/atu_update.cu``), and
  ``port_<variant>`` text variants of its source (``PORT_VARIANTS``: the
  words a thread moves, the cache hints);
- ``strided``: a plain 32-byte strided copy of the same bytes, one 16-byte
  half-row a thread, the group bases read from two int arrays, no checks:
  the rate the card serves such sectors at; ``strided_rowmajor`` the same
  with a row's groups (not a group's rows) on neighbouring threads;
  ``gather``/``scatter`` (and their ``_rowmajor`` forms) read the rows and
  write a contiguous buffer, or read a contiguous buffer and write the
  rows, as many bytes each: which side holds the copy back;
- ``tma``: the same copy by the Tensor Memory Accelerator, 2-D tensor maps
  over bank and unit, boxes of 8 columns by 256 rows through a ring of 4
  shared-memory stages, bulk stores out (one thread a block issues all);
- ``contiguous``: a copy of as many bytes from one contiguous buffer to
  another (``Tensor.copy_``): the card's streaming rate;
- ``library``: ``index_select`` then ``index_copy_``, the function in two
  PyTorch calls;

and the port's kernel and its variants from an int8 bank into an int8 and
an fp32 unit at the same shape. ``--parent-src FILE`` builds another
``atu_update.cu`` with the same C interface (a parent commit's) and times it beside the
port's at every kind (``parent``).

Each is timed warm (the calls back to back: the 33 MB the copy touches
fits in the 50 MB L2) and cold (a 256 MB write before each call; the
write's kernel left out of the sum). Every copy is checked equal to the
plain version first.

  PYTHONPATH=src python3 scripts/atu_copy_probe.py [--out FILE]

Needs nvcc and one NVIDIA GPU. Builds into ``build/probe/``; prints one
JSON line (the card's name and power limit from nvidia-smi, then per case
ms, GB/s and the share of the bound) and writes it to ``--out`` if given."""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = r"""
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// one 16-byte half of a 32-byte row a thread; sb, db: each group's first
// column (a multiple of 8) in bank and unit. ROW_MAJOR: the groups of one
// row are neighbours (else a group's rows are); GATHER: read from the
// bank's rows (else from the contiguous `flat_in`); SCATTER: write to the
// unit's rows (else to the contiguous `flat_out`)
template <bool ROW_MAJOR, bool GATHER, bool SCATTER>
__global__ void pattern_kernel(const uint4* __restrict__ bank,
                               uint4* __restrict__ unit,
                               const uint4* __restrict__ flat_in,
                               uint4* __restrict__ flat_out,
                               const int* __restrict__ sb,
                               const int* __restrict__ db, int d,
                               long long f4, long long k4, int groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= 2LL * d * groups) return;
  const int h = (int)(i & 1);
  long long r;
  int g;
  if (ROW_MAJOR) {
    r = (i >> 1) / groups;
    g = (int)((i >> 1) - r * groups);
  } else {
    g = (int)((i >> 1) / d);
    r = (i >> 1) - (long long)g * d;
  }
  const uint4 v = GATHER ? bank[r * f4 + sb[g] / 4 + h] : flat_in[i];
  if (SCATTER)
    unit[r * k4 + db[g] / 4 + h] = v;
  else
    flat_out[i] = v;
}

constexpr int kBoxRows = 256, kStages = 4, kBoxBytes = kBoxRows * 8 * 4;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// blockIdx.y: the group; blockIdx.x: a run of `tiles` boxes of 256 rows
__global__ void __launch_bounds__(32)
tma_kernel(const __grid_constant__ CUtensorMap bank_map,
           const __grid_constant__ CUtensorMap unit_map,
           const int* __restrict__ sb, const int* __restrict__ db, int d,
           int tiles) {
  __shared__ alignas(128) float buf[kStages][kBoxRows * 8];
  __shared__ alignas(8) uint64_t full[kStages];
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * tiles;
  const int n = min(tiles, (d + kBoxRows - 1) / kBoxRows - t0);
  if (threadIdx.x != 0 || n <= 0) return;
  const int sc = sb[g], dc = db[g];
  const uint64_t bmap = reinterpret_cast<uint64_t>(&bank_map);
  const uint64_t umap = reinterpret_cast<uint64_t>(&unit_map);
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  auto load = [&](int t) {
    const int s = t % kStages;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem(&full[s])), "r"(kBoxBytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem(buf[s])), "l"(bmap), "r"(smem(&full[s])), "r"(sc),
           "r"((t0 + t) * kBoxRows)
        : "memory");
  };
  for (int t = 0; t < kStages - 1 && t < n; ++t) load(t);
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem(&full[s])), "r"(parity) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%2, %3}], [%1];\n"
        :: "l"(umap), "r"(smem(buf[s])), "r"(dc), "r"((t0 + t) * kBoxRows)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    if (t + kStages - 1 < n) {
      // the stage the next load takes held the previous store's box
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(t + kStages - 1);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static int encode(CUtensorMap* map, void* base, int rows, int cols) {
  void* fn = nullptr;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault, nullptr) != 0)
    return -1;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, nullptr) != 0)
    return -1;
#endif
  if (!fn) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {8, kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  return (int)((EncodeTiled)fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

static CUtensorMap g_bank, g_unit;

extern "C" int tma_prepare(void* bank, void* unit, int d, int f, int k) {
  if (encode(&g_bank, bank, d, f)) return -1;
  if (encode(&g_unit, unit, d, k)) return -2;
  return 0;
}

extern "C" int tma_copy(const int* sb, const int* db, int d, int groups,
                        int tiles, void* stream) {
  dim3 grid(((d + kBoxRows - 1) / kBoxRows + tiles - 1) / tiles, groups);
  tma_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(g_bank, g_unit, sb, db, d,
                                                    tiles);
  return (int)cudaGetLastError();
}

extern "C" int pattern_copy(int variant, const void* bank, void* unit,
                            const void* flat_in, void* flat_out,
                            const int* sb, const int* db, int d, int f, int k,
                            int groups, void* stream) {
  const long long n = 2LL * d * groups;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
#define PATTERN(R, G, S)                                                  \
  pattern_kernel<R, G, S><<<blocks, 256, 0, st>>>(                        \
      (const uint4*)bank, (uint4*)unit, (const uint4*)flat_in,            \
      (uint4*)flat_out, sb, db, d, f / 4, k / 4, groups)
  switch (variant) {
    case 0: PATTERN(false, true, true); break;
    case 1: PATTERN(true, true, true); break;
    case 2: PATTERN(false, true, false); break;
    case 3: PATTERN(false, false, true); break;
    case 4: PATTERN(true, true, false); break;
    case 5: PATTERN(true, false, true); break;
    default: return -1;
  }
#undef PATTERN
  return (int)cudaGetLastError();
}
"""

D, F, K, BG, GROUPS = 5120, 13824, 4152, 8, 104
#: boxes of 256 rows a TMA block takes (5 blocks a group at d = 5120)
TMA_TILES = 4
#: the plain 16-byte-a-thread copies, in ``pattern_copy``'s order: both
#: sides strided, a group's rows neighbours or a row's groups; then one
#: side strided and the other contiguous
PATTERNS = ("strided", "strided_rowmajor", "gather", "scatter",
            "gather_rowmajor", "scatter_rowmajor")


def build() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "atu_probe.cu", out_dir / "libatu_probe.so"
    src.write_text(SRC)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.tma_prepare.argtypes = [P, P, I, I, I]
    so.tma_copy.argtypes = [P, P, I, I, I, P]
    so.pattern_copy.argtypes = [I, P, P, P, P, P, P, I, I, I, I, P]
    for fn in (so.tma_prepare, so.tma_copy, so.pattern_copy):
        fn.restype = I
    return so


#: text variants of the port's kernel source (``csrc/atu_update.cu``), each
#: built beside it: the words a thread moves, and loads and stores with the
#: streaming hint
_ITEMS = "kItems = 8"
_STORE = ("unit[(i >> row_shift) * (k / C) + dbase + (i & row_mask)] =\n"
          "          convert<S, D, C>(v[u]);")
_LDCS = ("v[u] = __ldg(bank", "v[u] = __ldcs(bank")
_STCS = (_STORE, "__stcs(unit + (i >> row_shift) * (k / C) + dbase + "
                 "(i & row_mask),\n             convert<S, D, C>(v[u]));")
PORT_VARIANTS = {"items4": [(_ITEMS, "kItems = 4")],
                 "items16": [(_ITEMS, "kItems = 16")],
                 "ldcs": [_LDCS], "stcs": [_STCS], "hints": [_LDCS, _STCS]}


def build_sources(texts: dict) -> dict:
    """name -> the ``atu_update`` C function (ctypes) of each source text,
    built in parallel into ``build/probe/``."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    out_dir = ROOT / "build" / "probe"
    jobs = {}
    for name, text in texts.items():
        src = out_dir / f"atu_update_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libatu_update_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    fns = {}
    for name, (lib, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {name}")
        fn = ctypes.CDLL(str(lib)).atu_update
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        fns[name] = fn
    return fns


def variant_texts(parent_src: str = "") -> dict:
    """The port's source with each of PORT_VARIANTS' substitutions, and
    ``parent`` read from ``parent_src`` where one is given."""
    from repro_torch.kernels.build import CSRC
    text = (CSRC / "atu_update.cu").read_text()
    texts = {}
    for name, subs in PORT_VARIANTS.items():
        variant = text
        for old, new in subs:
            assert old in variant, old
            variant = variant.replace(old, new)
        texts[f"port_{name}"] = variant
    if parent_src:
        texts["parent"] = Path(parent_src).read_text()
    return texts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--parent-src", default="",
                    help="another atu_update.cu (e.g. a parent commit's) to "
                         "time beside the port's, with the same C interface")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.atu_update import atu_update
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    so = build()
    g = torch.Generator(device=dev).manual_seed(4321)
    bank = torch.randn(D, F, generator=g, device=dev)
    unit = torch.randn(D, K, generator=g, device=dev)
    sb = (torch.randperm(F // BG, generator=g, device=dev)[:GROUPS] * BG).int()
    db = (torch.randperm(K // BG, generator=g, device=dev)[:GROUPS] * BG).int()
    ar = torch.arange(BG, device=dev, dtype=torch.int32)
    src = (sb[:, None] + ar).reshape(-1).contiguous()
    dst = (db[:, None] + ar).reshape(-1).contiguous()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    want = ref.atu_update_ref(bank, unit.clone(), src.cpu(), dst.cpu(), bg=BG)
    work = unit.clone()
    cs.require(so.tma_prepare(bank.data_ptr(), work.data_ptr(), D, F, K) == 0,
               "cuTensorMapEncodeTiled failed")
    src_l, dst_l = src.long(), dst.long()
    flat_in = torch.randn(GROUPS * BG * D, generator=g, device=dev)
    flat_out = torch.empty_like(flat_in)

    def check(err):
        cs.require(err == 0, f"launch failed: CUDA error {err}")

    def pattern(variant):
        return lambda: check(so.pattern_copy(
            variant, bank.data_ptr(), work.data_ptr(), flat_in.data_ptr(),
            flat_out.data_ptr(), sb.data_ptr(), db.data_ptr(), D, F, K,
            GROUPS, stream()))
    variants = build_sources(variant_texts(args.parent_src))

    def variant(fn, b, u, kind):
        return lambda: check(fn(
            b.data_ptr(), u.data_ptr(), src.data_ptr(), dst.data_ptr(),
            D, F, K, GROUPS * BG, BG, kind, stream()))
    cases = {
        "port": lambda: atu_update(bank, work, src, dst, bg=BG),
        **{name: variant(fn, bank, work, 4) for name, fn in variants.items()},
        **{name: pattern(v) for v, name in enumerate(PATTERNS)},
        "tma": lambda: check(so.tma_copy(sb.data_ptr(), db.data_ptr(), D,
                                         GROUPS, TMA_TILES, stream())),
        "contiguous": lambda: flat_out.copy_(flat_in),
        "library": lambda: work.index_copy_(1, dst_l,
                                            bank.index_select(1, src_l)),
    }
    for name in ("port", *variants, "strided", "strided_rowmajor", "tma",
                 "library"):
        work.copy_(unit)
        cases[name]()
        torch.cuda.synchronize()
        cs.require(torch.equal(work, want), f"{name}: differs from the plain "
                   "version")
    nbytes = 2 * GROUPS * BG * D * 4
    bound_ms = cs.bound(nbytes + 2 * GROUPS * BG * 4, 0.0)[0]
    flush_buf = torch.empty(256 * 2 ** 20 // 4, device=dev)
    flush = lambda: flush_buf.zero_()
    flush_prof = cs.device_profile(flush, reps=20)
    flush_ms = flush_prof["device_ms"]
    flush_kernels = set(flush_prof.get("top_kernels_ms", {}))
    out = {"device": cs.nvidia_smi(), "torch": torch.__version__,
           "shape": {"d": D, "f": F, "k": K, "bg": BG, "groups": GROUPS},
           "bytes": nbytes, "bound_ms": bound_ms, "flush_ms": flush_ms,
           "cases": {}}
    def timed(fn, nbytes, bound_ms):
        warm = cs.device_profile(fn, reps=20)
        cold = cs.device_profile(lambda: (flush(), fn()), reps=20)
        row = {"warm_ms": warm["device_ms"], "cold_ms": None,
               "kernels": warm.get("top_kernels_ms")}
        if isinstance(cold["device_ms"], float):
            row["cold_ms"] = sum(ms for name, ms in
                                 cold["top_kernels_ms"].items()
                                 if name not in flush_kernels)
        for key in ("warm_ms", "cold_ms"):
            ms = row[key]
            if isinstance(ms, float) and ms > 0:
                row[key.replace("ms", "GBps")] = nbytes / ms / 1e6
                row[key.replace("ms", "of_bound")] = bound_ms / ms
        return row
    for name, fn in cases.items():
        out["cases"][name] = timed(fn, nbytes, bound_ms)

    # the int8 bank into an int8 and an fp32 unit: the port's kernel, its
    # variants (and the other source, if given) at the same shape
    i8 = torch.randint(-128, 128, (D, F), generator=g, device=dev,
                       dtype=torch.int8)
    out["kinds"] = {}
    for kind, unit_t in ((1, torch.int8), (5, torch.float32)):
        u0 = (torch.randn(D, K, generator=g, device=dev) if kind == 5 else
              torch.randint(-128, 128, (D, K), generator=g, device=dev,
                            dtype=torch.int8))
        u = u0.clone()
        want = ref.atu_update_ref(i8, u0.clone(), src.cpu(), dst.cpu(), bg=BG)
        fns = {"port": lambda: atu_update(i8, u, src, dst, bg=BG),
               **{name: variant(fn, i8, u, kind)
                  for name, fn in variants.items()}}
        nb = GROUPS * BG * D * (1 + u.element_size())
        b_ms = cs.bound(nb + 2 * GROUPS * BG * 4, 0.0)[0]
        rows = {"bound_ms": b_ms}
        for name, fn in fns.items():
            u.copy_(u0)
            fn()
            torch.cuda.synchronize()
            cs.require(torch.equal(u, want), f"{name}, int8 -> {unit_t}: "
                       "differs from the plain version")
            rows[name] = timed(fn, nb, b_ms)
        out["kinds"][f"int8->{str(unit_t).split('.')[-1]}"] = rows
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
