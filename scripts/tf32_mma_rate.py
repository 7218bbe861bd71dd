#!/usr/bin/env python3
"""Throughput and latency of one ``mma.sync.m16n8k8`` TF32 instruction on
the current GPU: the ceiling of the port's split-TF32 kernels
(``src/repro_torch/csrc/qmatmul.cu`` kernel B, ``flash_attention.cu``),
which issue it from registers rather than through ``wgmma``.

  python3 scripts/tf32_mma_rate.py      # needs nvcc and one NVIDIA GPU

Builds a small kernel into ``build/kernels/`` with nvcc (sm_90a), then
prints one JSON line: the card's name and power limit (nvidia-smi), the
dense rate with 8 independent accumulators per warp on every SM (TFLOP/s,
2 x 16 x 8 x 8 per instruction), and the cycles from one MMA to the next
when each waits for the previous one (a single warp)."""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(int iters, float* out, long long* cycles) {
  float d[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int q = 0; q < 4; ++q) d[c][q] = 0.f;
  const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
  const uint32_t b0 = a0 * 3, b1 = a0 * 5;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}
extern "C" int run(int chains, int blocks, int threads, int iters, float* out,
                   long long* cycles) {
  if (chains == 8) mma_loop<8><<<blocks, threads>>>(iters, out, cycles);
  else mma_loop<1><<<blocks, threads>>>(iters, out, cycles);
  return (int)cudaGetLastError();
}
"""


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("tf32_mma_rate: needs an NVIDIA GPU")
    out_dir = ROOT / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "tf32_mma_rate.cu", out_dir / "libtf32_mma_rate.so"
    cu.write_text(SRC)
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes = [I, I, I, I, P, P]
    lib.run.restype = I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 256, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    res = {}
    for label, chains, blocks, threads, iters in (
            ("throughput", 8, sms * 8, 256, 4096),
            ("latency", 1, 1, 32, 4096)):
        lib.run(chains, blocks, threads, iters, out.data_ptr(), cyc.data_ptr())
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        err = lib.run(chains, blocks, threads, iters, out.data_ptr(),
                      cyc.data_ptr())
        e.record()
        torch.cuda.synchronize()
        if err:
            sys.exit(f"tf32_mma_rate: CUDA error {err}")
        ms = s.elapsed_time(e)
        mmas = blocks * threads // 32 * chains * iters
        res[label] = {"ms": ms, "mmas": mmas,
                      "tflops": mmas * 2 * 16 * 8 * 8 / ms / 1e9,
                      "cycles_per_mma_per_warp": int(cyc.item()) / (iters * chains)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi, "sms": sms,
                      "tf32_mma_sync_dense_tflops": res["throughput"]["tflops"],
                      "tf32_mma_sync_latency_cycles":
                          res["latency"]["cycles_per_mma_per_warp"],
                      "runs": res}))


if __name__ == "__main__":
    main()
