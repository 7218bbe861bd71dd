// Causal flash attention for prefill (queries and keys both start at 0).
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel behind `flash_attention`). Same function: q (B, S, Hq, D), k and v
// (B, S, Hkv, D), query head hq reads KV head hq / G, causal mask
// k_pos <= q_pos plus an optional sliding window k_pos > q_pos - window,
// masked scores -1e30 as in the Pallas kernel, output acc / max(l, 1e-20)
// in (B, S, Hq, D) fp32.
//
// What bounds it on an H100: at the main path's prefill (S = 128) the
// whole problem is a few tens of MB and under a GFLOP per layer, so the
// fp32 CUDA-core rate (no tensor cores here yet) and the bytes are both
// within a few microseconds; the kernel is bound by its own instruction
// count, not by the card.
//
// Design: one block per (16-query tile, query head, batch row), four warps
// of four query rows each. K and V tiles of 32 keys go through shared
// memory (K rows padded by one float so that lane j reading key j is free
// of bank conflicts). Lane j scores key j against the warp's query row,
// the warp reduces max and sum by shuffles, and each lane keeps D/32
// output columns of the running (m, l, acc). The S axis and the tile edge
// are ragged: out-of-range keys load as zeros and are masked, out-of-range
// queries are not written. KV tiles past the causal front of the query tile
// (and, with a window, before it) are skipped: with -1e30 masking their
// probabilities are exactly 0 once a row has seen a valid key, so the
// result equals the Pallas kernel's full sweep.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 16;
constexpr int kBKV = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
prefill_attention(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int S,
                  int Hq, int Hkv, float scale, int window) {
  constexpr int P = D / 32;
  __shared__ float Qs[kBQ][D];
  __shared__ float Ks[kBKV][D + 1];
  __shared__ float Vs[kBKV][D];

  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int h = hq / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < kBQ * D; e += kWarps * 32) {
    const int r = e / D, d = e % D;
    const int qp = q0 + r;
    Qs[r][d] = qp < S ? q[(((long long)b * S + qp) * Hq + hq) * D + d] * scale
                      : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][P];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < P; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int t_hi = q_last / kBKV;
  int t_lo = 0;
  if (window > 0) t_lo = max(0, q0 - window + 1) / kBKV;

  for (int t = t_lo; t <= t_hi; ++t) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBKV * D; e += kWarps * 32) {
      const int j = e / D, d = e % D;
      const int kp = t * kBKV + j;
      float kv = 0.f, vv = 0.f;
      if (kp < S) {
        const long long off = (((long long)b * S + kp) * Hkv + h) * D + d;
        kv = k[off];
        vv = v[off];
      }
      Ks[j][d] = kv;
      Vs[j][d] = vv;
    }
    __syncthreads();
    const int kp = t * kBKV + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qp = q0 + r;
      if (qp >= S) continue;                      // uniform across the warp
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[r][d], Ks[lane][d], s);
      bool ok = kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      s = ok ? s : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      const float p = expf(s - mn);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < P; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < kBKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < P; ++c)
          acc[i][c] = fmaf(pj, Vs[j][lane + 32 * c], acc[i][c]);
      }
      m[i] = mn;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qp = q0 + warp * kRowsPerWarp + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* o = out + (((long long)b * S + qp) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < P; ++c) o[lane + 32 * c] = acc[i][c] / den;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int Hq, int Hkv, int D, float scale,
                                   int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  switch (D) {
    case 32:
      prefill_attention<32><<<grid, kWarps * 32, 0, st>>>(q, k, v, out, S, Hq,
                                                          Hkv, scale, window);
      break;
    case 64:
      prefill_attention<64><<<grid, kWarps * 32, 0, st>>>(q, k, v, out, S, Hq,
                                                          Hkv, scale, window);
      break;
    case 128:
      prefill_attention<128><<<grid, kWarps * 32, 0, st>>>(q, k, v, out, S, Hq,
                                                           Hkv, scale, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
