// Flash-decoding attention: one new query token per sequence over its cache.
//
// Replaces: src/repro/kernels/flash_decode.py::_flash_kernel (the Pallas TPU
// kernel behind `flash_decode`). Same inputs and masking: q (B, Hkv, G, D),
// k and v in the cache's own (B, S, Hkv, D) layout, slot_positions (B, S)
// int32 and lengths (B,) int32; a slot takes part when
// 0 <= slot_positions[b, s] <= lengths[b]. Masked scores are -1e30 (not
// -inf), exactly as in the Pallas kernel and its oracle, so a split whose
// slots are all masked combines to the same result. Output (B, Hkv, G, D)
// fp32 = acc / max(l, 1e-20).
//
// What bounds it on an H100: every K and V byte is read once for G query
// heads, about G/2 FLOP per byte, so it is bound by device-memory bytes,
// and at decode sizes (a few MB per layer) by launch latency as much.
//
// Design: the Pallas grid walks S serially on one core; here only B*Hkv
// (b, h) pairs exist (32 on the main path) against 132 SMs, so the S axis
// is split across blocks (gridDim.x). Each block runs four warps over its
// slots; a warp takes one slot at a time, its lanes split D, and it keeps a
// running (m, l, acc) for all G query heads of the KV head in registers.
// The four warps merge in shared memory and each block writes one partial
// (m, l, acc); a second kernel combines the partials of each (b, h) in
// split order. The GQA fold follows common.py: query head g of KV head h is
// q head h*G + g.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ slot_pos,
               const int* __restrict__ lengths, int S, int Hkv, int G,
               int chunk, float scale, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int P = D / 32;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float qr[kMaxG][P], acc[kMaxG][P], m[kMaxG], l[kMaxG];
  const float* qb = q + ((long long)(b * Hkv + h) * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      qr[g][i] = g < G ? qb[g * D + lane + 32 * i] * scale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const int len = lengths[b];
  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  for (int s = s0 + warp; s < s1; s += kWarps) {
    const long long row = ((long long)b * S + s) * Hkv + h;
    float kr[P], vr[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      kr[i] = k[row * D + lane + 32 * i];
      vr[i] = v[row * D + lane + 32 * i];
    }
    const int pos = slot_pos[(long long)b * S + s];
    const bool valid = pos >= 0 && pos <= len;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) dot = fmaf(qr[g][i], kr[i], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float sc = valid ? dot : kNegInf;
      const float mn = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - mn);
      const float p = expf(sc - mn);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < P; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
      m[g] = mn;
    }
  }

  __shared__ float sm[kWarps][kMaxG], sl[kWarps][kMaxG];
  __shared__ float sacc[kWarps][kMaxG][D];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) sacc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();
  const long long base = ((long long)(b * Hkv + h) * nsplit + split) * G;
  for (int e = threadIdx.x; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w][g] - mx);
      lt += sl[w][g] * f;
      at += sacc[w][g][d] * f;
    }
    part_acc[(base + g) * D + d] = at;
    if (d == 0) {
      part_m[base + g] = mx;
      part_l[base + g] = lt;
    }
  }
}

__global__ void decode_combine(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc, int Hkv,
                               int G, int D, int nsplit,
                               float* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * Hkv + h;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mx = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, part_m[(bh * nsplit + s) * G + g]);
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const long long i = (bh * nsplit + s) * G + g;
      const float f = expf(part_m[i] - mx);
      lt += part_l[i] * f;
      at += part_acc[i * D + d] * f;
    }
    out[(bh * G + g) * D + d] = at / fmaxf(lt, 1e-20f);
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). The partial buffers hold
// B*Hkv*nsplit*G floats (m, l) and B*Hkv*nsplit*G*D floats (acc).
extern "C" int flash_decode_fwd(const float* q, const float* k,
                                const float* v, const int* slot_pos,
                                const int* lengths, int B, int S, int Hkv,
                                int G, int D, int nsplit, int chunk,
                                float scale, float* part_m, float* part_l,
                                float* part_acc, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  dim3 grid(nsplit, Hkv, B);
  switch (D) {
    case 32:
      decode_partial<32><<<grid, kWarps * 32, 0, st>>>(
          q, k, v, slot_pos, lengths, S, Hkv, G, chunk, scale, part_m,
          part_l, part_acc);
      break;
    case 64:
      decode_partial<64><<<grid, kWarps * 32, 0, st>>>(
          q, k, v, slot_pos, lengths, S, Hkv, G, chunk, scale, part_m,
          part_l, part_acc);
      break;
    case 128:
      decode_partial<128><<<grid, kWarps * 32, 0, st>>>(
          q, k, v, slot_pos, lengths, S, Hkv, G, chunk, scale, part_m,
          part_l, part_acc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  decode_combine<<<dim3(Hkv, B), 256, 0, st>>>(part_m, part_l, part_acc, Hkv,
                                                G, D, nsplit, out);
  return (int)cudaGetLastError();
}
