// What the two prefill attention sources share: flash_attention.cu (fp32)
// and flash_attention_bf16.cu (bf16) take the same Params, the same plan
// (heads per block, 16-row sub-tiles, pairing, key ranges) and the same
// epilogue: a tile's normalised output, or with a key split its range's
// partial and, in the last range to finish, the ordered combine. The
// accumulator of a warp's 16 query rows is the m16n8 MMA's: acc[n][0..1]
// row g, columns 8n + 2t and + 1; acc[n][2..3] the same of row g + 8.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBKV = 32;          // keys per tile: one 32-deep slice of P V
constexpr int kMaxWarps = 8;      // warps per block: (head, sub-tile) pairs
constexpr int kMaxRanges = 32;    // key ranges of a split: their (m, l) fit
                                  // the shared memory freed for the combine
constexpr float kNegInf = -1e30f;

// dynamic shared memory a block may use (the card's 232,448 bytes less
// this kernel's static flag, with room to spare)
constexpr int kMaxSmem = 232448 - 1024;

struct Params {
  const void* q;         // fp32 or bf16 (the kernel's T), as are k, v, out
  const void* k;
  const void* v;
  const int* pos0;       // nullptr: every row starts at 0
  void* out;
  float* parts;          // split: (slots, ranges, rows, D + 2) partials
  int* counts;           // split: one counter per slot, 0 between launches
  int S, Skv, Hq, Hkv, G;
  int hb, qsub;          // heads per block, 16-row sub-tiles per head
  int groups, q_tiles;   // head groups per KV head, query tiles per row
  int split, ranges;     // key slots per range (0: one range), ranges
  int pair;              // no split: a block takes two query tiles
  int window;
  float scale;
  float softcap;         // > 0: tanh(s / softcap) * softcap on kept scores
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four consecutive values of global memory, widened to fp32 (bf16: 8-byte
// aligned, widened by the intrinsics, exactly); two and four fp32 values
// stored as T (bf16: rounded to nearest even, as PyTorch's .to() rounds)
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The keys of one query tile (qt) in one key range (rg) of batch row b, and
// of one warp's (head, 16-row sub-tile) among them
struct TileKeys {
  int q0, p0;          // the tile's first query; position of query 0
  int front;           // the tile's last query position: no key above it is read
  int k_lo, k_hi;      // the range's keys (the window's and the split's bounds)
  int r_lo, r_hi;      // the ranges holding the tile's keys (0, 0: no split)
  int r0, hq;          // the warp's first query row and query head
  bool active;         // the warp has rows (its head < G, r0 < S)
  int wt_lo, wt_hi;    // the key tiles the warp's rows see
  int t_lo, ntiles;    // the block's key tiles
};

// false: range rg holds none of the tile's keys (the whole block skips it)
__device__ __forceinline__ bool tile_keys(const Params& p, int qt, int rg,
                                          int h, int hg, int b, int warp,
                                          TileKeys& k) {
  k.q0 = qt * 16 * p.qsub;
  k.p0 = p.pos0 ? p.pos0[b] : 0;
  k.front = min(k.p0 + min(k.q0 + 16 * p.qsub, p.S) - 1, p.Skv - 1);
  const int lo = p.window > 0 ? max(0, k.p0 + k.q0 - p.window + 1) : 0;
  k.k_lo = lo;
  k.k_hi = k.front;
  k.r_lo = k.r_hi = 0;
  if (p.split) {
    k.r_lo = lo / p.split;
    k.r_hi = k.front / p.split;
    if (rg < k.r_lo || rg > k.r_hi) return false;
    k.k_lo = max(lo, rg * p.split);
    k.k_hi = min(k.front, rg * p.split + p.split - 1);
  }
  const int j = hg * p.hb + warp / p.qsub;
  k.r0 = k.q0 + (warp % p.qsub) * 16;
  k.active = j < p.G && k.r0 < p.S;
  k.hq = h * p.G + j;
  const int w_hi = min(k.p0 + min(k.r0 + 16, p.S) - 1, k.k_hi);
  const int w_lo = p.window > 0 ? max(k.k_lo, k.p0 + k.r0 - p.window + 1)
                                : k.k_lo;
  k.wt_lo = w_lo / kBKV;
  k.wt_hi = w_lo <= w_hi ? w_hi / kBKV : -1;
  k.t_lo = k.k_lo / kBKV;
  k.ntiles = k.k_lo <= k.k_hi ? k.k_hi / kBKV - k.t_lo + 1 : 0;
  return true;
}

// The key loop over a kStages-deep cp.async ring: load(stage, tile) issues
// a key tile's copies (and commits none), body(stage, tile) multiplies a
// landed one where the warp's rows see it, the next kStages - 1 in flight
template <int kStages, typename Load, typename Body>
__device__ __forceinline__ void key_loop(const TileKeys& k, Load&& load,
                                         Body&& body) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k.ntiles) load(s, k.t_lo + s);
    cp_async_commit();
  }
  for (int i = 0; i < k.ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile i landed; tile i-1 is free
    const int nx = i + kStages - 1;
    if (nx < k.ntiles) load(nx % kStages, k.t_lo + nx);
    cp_async_commit();
    const int tile = k.t_lo + i;
    if (!k.active || tile < k.wt_lo || tile > k.wt_hi) continue;  // warp-uniform
    body(i % kStages, tile);
  }
  cp_async_wait<0>();
}

// One key tile's mask and online softmax: s holds the scores of rows g
// (c = 0, 1) and g + 8 (c = 2, 3) at keys kt0 + 8 jn + 2t + (c & 1), the
// queries at positions qp0 and qp0 + 8; s becomes exp(score - the new max),
// (m, l) move to the new maxima and acc is rescaled to them. kCap: the kept
// scaled scores take the softcap.
template <int NT, bool kCap>
__device__ __forceinline__ void softmax_step(const Params& p, float (&s)[4][4],
                                             float (&acc)[NT][4], int kt0,
                                             int qp0, int t, float& m0,
                                             float& l0, float& m1, float& l1) {
  const int qp1 = qp0 + 8;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = kt0 + 8 * jn + 2 * t + (c & 1);
      const int qp = c < 2 ? qp0 : qp1;
      bool ok = kp <= qp;
      if (p.window > 0) ok = ok && kp > qp - p.window;
      float x = s[jn][c] * p.scale;
      if constexpr (kCap) x = tanhf(x / p.softcap) * p.softcap;
      s[jn][c] = ok ? x : kNegInf;
      if (c < 2) mx0 = fmaxf(mx0, s[jn][c]);
      else mx1 = fmaxf(mx1, s[jn][c]);
    }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = expf(s[jn][c] - (c < 2 ? mn0 : mn1));
      s[jn][c] = e;
      if (c < 2) ps0 += e;
      else ps1 += e;
    }
  l0 = l0 * al0 + quad_sum(ps0);
  l1 = l1 * al1 + quad_sum(ps1);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= al0;
    acc[n][1] *= al0;
    acc[n][2] *= al1;
    acc[n][3] *= al1;
  }
}

// After a query tile's key loop: with one range, the normalised output of
// an active warp in T; with a split, this range's (m, l, acc) to scratch
// and, in the last range to finish, the combine of all of them in
// ascending order. smem: the block's dynamic shared memory, free again.
template <int D, typename T>
__device__ __forceinline__ void finish_tile(
    const Params& p, float* smem, int& is_last, const float (&acc)[D / 8][4],
    float m0, float l0, float m1, float l1, bool active, int qt, int rg,
    int h, int hg, int b, int q0, int r0, int hq, int r_lo, int r_hi) {
  constexpr int C4 = D / 4, NT = D / 8;
  const int warps = blockDim.x >> 5;
  const int rows = warps * 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr0 = r0 + g, qr1 = qr0 + 8;
  if (r_lo == r_hi) {                    // one range: normalise and store
    if (!active) return;
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    T* o0 = static_cast<T*>(p.out) +
            (((long long)b * p.S + qr0) * p.Hq + hq) * D + 2 * t;
    T* o1 = o0 + 8LL * p.Hq * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (qr0 < p.S) st2(o0 + n * 8, acc[n][0] / d0, acc[n][1] / d0);
      if (qr1 < p.S) st2(o1 + n * 8, acc[n][2] / d1, acc[n][3] / d1);
    }
    return;
  }

  // split: this range's (m, l, acc) to scratch; the last range to finish
  // combines all of them in ascending order
  const long long slot =
      (((long long)b * p.Hkv + h) * p.groups + hg) * p.q_tiles + qt;
  const long long range_floats = (long long)rows * (D + 2);
  float* slot_parts = p.parts + slot * p.ranges * range_floats;
  {
    float* po = slot_parts + rg * range_floats;
    const int row0 = warp * 16 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(po + row0 * D + n * 8 + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(po + (row0 + 8) * D + n * 8 + 2 * t) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if (t == 0) {
      float* ml = po + rows * D;
      ml[2 * row0] = m0;
      ml[2 * row0 + 1] = l0;
      ml[2 * row0 + 16] = m1;
      ml[2 * row0 + 17] = l1;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(p.counts + slot, 1) == r_hi - r_lo;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every range's (m, l) into shared memory at once (Q and the ring are
  // free now), each row's weights exp(m_r - M) and denominator, then the
  // elements; sums run over the ranges in ascending order. Loads are
  // unconditional (a range past the last reads the last with weight 0), so
  // that all of a step's loads are in flight together.
  const int nr = r_hi - r_lo + 1;             // <= kMaxRanges
  constexpr int kE = 8, kR = 4;               // elements, ranges a step
  const int nr_pad = (nr + kR - 1) / kR * kR;
  const float* first = slot_parts + r_lo * range_floats;
  float* wts = smem;                          // (rows, nr_pad) m, weights
  float* ls = smem + rows * nr_pad;           // (rows, nr_pad) l
  float* den = ls + rows * nr_pad;            // (rows,)
  for (int e = tid; e < rows * nr_pad; e += blockDim.x) {
    const int row = e / nr_pad, r = e % nr_pad;
    const float* ml = first + min(r, nr - 1) * range_floats + rows * D + 2 * row;
    const float m = __ldcg(ml), l = __ldcg(ml + 1);
    wts[e] = r < nr ? m : kNegInf;
    ls[e] = r < nr ? l : 0.f;
  }
  __syncthreads();
  for (int row = tid; row < rows; row += blockDim.x) {
    float M = kNegInf;
    for (int r = 0; r < nr; ++r) M = fmaxf(M, wts[row * nr_pad + r]);
    float lsum = 0.f;
    for (int r = 0; r < nr_pad; ++r) {
      const float w = r < nr ? expf(wts[row * nr_pad + r] - M) : 0.f;
      wts[row * nr_pad + r] = w;
      lsum += w * ls[row * nr_pad + r];
    }
    den[row] = fmaxf(lsum, 1e-20f);
  }
  __syncthreads();
  for (int e0 = tid; e0 < rows * C4; e0 += kE * blockDim.x) {
    float4 o[kE];
    int rowe[kE];
    const float* src[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int e = min(e0 + i * (int)blockDim.x, rows * C4 - 1);
      rowe[i] = e / C4;
      src[i] = first + rowe[i] * D + (e % C4) * 4;
    }
    for (int r0 = 0; r0 < nr_pad; r0 += kR) {
      float4 x[kR][kE];
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int i = 0; i < kE; ++i)
          x[j][i] = __ldcg(reinterpret_cast<const float4*>(
              src[i] + min(r0 + j, nr - 1) * range_floats));
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int i = 0; i < kE; ++i) {
          const float wr = wts[rowe[i] * nr_pad + r0 + j];
          o[i].x += wr * x[j][i].x;
          o[i].y += wr * x[j][i].y;
          o[i].z += wr * x[j][i].z;
          o[i].w += wr * x[j][i].w;
        }
    }
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int e = e0 + i * (int)blockDim.x;
      if (e >= rows * C4) break;
      const int row = rowe[i], c = e % C4, w = row >> 4;
      const int jj = hg * p.hb + w / p.qsub;
      const int qr = q0 + (w % p.qsub) * 16 + (row & 15);
      if (jj >= p.G || qr >= p.S) continue;
      const float d = den[row];
      st4(static_cast<T*>(p.out) +
              (((long long)b * p.S + qr) * p.Hq + h * p.G + jj) * D + c * 4,
          make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d));
    }
  }
  if (tid == 0) p.counts[slot] = 0;      // ready for the next launch
}

// The launch's checks, and the grid's counts from the plan; a
// cudaError_t (0: launch). parts_floats / count_ints: the capacity of the
// split's scratch.
int prepare(Params& p, int B, int D, long long parts_floats,
            long long count_ints) {
  if (p.Hkv < 1 || p.Hq % p.Hkv || p.hb < 1 || p.qsub < 1 ||
      p.hb * p.qsub > kMaxWarps || p.split < 0 || p.split % kBKV ||
      (p.pair && p.split) || !(p.softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  p.G = p.Hq / p.Hkv;
  p.groups = (p.G + p.hb - 1) / p.hb;
  p.q_tiles = (p.S + 16 * p.qsub - 1) / (16 * p.qsub);
  p.ranges = p.split ? (p.Skv + p.split - 1) / p.split : 1;
  const int warps = p.hb * p.qsub;
  if (p.ranges > kMaxRanges) return (int)cudaErrorInvalidValue;
  if (p.split) {
    const long long slots = (long long)B * p.Hkv * p.groups * p.q_tiles;
    if (!p.parts || !p.counts || count_ints < slots ||
        parts_floats < slots * p.ranges * warps * 16 * (D + 2))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* pos0, void* out, int S, int Skv, int Hq,
                   int Hkv, float scale, float softcap, int window, int hb,
                   int qsub, int split, int pair) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos0 = pos0;
  p.out = out;
  p.S = S;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.hb = hb;
  p.qsub = qsub;
  p.split = split;
  p.pair = pair;
  return p;
}

}  // namespace
