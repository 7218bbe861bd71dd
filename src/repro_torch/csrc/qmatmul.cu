// Gathered quantized matmul for the sparse mixed-precision FFN.
//
// Replaces: src/repro/kernels/qmatmul.py::_qmm_kernel (the Pallas TPU
// kernel behind `qmatmul`), in the gathered form the model's FFN needs
// (src/repro/core/mp_ffn.py::mp_ffn_apply gathers active neurons out of the
// banks built by core/quantize.py::build_neuron_banks, then multiplies).
//
// The port stores every bank neuron-major (core/quantize.py::
// to_neuron_major), so a gathered neuron is one contiguous row in all three
// products, read from the model's banks with the active ids `idx` inside the
// kernel (no gathered or dequantized copy of a bank exists in memory):
//   col (gate, up):  y[m, n] = s[idx[n]] * sum_k x[m, k] * W[idx[n], k]
//                    W is (f, K) fp32 or int8, or (f, K/2) int4 packed along
//                    K (low nibble = even k); the scale is per output.
//   row (down):      y[m, c] (+)= sum_j h[m, j] * s[idx[j]] * W[idx[j], c]
//                    W is (f, N) fp32 or int8, or (f, N/2) int4 packed along
//                    N; the scale is per contraction row.
// idx == nullptr means the identity. Quantized values are dequantized in
// registers and all sums are fp32, as in _qmm_kernel.
//
// Rows: x is (R, M, K) and idx (R, n), one active set per row (the server
// runs every request with its own predictor top-k), out (R, M, N). R = 1
// is the batch-shared form. The kernel, its tile and its K split depend
// only on one row's shape (M, N, K), never on R, so a row gives the same
// bits alone and in a group.
//
// What bounds it on an H100: small M (decode, M = 1..8 per row) does
// about 2*M FLOP per fp32 weight byte (4*M per int8 byte, 8*M per int4
// byte), so it is bound by the bytes of the active rows (3.35 TB/s); large
// M (16-token chunks, 512-token prompts) is bound by arithmetic, and fp32
// on the CUDA cores peaks at 67 TFLOP/s against 495 TFLOP/s of TF32 on the
// tensor cores.
//
// Design: two kernels, picked from one row's M (kernels/qmatmul.py::_plan).
//  * Kernel A, `qmm_gemv_col` / `qmm_gemv_row`, streams each active row
//    once with 16-byte loads. Col: a warp owns two neurons, each lane reads
//    16-byte units of both rows (4 fp32, 16 int8 or 32 int4 values), four
//    units per neuron in flight and the next four loading while these are
//    summed, against x staged in shared memory (cp.async, in K chunks of
//    at most 48 KB, while the first weights are in flight; permuted within
//    each 128-byte line so that lanes reading 64 or 128 bytes apart hit
//    distinct banks); the warp
//    reduces with shuffles in a fixed order. Row: the block stages its
//    split's neuron ids and h * scale in shared memory, a thread owns 8
//    consecutive output columns, the 8 warps walk interleaved neurons with
//    four (fp32) or eight (int8, int4) rows in flight, the warps' sums
//    meet in shared memory in warp order, and a second pass sums the
//    splits in split order.
//  * Kernel B, `qmm_mma_kernel`, runs the product on the tensor cores in
//    TF32 (`mma.sync.m16n8k8`) with split operands so that the result keeps
//    fp32 accuracy: x = hi + lo (hi = tf32(x), lo = tf32(x - hi)); int8 and
//    int4 weights are exact in TF32, so the int tiers issue 2 MMAs
//    (lo*w + hi*w), the fp tier 3 (lo*hi + hi*lo + hi*hi). Each 32-deep k
//    tile sums into fresh registers that are then added to the running
//    fp32 sum (the tensor cores' own accumulation does not round to
//    nearest). Tiles (BM = 16 or 64 rows by 64 outputs by 32 deep) come
//    through a 3-stage cp.async ring: the gathered weight rows as 16-byte
//    copies, int8/int4 kept raw in shared memory and dequantized while the
//    fragments are built. The col form's per-output scale is applied in
//    the epilogue, the row form's per-contraction scale is folded into A
//    before the split. Small outputs split K across blocks (the same
//    fixed-order second pass).
// bf16 (qmm_gathered_bf16 in qmatmul_bf16.cu, the reference's default
// precision): x (or h) is bf16 and so is the fp tier's bank (precision 0
// names it there); the int8 and int4 banks are the same bytes. Kernel A's
// bf16 form is this file's, another template instance: every value widened
// to fp32 as it is staged (__bfloat162float, exact), fp32 sums, a bf16 row
// read as 8 values a 16-byte unit. Kernel B here is fp32 only: its bf16
// form is a kernel of its own on the bf16 tensor cores, and so is the
// FFN's fused small-M GLU (qmatmul_bf16.cu).
// Tier widths (38, 78, 1037, 2073, ...) are not tile multiples: every edge
// is masked (cp.async zero-fills). Rows whose bytes are not 16-byte aligned
// (compact banks of odd width) take element-wise loads; the sums are the
// same either way. No atomics: every result is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// kBf16: the fp tier of a bf16 model (bf16 rows), beside bf16 x only
enum Precision { kFp = 0, kInt8 = 1, kInt4 = 2, kBf16 = 3 };
using bf16 = __nv_bfloat16;

template <int PREC>
__host__ __device__ constexpr bool is_int() {
  return PREC == kInt8 || PREC == kInt4;
}

// the two bf16 values of a 32-bit word (the lower address first), widened
// to fp32 by the intrinsic, exactly
__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
// an activation (x or h) widened to fp32
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

enum Layout { kCol = 0, kRow = 1 };

// signed value of byte i / nibble i of a little-endian 32-bit word
__device__ __forceinline__ int byte_at(uint32_t v, int i) {
  return (int)(v << (24 - 8 * i)) >> 24;
}
__device__ __forceinline__ int nibble_at(uint32_t v, int i) {
  return (int)(v << (28 - 4 * i)) >> 28;
}

// element k of a neuron row (int4: byte k/2, low nibble = even k)
template <int PREC>
__device__ __forceinline__ float load_elem(const char* row, int k) {
  if (PREC == kFp) return __ldg(reinterpret_cast<const float*>(row) + k);
  if (PREC == kInt8) return (float)__ldg(reinterpret_cast<const signed char*>(row) + k);
  if (PREC == kBf16) return __bfloat162float(__ldg(reinterpret_cast<const bf16*>(row) + k));
  const int b = __ldg(reinterpret_cast<const signed char*>(row) + (k >> 1));
  return (float)((k & 1) ? (b >> 4) : ((int)((unsigned)b << 28) >> 28));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// Kernel A: small M, bound by the weight bytes

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kNpw = 2;           // col: neurons per warp, read together
constexpr int kColUnroll = 4;     // col: 16-byte units per neuron in flight
constexpr int kXsFloats = 12288;  // col: x staged per K chunk (48 KB)
constexpr int kRowCols = 8;       // row: output columns per thread
constexpr int kRowBlockCols = 32 * kRowCols;
constexpr int kRowIds = 1024;     // row: neurons of a split (ids staged)
constexpr int kRowHs = 4096;      // row: h * scale values staged per split
static_assert(kRowBlockCols == kGemvThreads, "one reduced column per thread");

template <int PREC>
struct Unit {  // values in one 16-byte unit
  static constexpr int kElems =
      PREC == kFp ? 4 : PREC == kBf16 ? 8 : PREC == kInt8 ? 16 : 32;
};

// Where x[m, k] sits in a staged row: 16-byte groups of k are permuted
// inside each 128-byte line (group c goes to c ^ ((c >> 3) & 7)), so that a
// warp's lanes, which read k = lane * E + i for E = 16 or 32 values per
// unit, hit distinct banks instead of one.
__device__ __forceinline__ int swz(int k) {
  const int c = k >> 2;
  return ((c ^ ((c >> 3) & 7)) << 2) | (k & 3);
}

// acc[j][m] += sum over one 16-byte unit (k0 .. k0 + E) of neuron j's row
// against x[m]
template <int PREC, int MAXM>
__device__ __forceinline__ void unit_dot(const uint4 (&v)[kNpw],
                                         const float* xs, int k0, int ldx,
                                         int M, float (&acc)[kNpw][MAXM]) {
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    const float* xm = xs + m * ldx;
    if (PREC == kFp) {
      const float4 a = *reinterpret_cast<const float4*>(xm + swz(k0));
#pragma unroll
      for (int j = 0; j < kNpw; ++j) {
        float s = acc[j][m];
        s = fmaf(a.x, __uint_as_float(v[j].x), s);
        s = fmaf(a.y, __uint_as_float(v[j].y), s);
        s = fmaf(a.z, __uint_as_float(v[j].z), s);
        s = fmaf(a.w, __uint_as_float(v[j].w), s);
        acc[j][m] = s;
      }
    } else if (PREC == kBf16) {
      const float4 a = *reinterpret_cast<const float4*>(xm + swz(k0));
      const float4 b = *reinterpret_cast<const float4*>(xm + swz(k0 + 4));
#pragma unroll
      for (int j = 0; j < kNpw; ++j) {
        const float2 w0 = bf2(v[j].x), w1 = bf2(v[j].y);
        const float2 w2 = bf2(v[j].z), w3 = bf2(v[j].w);
        float s = acc[j][m];
        s = fmaf(a.x, w0.x, s);
        s = fmaf(a.y, w0.y, s);
        s = fmaf(a.z, w1.x, s);
        s = fmaf(a.w, w1.y, s);
        s = fmaf(b.x, w2.x, s);
        s = fmaf(b.y, w2.y, s);
        s = fmaf(b.z, w3.x, s);
        s = fmaf(b.w, w3.y, s);
        acc[j][m] = s;
      }
    } else {
      constexpr int kPerWord = PREC == kInt8 ? 4 : 8;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int h = 0; h < kPerWord; h += 4) {
          const float4 a = *reinterpret_cast<const float4*>(
              xm + swz(k0 + q * kPerWord + h));
#pragma unroll
          for (int j = 0; j < kNpw; ++j) {
            const uint32_t word =
                q == 0 ? v[j].x : q == 1 ? v[j].y : q == 2 ? v[j].z : v[j].w;
            float s = acc[j][m];
            if (PREC == kInt8) {
              s = fmaf(a.x, (float)byte_at(word, 0), s);
              s = fmaf(a.y, (float)byte_at(word, 1), s);
              s = fmaf(a.z, (float)byte_at(word, 2), s);
              s = fmaf(a.w, (float)byte_at(word, 3), s);
            } else {
              s = fmaf(a.x, (float)nibble_at(word, h + 0), s);
              s = fmaf(a.y, (float)nibble_at(word, h + 1), s);
              s = fmaf(a.z, (float)nibble_at(word, h + 2), s);
              s = fmaf(a.w, (float)nibble_at(word, h + 3), s);
            }
            acc[j][m] = s;
          }
        }
      }
    }
  }
}

// col form, one block row per x row: grid (ceil(N / 16), R); XT: x's type
// (bf16 x is widened as it is staged)
template <int PREC, int MAXM, typename XT>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gemv_col(const XT* __restrict__ x, const char* __restrict__ w,
             const float* __restrict__ scale, const int* __restrict__ idx,
             int M, int N, int K, long long ldw, int kc_len, int vec_x,
             int vec_w, int accumulate, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kXsFloats];
  constexpr int E = Unit<PREC>::kElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.y;
  x += (long long)row * M * K;
  out += (long long)row * M * N;
  if (idx) idx += (long long)row * N;

  const int nbase = (blockIdx.x * kGemvWarps + warp) * kNpw;
  const char* wr[kNpw];
  bool ok[kNpw];
  int rid[kNpw];
#pragma unroll
  for (int j = 0; j < kNpw; ++j) {
    const int n = nbase + j;
    ok[j] = n < N;
    rid[j] = ok[j] ? (idx ? idx[n] : n) : 0;
    wr[j] = w + (long long)rid[j] * ldw;
  }
  float acc[kNpw][MAXM];
#pragma unroll
  for (int j = 0; j < kNpw; ++j)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[j][m] = 0.f;

  for (int kc = 0; kc < K; kc += kc_len) {
    const int klen = min(kc_len, K - kc);
    __syncthreads();                       // the last chunk's reads are done
    // stage x[:, kc:kc+klen] with asynchronous copies, all in flight at once
    if constexpr (!std::is_same<XT, float>::value) {   // bf16: widened
      for (int i = threadIdx.x; i < M * klen; i += kGemvThreads) {
        const int m = i / klen, kk = i - m * klen;
        xs[m * kc_len + swz(kk)] = to_f(x[(long long)m * K + kc + kk]);
      }
    } else if (vec_x) {                    // K % 4 == 0, x 16-byte aligned
      const int q4 = klen / 4;
      for (int i = threadIdx.x; i < M * q4; i += kGemvThreads) {
        const int m = i / q4, kk = (i - m * q4) * 4;
        cp_async16(xs + m * kc_len + swz(kk), x + (long long)m * K + kc + kk,
                   16);
      }
    } else {
      for (int i = threadIdx.x; i < M * klen; i += kGemvThreads) {
        const int m = i / klen, kk = i - m * klen;
        cp_async4(xs + m * kc_len + swz(kk), x + (long long)m * K + kc + kk,
                  4);
      }
    }
    cp_async_commit();
    if (vec_w) {                           // K % E == 0, rows 16-byte aligned
      const int u0 = kc / E, nu = klen / E;
      uint4 v[kColUnroll][kNpw];
      auto fetch = [&](int u) {
#pragma unroll
        for (int q = 0; q < kColUnroll; ++q)
#pragma unroll
          for (int j = 0; j < kNpw; ++j) {
            const int uu = u + 32 * q;
            v[q][j] = (ok[j] && uu < nu)
                ? __ldg(reinterpret_cast<const uint4*>(wr[j]) + u0 + uu)
                : make_uint4(0u, 0u, 0u, 0u);
          }
      };
      fetch(lane);                         // the first weights fly with x
      cp_async_wait<0>();
      __syncthreads();
      for (int u = lane; u < nu; u += 32 * kColUnroll) {
        uint4 cur[kColUnroll][kNpw];
#pragma unroll
        for (int q = 0; q < kColUnroll; ++q)
#pragma unroll
          for (int j = 0; j < kNpw; ++j) cur[q][j] = v[q][j];
        if (u + 32 * kColUnroll < nu) fetch(u + 32 * kColUnroll);
#pragma unroll
        for (int q = 0; q < kColUnroll; ++q) {
          const int uu = u + 32 * q;
          if (uu < nu) unit_dot<PREC, MAXM>(cur[q], xs, uu * E, kc_len, M, acc);
        }
      }
    } else {
      cp_async_wait<0>();
      __syncthreads();
      for (int kk = lane; kk < klen; kk += 32) {
        float wv[kNpw];
#pragma unroll
        for (int j = 0; j < kNpw; ++j)
          wv[j] = ok[j] ? load_elem<PREC>(wr[j], kc + kk) : 0.f;
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m >= M) break;
          const float xv = xs[m * kc_len + swz(kk)];
#pragma unroll
          for (int j = 0; j < kNpw; ++j) acc[j][m] = fmaf(xv, wv[j], acc[j][m]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNpw; ++j)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      float v = acc[j][m];
#pragma unroll
      for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[j][m] = v;
    }
  if (lane != 0) return;
#pragma unroll
  for (int j = 0; j < kNpw; ++j) {
    if (!ok[j]) continue;
    const float s = (is_int<PREC>() && scale) ? scale[rid[j]] : 1.f;
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m >= M) break;
      float* o = out + (long long)m * N + nbase + j;
      const float y = acc[j][m] * s;
      *o = accumulate ? *o + y : y;
    }
  }
}

// row form: grid (ceil(N / 256), 1, R * splits); a split holds at most
// kRowIds neurons and M * (its neurons) <= kRowHs
template <int PREC, int MAXM, typename XT>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gemv_row(const XT* __restrict__ h, const char* __restrict__ w,
             const float* __restrict__ scale, const int* __restrict__ idx,
             int M, int N, int K, long long ldw, int k_split, int splits,
             int vec_w, int accumulate, float* __restrict__ out,
             float* __restrict__ parts) {
  constexpr int U = PREC == kFp ? 4 : 8;   // neuron rows in flight per warp
  __shared__ float red[kGemvWarps][kRowBlockCols];
  __shared__ int rid_s[kRowIds];
  __shared__ float hs[kRowHs];             // h[m, j] * s[j], [m][jj]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.z / splits;
  const int jbeg = (blockIdx.z % splits) * k_split;
  const int jlen = min(K, jbeg + k_split) - jbeg;
  h += (long long)row * M * K;
  if (idx) idx += (long long)row * K;
  for (int i = threadIdx.x; i < jlen; i += kGemvThreads) {
    const int r = idx ? idx[jbeg + i] : jbeg + i;
    const float s = (is_int<PREC>() && scale) ? scale[r] : 1.f;
    rid_s[i] = r;
    for (int m = 0; m < M; ++m)
      hs[m * jlen + i] = to_f(h[(long long)m * K + jbeg + i]) * s;
  }
  __syncthreads();
  const int c0 = blockIdx.x * kRowBlockCols + lane * kRowCols;
  const bool full = vec_w && c0 + kRowCols <= N;

  float acc[MAXM][kRowCols];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) acc[m][c] = 0.f;

  for (int j0 = warp; j0 < jlen; j0 += kGemvWarps * U) {
    uint4 raw[U][2];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int jj = j0 + q * kGemvWarps;
      raw[q][0] = raw[q][1] = make_uint4(0u, 0u, 0u, 0u);
      if (jj < jlen && full) {
        const char* p = w + (long long)rid_s[jj] * ldw;
        if (PREC == kFp) {
          raw[q][0] = __ldg(reinterpret_cast<const uint4*>(p) + c0 / 4);
          raw[q][1] = __ldg(reinterpret_cast<const uint4*>(p) + c0 / 4 + 1);
        } else if (PREC == kBf16) {
          raw[q][0] = __ldg(reinterpret_cast<const uint4*>(p) + c0 / 8);
        } else if (PREC == kInt8) {
          const uint2 t = __ldg(reinterpret_cast<const uint2*>(p + c0));
          raw[q][0].x = t.x;
          raw[q][0].y = t.y;
        } else {
          raw[q][0].x = __ldg(reinterpret_cast<const unsigned int*>(p + c0 / 2));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int jj = j0 + q * kGemvWarps;
      if (jj >= jlen) break;               // uniform across the warp
      float wv[kRowCols];
      if (full) {
        if (PREC == kFp) {
          wv[0] = __uint_as_float(raw[q][0].x); wv[1] = __uint_as_float(raw[q][0].y);
          wv[2] = __uint_as_float(raw[q][0].z); wv[3] = __uint_as_float(raw[q][0].w);
          wv[4] = __uint_as_float(raw[q][1].x); wv[5] = __uint_as_float(raw[q][1].y);
          wv[6] = __uint_as_float(raw[q][1].z); wv[7] = __uint_as_float(raw[q][1].w);
        } else if (PREC == kBf16) {
          const float2 w0 = bf2(raw[q][0].x), w1 = bf2(raw[q][0].y);
          const float2 w2 = bf2(raw[q][0].z), w3 = bf2(raw[q][0].w);
          wv[0] = w0.x; wv[1] = w0.y; wv[2] = w1.x; wv[3] = w1.y;
          wv[4] = w2.x; wv[5] = w2.y; wv[6] = w3.x; wv[7] = w3.y;
        } else if (PREC == kInt8) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wv[c] = (float)byte_at(raw[q][0].x, c);
            wv[4 + c] = (float)byte_at(raw[q][0].y, c);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) wv[c] = (float)nibble_at(raw[q][0].x, c);
        }
      } else {
        const char* p = w + (long long)rid_s[jj] * ldw;
#pragma unroll
        for (int c = 0; c < kRowCols; ++c)
          wv[c] = c0 + c < N ? load_elem<PREC>(p, c0 + c) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m >= M) break;
        const float hv = hs[m * jlen + jj];
#pragma unroll
        for (int c = 0; c < kRowCols; ++c) acc[m][c] = fmaf(hv, wv[c], acc[m][c]);
      }
    }
  }

  // the warps' sums for each column, in warp order
  const int n = blockIdx.x * kRowBlockCols + threadIdx.x;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) red[warp][lane * kRowCols + c] = acc[m][c];
    __syncthreads();
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < kGemvWarps; ++ww) v += red[ww][threadIdx.x];
    if (n < N) {
      if (splits == 1) {
        float* o = out + ((long long)row * M + m) * N + n;
        *o = accumulate ? *o + v : v;
      } else {
        parts[((long long)blockIdx.z * M + m) * N + n] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel B: large M on the tensor cores (split TF32, fp32 sums)

constexpr int kMmaThreads = 128;
constexpr int kBK = 32;
constexpr int kBN = 64;
constexpr int kStages = 3;
constexpr int kMmaMinBlocks = 3;   // resident blocks per SM the registers allow
constexpr int kMmaRowSpan = 2560;  // row form: most neurons in one split
constexpr int kALd = kBK + 8;  // A row stride (floats): 8-byte fragment
                               // loads of a half-warp hit 32 banks once

template <int BM, int PREC, int LAYOUT>
struct MmaSmem {
  static constexpr int kA = BM * kALd * 4;
  static constexpr int kBRowBytes = LAYOUT == kCol
      ? (PREC == kFp ? kALd * 4 : 48)              // B[n][k], k contiguous
      : (PREC == kFp ? (kBN + 8) * 4 : 80);        // B[k][n]
  static constexpr int kBRows = LAYOUT == kCol ? kBN : kBK;
  static constexpr int kB = kBRows * kBRowBytes;
  static constexpr int kStage = kA + kB;
  // row form: the split's neuron ids (and int scales), staged once
  static constexpr int kRowInfo =
      LAYOUT == kRow ? kMmaRowSpan * (is_int<PREC>() ? 8 : 4) : 0;
  static constexpr int kTotal = kStages * kStage + kRowInfo;
};

// v = hi + lo: hi keeps TF32's 10 mantissa bits (truncated), lo = v - hi
// is exact in fp32 and |lo| < 2^-10 |v|; the MMA reads the top 19 bits of
// each operand, so the pair carries v to about 2^-20 of its size
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// row form: B(k, n) of a stage, dequantized (k, n relative to the tile)
template <int PREC, int RB>
__device__ __forceinline__ float row_b(const unsigned char* Bs, int k, int n) {
  const unsigned char* r = Bs + k * RB;
  if (PREC == kFp) return reinterpret_cast<const float*>(r)[n];
  if (PREC == kInt8) return (float)(signed char)r[n];
  return (float)nibble_at(r[n >> 1], n & 1);
}

// B(k, n) and B(k + 1, n) of a stage, dequantized (k even, relative to the
// tile)
template <int PREC, int LAYOUT, int RB>
__device__ __forceinline__ void tile_b2(const unsigned char* Bs, int k, int n,
                                        float& b0, float& b1) {
  if (LAYOUT == kCol) {
    const unsigned char* r = Bs + n * RB;
    if (PREC == kFp) {
      const float2 v = *reinterpret_cast<const float2*>(r + 4 * k);
      b0 = v.x;
      b1 = v.y;
    } else if (PREC == kInt8) {
      const unsigned short v = *reinterpret_cast<const unsigned short*>(r + k);
      b0 = (float)byte_at(v, 0);
      b1 = (float)byte_at(v, 1);
    } else {
      const unsigned v = r[k >> 1];
      b0 = (float)nibble_at(v, 0);
      b1 = (float)nibble_at(v, 1);
    }
    return;
  }
  b0 = row_b<PREC, RB>(Bs, k, n);
  b1 = row_b<PREC, RB>(Bs, k + 1, n);
}

// grid (ceil(N / 64), ceil(M / BM), R * splits); fp32 x (the bf16 form is
// qmatmul_bf16.cu's qmm_mma_bf16)
template <int BM, int PREC, int LAYOUT>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
qmm_mma_kernel(const float* __restrict__ x, const char* __restrict__ w,
               const float* __restrict__ scale, const int* __restrict__ idx,
               int M, int N, int K, long long ldw, int k_split, int splits,
               int vec_x, int vec_w, int accumulate, float* __restrict__ out,
               float* __restrict__ parts) {
  using S = MmaSmem<BM, PREC, LAYOUT>;
  constexpr int RB = S::kBRowBytes;
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WTM = BM / WARPS_M, WTN = kBN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int BPE2 =                                  // 2 x bytes per value
      PREC == kFp ? 8 : PREC == kInt8 ? 2 : 1;
  constexpr int UE = 32 / BPE2;                                  // values per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int col_id[kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int row = blockIdx.z / splits;
  const int kbeg = (blockIdx.z % splits) * k_split;
  const int kend = min(K, kbeg + k_split);
  x += (long long)row * M * K;
  if (idx) idx += (long long)row * (LAYOUT == kCol ? N : K);
  int* row_id = reinterpret_cast<int*>(smem + kStages * S::kStage);
  float* row_sc = reinterpret_cast<float*>(row_id + kMmaRowSpan);
  if (LAYOUT == kCol && tid < kBN) {
    const int n = n0 + tid;
    col_id[tid] = n < N ? (idx ? idx[n] : n) : -1;
  }
  if (LAYOUT == kRow) {                   // up to the last tile's end
    const int span = (kend - kbeg + kBK - 1) / kBK * kBK;
    for (int i = tid; i < span; i += kMmaThreads) {
      const bool ok = i < kend - kbeg;
      const int r = ok ? (idx ? idx[kbeg + i] : kbeg + i) : 0;
      row_id[i] = r;
      if (is_int<PREC>()) row_sc[i] = (ok && scale) ? scale[r] : 1.f;
    }
  }
  __syncthreads();

  auto load_tile = [&](int st, int k0) {
    unsigned char* base = smem + st * S::kStage;
    float* As = reinterpret_cast<float*>(base);
    unsigned char* Bs = base + S::kA;
    if (vec_x) {                           // K % 4 == 0, x 16-byte aligned
      for (int e = tid; e < BM * (kBK / 4); e += kMmaThreads) {
        const int mm = e / (kBK / 4), kq = (e % (kBK / 4)) * 4;
        const int m = m0 + mm, k = k0 + kq;
        const int n_ok = m < M ? max(0, min(4, kend - k)) : 0;
        cp_async16(As + mm * kALd + kq, n_ok ? x + (long long)m * K + k : x,
                   4 * n_ok);
      }
    } else {
      for (int e = tid; e < BM * kBK; e += kMmaThreads) {
        const int mm = e / kBK, kk = e % kBK;
        const int m = m0 + mm, k = k0 + kk;
        const bool ok = m < M && k < kend;
        cp_async4(As + mm * kALd + kk, ok ? x + (long long)m * K + k : x,
                  ok ? 4 : 0);
      }
    }
    if (LAYOUT == kCol) {
      constexpr int kRowBytes = kBK * BPE2 / 2;          // 128, 32, 16
      if (vec_w) {
        constexpr int kUnits = kRowBytes / 16;
        for (int e = tid; e < kBN * kUnits; e += kMmaThreads) {
          const int nn = e / kUnits, u = e % kUnits;
          const int r = col_id[nn];
          const int ke = k0 + u * UE;
          const int n_ok = r >= 0 ? max(0, min(UE, kend - ke)) : 0;
          const int bytes = n_ok * BPE2 / 2;
          cp_async16(Bs + nn * RB + u * 16,
                     bytes ? w + (long long)r * ldw + (long long)ke * BPE2 / 2
                           : w, bytes);
        }
      } else if (PREC == kFp) {
        for (int e = tid; e < kBN * kBK; e += kMmaThreads) {
          const int nn = e / kBK, kk = e % kBK;
          const int r = col_id[nn], k = k0 + kk;
          const bool ok = r >= 0 && k < kend;
          cp_async4(Bs + nn * RB + kk * 4,
                    ok ? w + (long long)r * ldw + (long long)k * 4 : w,
                    ok ? 4 : 0);
        }
      } else {
        for (int e = tid; e < kBN * kRowBytes; e += kMmaThreads) {
          const int nn = e / kRowBytes, b = e % kRowBytes;
          const int r = col_id[nn];
          const int k = k0 + (PREC == kInt8 ? b : 2 * b);  // first value in the byte
          Bs[nn * RB + b] = (r >= 0 && k < kend)
              ? __ldg(reinterpret_cast<const unsigned char*>(w) +
                      (long long)r * ldw + (PREC == kInt8 ? k : k / 2))
              : (unsigned char)0;
        }
      }
    } else {
      constexpr int kRowBytes = kBN * BPE2 / 2;          // 256, 64, 32
      if (vec_w) {
        constexpr int kUnits = kRowBytes / 16;
        for (int e = tid; e < kBK * kUnits; e += kMmaThreads) {
          const int kk = e / kUnits, u = e % kUnits;
          const int j = k0 + kk, ce = n0 + u * UE;
          const int n_ok = j < kend ? max(0, min(UE, N - ce)) : 0;
          const int bytes = n_ok * BPE2 / 2;
          const long long r = bytes ? row_id[j - kbeg] : 0;
          cp_async16(Bs + kk * RB + u * 16,
                     bytes ? w + r * ldw + (long long)ce * BPE2 / 2 : w, bytes);
        }
      } else if (PREC == kFp) {
        for (int e = tid; e < kBK * kBN; e += kMmaThreads) {
          const int kk = e / kBN, nn = e % kBN;
          const int j = k0 + kk, c = n0 + nn;
          const bool ok = j < kend && c < N;
          const long long r = ok ? row_id[j - kbeg] : 0;
          cp_async4(Bs + kk * RB + nn * 4, ok ? w + r * ldw + (long long)c * 4 : w,
                    ok ? 4 : 0);
        }
      } else {
        for (int e = tid; e < kBK * kRowBytes; e += kMmaThreads) {
          const int kk = e / kRowBytes, b = e % kRowBytes;
          const int j = k0 + kk;
          const int c = n0 + (PREC == kInt8 ? b : 2 * b);
          const bool ok = j < kend && c < N;
          const long long r = ok ? row_id[j - kbeg] : 0;
          Bs[kk * RB + b] = ok
              ? __ldg(reinterpret_cast<const unsigned char*>(w) + r * ldw +
                      (PREC == kInt8 ? c : c / 2))
              : (unsigned char)0;
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;

  auto compute = [&](int st, int k0) {
    const unsigned char* base = smem + st * S::kStage;
    const float* As = reinterpret_cast<const float*>(base);
    const unsigned char* Bs = base + S::kA;
    const float* rs = row_sc + (k0 - kbeg);   // row form, int tiers
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][jn][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mr = wm * WTM + i * 16 + g;
        // fragment k slots t and t + 4 hold k = kk + 2t and kk + 2t + 1
        // (the same order for B): one 8-byte load per row pair
        const float2 lo_row =
            *reinterpret_cast<const float2*>(As + mr * kALd + kk + 2 * t);
        const float2 hi_row =
            *reinterpret_cast<const float2*>(As + (mr + 8) * kALd + kk + 2 * t);
        float a[4] = {lo_row.x, hi_row.x, lo_row.y, hi_row.y};
        if (LAYOUT == kRow && is_int<PREC>()) {
          a[0] *= rs[kk + 2 * t];
          a[1] *= rs[kk + 2 * t];
          a[2] *= rs[kk + 2 * t + 1];
          a[3] *= rs[kk + 2 * t + 1];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[i][q], alo[i][q]);
      }
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int nc = wn * WTN + jn * 8 + g;
        float b0, b1;
        tile_b2<PREC, LAYOUT, RB>(Bs, kk + 2 * t, nc, b0, b1);
        if (PREC == kFp) {
          split_tf32(b0, bhi[jn][0], blo[jn][0]);
          split_tf32(b1, bhi[jn][1], blo[jn][1]);
        } else {            // |q| <= 127: exact in TF32
          bhi[jn][0] = __float_as_uint(b0);
          bhi[jn][1] = __float_as_uint(b1);
        }
      }
      // one pass per term, small terms first: the MT * NT MMAs of a pass
      // are independent, so a sum never waits on the MMA just issued
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_tf32(part[i][jn], alo[i], bhi[jn]);
      if (PREC == kFp) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) mma_tf32(part[i][jn], ahi[i], blo[jn]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_tf32(part[i][jn], ahi[i], bhi[jn]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jn][q] += part[i][jn][q];
  };

  const int ktiles = (kend - kbeg + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, kbeg + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // stage kt landed; kt-1 is free
    const int nt = kt + kStages - 1;
    if (nt < ktiles) load_tile(nt % kStages, kbeg + nt * kBK);
    cp_async_commit();
    compute(kt % kStages, kbeg + kt * kBK);
  }
  cp_async_wait<0>();

  const bool direct = splits == 1;
  float* o = direct ? out + (long long)row * M * N
                    : parts + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * WTM + i * 16 + g + (q >= 2 ? 8 : 0);
        const int nn = wn * WTN + jn * 8 + 2 * t + (q & 1);
        const int n = n0 + nn;
        if (m >= M || n >= N) continue;
        float v = acc[i][jn][q];
        if (LAYOUT == kCol && is_int<PREC>() && scale) v *= scale[col_id[nn]];
        float* p = o + (long long)m * N + n;
        *p = (direct && accumulate) ? *p + v : v;
      }
}

// out[r, j] = (accumulate ? out[r, j] : 0) + sum over splits, in split
// order; parts is (R, splits, count), out (R, count)
__global__ void sum_splits(const float* __restrict__ parts, int splits,
                           long long count, long long total, int accumulate,
                           float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / count, j = i % count;
    const float* p = parts + r * splits * count + j;
    float s = accumulate ? out[i] : 0.f;
    for (int z = 0; z < splits; ++z) s += p[(long long)z * count];
    out[i] = s;
  }
}

struct Args {
  const void* x;       // XT of the launch
  const char* w;
  const float* scale;
  const int* idx;
  int R, M, N, K;
  long long ldw;
  int k_split, splits, vec_x, vec_w, accumulate;
  float* out;
  float* parts;
  cudaStream_t st;
};

template <int PREC, int MAXM, typename XT>
int launch_gemv(int layout, const Args& a) {
  const XT* x = static_cast<const XT*>(a.x);
  if (layout == kCol) {
    dim3 grid((a.N + kGemvWarps * kNpw - 1) / (kGemvWarps * kNpw), a.R);
    qmm_gemv_col<PREC, MAXM, XT><<<grid, kGemvThreads, 0, a.st>>>(
        x, a.w, a.scale, a.idx, a.M, a.N, a.K, a.ldw, a.k_split, a.vec_x,
        a.vec_w, a.accumulate, a.out);
  } else {
    dim3 grid((a.N + kRowBlockCols - 1) / kRowBlockCols, 1, a.R * a.splits);
    qmm_gemv_row<PREC, MAXM, XT><<<grid, kGemvThreads, 0, a.st>>>(
        x, a.w, a.scale, a.idx, a.M, a.N, a.K, a.ldw, a.k_split, a.splits,
        a.vec_w, a.accumulate, a.out, a.parts);
  }
  return 0;
}

template <int BM, int PREC, int LAYOUT>
int launch_mma(const Args& a) {
  using S = MmaSmem<BM, PREC, LAYOUT>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_mma_kernel<BM, PREC, LAYOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kTotal);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, a.R * a.splits);
  qmm_mma_kernel<BM, PREC, LAYOUT><<<grid, kMmaThreads, S::kTotal, a.st>>>(
      static_cast<const float*>(a.x), a.w, a.scale, a.idx, a.M, a.N, a.K, a.ldw, a.k_split, a.splits,
      a.vec_x, a.vec_w, a.accumulate, a.out, a.parts);
  return 0;
}

template <int PREC, typename XT>
int dispatch(int layout, int kernel, int tile, const Args& a) {
  if (kernel == 0) {
    switch (tile) {
      case 1: return launch_gemv<PREC, 1, XT>(layout, a);
      case 4: return launch_gemv<PREC, 4, XT>(layout, a);
      case 8: return launch_gemv<PREC, 8, XT>(layout, a);
      case 16: return launch_gemv<PREC, 16, XT>(layout, a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (tile == 16)
    return layout == kCol ? launch_mma<16, PREC, kCol>(a)
                          : launch_mma<16, PREC, kRow>(a);
  if (tile == 64)
    return layout == kCol ? launch_mma<64, PREC, kCol>(a)
                          : launch_mma<64, PREC, kRow>(a);
  return (int)cudaErrorInvalidValue;
}

// the checks of both entry points, the launch, then the splits' sum; XT:
// x's type (bf16: precision 0 names the bf16 fp tier)
template <typename XT>
int gathered(const void* x, const void* w, const float* scale,
             const int* idx, int R, int M, int N, int K, long long ldw,
             int precision, int layout, int kernel, int tile, int splits,
             int k_split, int vec_x, int vec_w, int accumulate, float* out,
             float* parts, void* stream) {
  if ((long long)R * splits > 65535 || (kernel == 0 && layout == kCol &&
                                        splits != 1))
    return (int)cudaErrorInvalidValue;
  if (kernel == 0 && layout == kRow &&
      (k_split > kRowIds || (long long)M * k_split > kRowHs))
    return (int)cudaErrorInvalidValue;
  if (kernel == 1 && layout == kRow && k_split > kMmaRowSpan)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && parts == nullptr) return (int)cudaErrorInvalidValue;
  Args a{x, (const char*)w, scale, idx, R, M, N, K, ldw, k_split, splits,
         vec_x, vec_w, accumulate, out, parts, (cudaStream_t)stream};
  constexpr int kFpTier = std::is_same<XT, float>::value ? kFp : kBf16;
  int err = precision == kFp ? dispatch<kFpTier, XT>(layout, kernel, tile, a)
          : precision == kInt8 ? dispatch<kInt8, XT>(layout, kernel, tile, a)
          : precision == kInt4 ? dispatch<kInt4, XT>(layout, kernel, tile, a)
          : (int)cudaErrorInvalidValue;
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long count = (long long)M * N;
  const long long total = count * R;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, threads, 0, a.st>>>(parts, splits, count,
                                                     total, accumulate, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). x is (R, M, K), idx (R, n) or null,
// out (R, M, N). kernel 0 = kernel A (tile = MAXM: 1, 4, 8 or 16; col form:
// k_split is the K chunk staged in shared memory, splits must be 1; row
// form: k_split <= 1024 and M * k_split <= 4096), kernel 1 = kernel B
// (tile = BM: 16 or 64; row form: k_split <= 2560). ldw is a bank row's stride in
// bytes. `parts` holds R*splits*M*N floats and may be null when splits == 1.
#ifndef QMATMUL_BF16
extern "C" int qmm_gathered(const float* x, const void* w, const float* scale,
                            const int* idx, int R, int M, int N, int K,
                            long long ldw, int precision, int layout,
                            int kernel, int tile, int splits, int k_split,
                            int vec_x, int vec_w, int accumulate, float* out,
                            float* parts, void* stream) {
  return gathered<float>(x, w, scale, idx, R, M, N, K, ldw, precision,
                         layout, kernel, tile, splits, k_split, vec_x, vec_w,
                         accumulate, out, parts, stream);
}
#endif  // QMATMUL_BF16
