// Gathered quantized matmul for the sparse mixed-precision FFN.
//
// Replaces: src/repro/kernels/qmatmul.py::_qmm_kernel (the Pallas TPU
// kernel behind `qmatmul`), in the gathered form the model's FFN needs
// (src/repro/core/mp_ffn.py::mp_ffn_apply gathers active neurons out of the
// banks built by core/quantize.py::build_neuron_banks, then multiplies).
//
// Two layouts over the model's own banks, with the active neuron ids read
// from `idx` inside the kernel, so no gathered or dequantized copy of a bank
// ever exists in device memory:
//   col (gate, up):  y[M, n] = sum_k x[M, k] * W[k, idx[n]]        * s[idx[n]]
//                    W is (K, f) fp32 or int8, or (K/2, f) int4 packed along
//                    K (low nibble = even k); the scale is per output column.
//   row (down):      y[M, n] (+)= sum_k h[M, k] * W[idx[k], n] * s[idx[k]]
//                    W is (f, N) fp32 or int8, or (f, N/2) int4 packed along
//                    N; the scale is per contraction row.
// idx == nullptr means the identity (plain `qmatmul`). Quantized values are
// dequantized in registers and all sums are fp32, as in _qmm_kernel.
//
// What bounds it on an H100: at decode (M = batch = 4) the work is about
// 2 FLOP per weight byte, so it is bound by device-memory bytes. The col
// layout is the hard part: gathered columns of a row-major (K, f) bank sit
// f elements apart, so each 32-byte sector read carries one useful value of
// fp32 and a few of int8/int4; the useful-byte bound in PERF.md is therefore
// not reachable from this bank layout. The row layout reads whole
// contiguous neuron rows and is coalesced.
//
// Design: a shared-memory tiled SGEMM (64 output columns x BM rows per
// block, 32-deep k tiles, 256 threads, 16x16 thread grid) whose B-tile loader
// does the gather and the dequantization. BM = 16 for decode-sized M and 64
// for prefill. Tier widths (38, 78, 1037, 2073, ...) are not tile multiples,
// so every tail is masked. Because M is small at decode, the K axis is split
// across gridDim.z so that enough blocks are in flight; each split writes its
// own partial tile and a second pass sums the splits in a fixed order, so the
// result is deterministic (no atomics). Simple and right first: no tensor
// cores, no TMA, no asynchronous copies yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

enum Precision { kFp = 0, kInt8 = 1, kInt4 = 2 };
enum Layout { kCol = 0, kRow = 1 };

__device__ __forceinline__ int nibble(int8_t b, int hi) {
  // low nibble sign-extended by (b << 4) >> 4, high nibble by b >> 4
  return hi ? ((int)b >> 4) : ((int)((unsigned)(int)b << 28) >> 28);
}

template <int BM, int PREC, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ x, const void* __restrict__ w,
           const float* __restrict__ scale, const int* __restrict__ idx,
           int M, int N, int K, long long ldw, int k_split,
           float* __restrict__ out) {
  constexpr int TM = BM / 16;
  constexpr int TN = kBN / 16;
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][kBN];
  __shared__ int col_id[kBN];       // col layout: bank column of each tile column
  __shared__ int row_id[kBK];       // row layout: bank row of each k in the tile
  __shared__ float row_scale[kBK];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);

  if (LAYOUT == kCol && tid < kBN) {
    const int n = n0 + tid;
    col_id[tid] = n < N ? (idx ? idx[n] : n) : 0;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    if (LAYOUT == kRow && tid < kBK) {
      const int k = k0 + tid;
      int r = 0;
      float s = 1.f;
      if (k < kend) {
        r = idx ? idx[k] : k;
        if (PREC != kFp && scale) s = scale[r];
      }
      row_id[tid] = r;
      row_scale[tid] = s;
    }
    __syncthreads();
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < kend) ? x[(long long)m * K + k] : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e % kBN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < kend && n < N) {
        if (LAYOUT == kCol) {
          const long long c = col_id[nn];
          if (PREC == kFp) {
            v = ((const float*)w)[(long long)k * ldw + c];
          } else if (PREC == kInt8) {
            v = (float)((const int8_t*)w)[(long long)k * ldw + c];
          } else {
            v = (float)nibble(((const int8_t*)w)[(long long)(k >> 1) * ldw + c],
                              k & 1);
          }
        } else {
          const long long r = row_id[kk];
          if (PREC == kFp) {
            v = ((const float*)w)[r * ldw + n];
          } else if (PREC == kInt8) {
            v = (float)((const int8_t*)w)[r * ldw + n] * row_scale[kk];
          } else {
            v = (float)nibble(((const int8_t*)w)[r * ldw + (n >> 1)], n & 1)
                * row_scale[kk];
          }
        }
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = tx + 16 * j;
      const int n = n0 + nn;
      if (n >= N) continue;
      float v = acc[i][j];
      if (LAYOUT == kCol && PREC != kFp && scale) v *= scale[col_id[nn]];
      o[(long long)m * N + n] = v;
    }
  }
}

// out[i] = (accumulate ? out[i] : 0) + sum over splits, in split order
__global__ void sum_splits(const float* __restrict__ parts, int splits,
                           long long count, int accumulate,
                           float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float s = accumulate ? out[i] : 0.f;
    for (int z = 0; z < splits; ++z) s += parts[(long long)z * count + i];
    out[i] = s;
  }
}

template <int BM, int PREC, int LAYOUT>
void launch(dim3 grid, cudaStream_t st, const float* x, const void* w,
            const float* scale, const int* idx, int M, int N, int K,
            long long ldw, int k_split, float* dst) {
  qmm_kernel<BM, PREC, LAYOUT><<<grid, kThreads, 0, st>>>(
      x, w, scale, idx, M, N, K, ldw, k_split, dst);
}

template <int BM>
int dispatch(int precision, int layout, dim3 grid, cudaStream_t st,
             const float* x, const void* w, const float* scale,
             const int* idx, int M, int N, int K, long long ldw, int k_split,
             float* dst) {
#define QMM_CASE(P, L)                                                     \
  if (precision == P && layout == L) {                                     \
    launch<BM, P, L>(grid, st, x, w, scale, idx, M, N, K, ldw, k_split, dst); \
    return 0;                                                              \
  }
  QMM_CASE(kFp, kCol) QMM_CASE(kInt8, kCol) QMM_CASE(kInt4, kCol)
  QMM_CASE(kFp, kRow) QMM_CASE(kInt8, kRow) QMM_CASE(kInt4, kRow)
#undef QMM_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 on success). `parts` holds splits*M*N floats and
// may be null only when splits == 1 and accumulate == 0.
extern "C" int qmm_gathered(const float* x, const void* w, const float* scale,
                            const int* idx, int M, int N, int K,
                            long long ldw, int precision, int layout,
                            int accumulate, int splits, int k_split,
                            int small_m, float* out, float* parts,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool direct = splits == 1 && !accumulate;
  float* dst = direct ? out : parts;
  const int bm = small_m ? 16 : 64;
  dim3 grid((N + kBN - 1) / kBN, (M + bm - 1) / bm, splits);
  int err = small_m
      ? dispatch<16>(precision, layout, grid, st, x, w, scale, idx, M, N, K,
                     ldw, k_split, dst)
      : dispatch<64>(precision, layout, grid, st, x, w, scale, idx, M, N, K,
                     ldw, k_split, dst);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err || direct) return err;
  const long long count = (long long)M * N;
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_splits<<<(unsigned)blocks, threads, 0, st>>>(parts, splits, count,
                                                   accumulate, out);
  return (int)cudaGetLastError();
}
