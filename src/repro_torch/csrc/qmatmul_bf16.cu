// Gathered quantized matmul with bf16 x and a bf16 fp tier, built as a
// library of its own: kernel A is qmatmul.cu's at x = bf16 (its template
// instances, QMATMUL_BF16 defined), kernel B a kernel of its own on the bf16
// tensor cores.
//
// Replaces: src/repro/kernels/qmatmul.py::_qmm_kernel at bf16 inputs (the
// reference's default precision; the Pallas kernel widens x and the bank to
// fp32 and writes fp32), in the gathered form the M2Cache FFN needs.
//
// Semantics: qmatmul.cu's (col and row forms over neuron-major banks, per-row
// active sets, split K summed in split order, out fp32), with x (or h) bf16
// and precision 0 the bf16 fp tier.
//
// What bounds it on an H100: at small M (kernel A) the active rows' bytes;
// at large M (kernel B) the products: one layer's FFN at x (512, 5120) over
// 4147 of 13824 neurons is 65 GFLOP, 66 us at the bf16 peak of 989 TFLOP/s,
// against 76 MB of bytes (23 us). The int tiers' row form issues its
// products kRowTerms = 3 times (below): 98 GFLOP are issued, 103 with the
// tiles' padding.
//
// Design: kernel A is qmatmul.cu's, and so are the entry's checks and the
// splits' sum (its gathered<bf16>, through the dispatch specialised below);
// kernel B (`qmm_mma_bf16`, M > 4 per row: kernels/qmatmul.py::_plan, the
// fp32 form's tile rows, K split and grid) is this:
//  * Tiles of BM = 16 or 64 rows by 64 outputs by 64 deep come through a
//    3-stage cp.async ring of 16-byte copies, two tiles in flight while
//    one is multiplied: x as raw bf16 and the gathered weight rows as their
//    raw bytes (bf16, int8, packed int4; rows not 16-byte aligned, odd
//    compact widths, take element-wise loads). x rows need no alignment:
//    each row copies the aligned 16-byte units that cover its 64 values,
//    and the fragments read them at the row's offset in its first unit.
//    A thread's copies are the same units of the same rows at every tile,
//    so their addresses are worked out once a block: worked out for each
//    copy, they took more issue slots than the MMAs (the layer's FFN took
//    1.24 ms on the card that way, 0.94 ms this way). The 64-deep tile (the
//    fp32 form's is 32) halves the barriers, loop steps and fresh-register
//    sums a product pays for; shared rows are padded so that ldmatrix hits
//    each bank once.
//  * Products run as mma.sync.m16n8k16 bf16 MMAs with fp32 sums. Fragments
//    of aligned bf16 tiles come from ldmatrix (.trans for the row form's
//    k-major weight tile); int8 and int4 weights are widened to bf16 (every
//    value exact) as their fragments are built.
//  * The col forms, and the fp tier's row form, multiply bf16 by bf16 or
//    int: every product is exact in fp32, one MMA per 16 deep (the fp32
//    form's split TF32 issued 3 for the fp tier's 8). The int tiers' row
//    form multiplies by h times the row's scale, which is not bf16: it is
//    split in registers into kRowTerms = 3 bf16 terms (hi + mid + lo carry
//    fp32's 24 bits), each an MMA against the exact int weights, small
//    terms first (qmm_bf16_row_terms() gives the count to the bounds). On the card these rows took 0.123 (int8) and 0.230 ms (int4)
//    at x (512, 5120), against 0.146 and 0.280 for the fp32 form's two
//    TF32 MMAs per 8 deep; two bf16 terms (2^-18 of each value lost) took
//    0.114 and 0.204, with no gain on the layer's FFN beyond the run's
//    noise, so the three exact terms stay.
//  * Each 64-deep tile (4 MMAs chained) sums into fresh registers that are
//    then added to the fp32 sums (the tensor cores' own accumulation
//    truncates: 4 chained MMAs lose at most ~4 units of 2^-23); the col
//    form's per-output scale is applied in the epilogue. Tier widths (38,
//    78, 1037, 2073, ...) are not tile multiples: every edge is masked
//    (cp.async zero-fills). The split's partials are summed by qmatmul.cu's
//    sum_splits in split order: no atomics, every result deterministic.
// Measured and not taken (scripts/bf16_variants.py): two blocks an SM with
// more registers, 128-deep tiles and a 4-deep ring were each slower on the
// layer's FFN (1.02, 1.09, 1.07 ms against 0.96 in one run); blocks of 128
// rows by 128 outputs on 8 warps (one an SM, K split to fill a wave) gained
// nothing (1.20 against 1.22 ms in one run, 1.27 against 1.24 in another,
// before the copies' addresses were worked out once), their int tiers'
// row form spilling registers. What sets the FFN's pace: the copies alone (MMAs dropped) take 0.61 ms of its
// 0.94, the fragments and MMAs alone (copies dropped) 0.75; every 64 x 64
// tile reads its x rows and weight rows again from L2 (174 MB for one
// gate product at M = 512, ~4 TB/s).
#define QMATMUL_BF16
#include "qmatmul.cu"
#include "bf16_mma.cuh"

namespace {

constexpr int kBKB = 64;          // kernel B's k tile (bf16): 4 MMAs deep
constexpr int kALdB = 88;         // an x row in shared memory (bf16): 64
                                  // values at an offset < 8, 176 bytes a row
                                  // so that ldmatrix hits each bank once

constexpr int kStagesB = 3;       // kernel B's cp.async ring depth (bf16)
constexpr int kRowTerms = 3;      // bf16 terms of h x scale (int tiers' row form)

template <int BM, int PREC, int LAYOUT>
struct MmaSmemBf16 {
  static constexpr int kA = BM * kALdB * 2;
  // col: a row of kBKB k; row: a row of 64 outputs; raw bytes, 16 padding
  static constexpr int kBRowBytes =
      (LAYOUT == kCol ? kBKB : kBN) * (PREC == kBf16 ? 4 : PREC == kInt8 ? 2 : 1)
      / 2 + 16;
  static_assert(BM * kBKB / 8 >= kMmaThreads, "an x unit for every thread");
  static constexpr int kBRows = LAYOUT == kCol ? kBN : kBKB;
  static constexpr int kStage = kA + kBRows * kBRowBytes;
  static constexpr int kRowInfo =
      LAYOUT == kRow ? kMmaRowSpan * (is_int<PREC>() ? 8 : 4) : 0;
  static constexpr int kTotal = kStagesB * kStage + kRowInfo;
};

// values e and e + 1 of a bf16 row in shared memory (any e) as one word
__device__ __forceinline__ uint32_t lds_pair(const bf16* row, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (e >> 1);
  return (e & 1) ? __byte_perm(w[0], w[1], 0x5432) : w[0];
}

// two ints (the lower k first) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t int_pair(int a, int b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)a, (float)b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// grid (ceil(N / BN), ceil(M / BM), R * splits); vec_x: x's row starts
// 16-byte aligned at every tile (x aligned, K % 8 == 0), so its fragments
// come from ldmatrix
template <int BM, int PREC, int LAYOUT>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
qmm_mma_bf16(const bf16* __restrict__ x, const char* __restrict__ w,
             const float* __restrict__ scale, const int* __restrict__ idx,
             int M, int N, int K, long long ldw, int k_split, int splits,
             int vec_x, int vec_w, int accumulate, float* __restrict__ out,
             float* __restrict__ parts) {
  using S = MmaSmemBf16<BM, PREC, LAYOUT>;
  constexpr int RB = S::kBRowBytes;
  constexpr int WARPS_M = BM == 16 ? 1 : 2;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WTM = BM / WARPS_M, WTN = kBN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;          // NT: 2 or 4, even
  constexpr int BPE2 = PREC == kBf16 ? 4 : PREC == kInt8 ? 2 : 1;  // 2 x bytes a value
  constexpr int UE = 32 / BPE2;                                  // values a 16 bytes
  // A times a per-contraction scale (the int tiers' row form): kRowTerms terms
  constexpr bool kSplitA = LAYOUT == kRow && is_int<PREC>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int col_id[kBN];
  __shared__ int a_off[BM];               // each x row's offset in its first unit

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int row = blockIdx.z / splits;
  const int kbeg = (blockIdx.z % splits) * k_split;
  const int kend = min(K, kbeg + k_split);
  x += (long long)row * M * K;
  if (idx) idx += (long long)row * (LAYOUT == kCol ? N : K);
  int* row_id = reinterpret_cast<int*>(smem + kStagesB * S::kStage);
  float* row_sc = reinterpret_cast<float*>(row_id + kMmaRowSpan);
  if (LAYOUT == kCol && tid < kBN) {
    const int n = n0 + tid;
    col_id[tid] = n < N ? (idx ? idx[n] : n) : -1;
  }
  if (LAYOUT == kRow) {                   // up to the last tile's end
    const int span = (kend - kbeg + kBKB - 1) / kBKB * kBKB;
    for (int i = tid; i < span; i += kMmaThreads) {
      const bool ok = i < kend - kbeg;
      const int r = ok ? (idx ? idx[kbeg + i] : kbeg + i) : 0;
      row_id[i] = r;
      if (is_int<PREC>()) row_sc[i] = (ok && scale) ? scale[r] : 1.f;
    }
  }
  // a tile's k0 moves by kBKB values (a multiple of 8) and a split starts
  // at a multiple of 32, so a row's offset in its first 16-byte unit is the
  // same at every tile
  for (int mm = tid; mm < BM; mm += kMmaThreads)
    a_off[mm] = (int)((reinterpret_cast<unsigned long long>(
                          x + (long long)min(m0 + mm, M - 1) * K + kbeg) >> 1) & 7);
  __syncthreads();

  // each thread's copies, the same at every tile (their addresses worked
  // out once): x, unit au = tid % kAU of rows tid / kAU + 128 / kAU i, and
  // unit kAU of row tid where that row sits at an offset; the weights, unit
  // bu = tid % kBUnits of rows (col: outputs; row: k) tid / kBUnits +
  // 128 / kBUnits i
  constexpr int kAU = kBKB / 8;                              // units a row
  constexpr int kAItems = BM * kAU / kMmaThreads;
  constexpr int kBUnits = (LAYOUT == kCol ? kBKB : kBN) * BPE2 / 2 / 16;
  constexpr int kBItems =
      (LAYOUT == kCol ? kBN : kBKB) * kBUnits / kMmaThreads;
  const int au = tid % kAU, bu = tid % kBUnits;
  int a_e[kAItems], a_c[kAItems];       // the unit's first value at kbeg,
#pragma unroll                          // its column less k0 (K: no row)
  for (int i = 0; i < kAItems; ++i) {
    const int mm = tid / kAU + kMmaThreads / kAU * i, off = a_off[mm];
    a_e[i] = min(m0 + mm, M - 1) * K + kbeg - off + 8 * au;
    a_c[i] = m0 + mm < M ? 8 * au - off : K;
  }
  const bool a_x = tid < BM && m0 + tid < M && a_off[tid % BM];
  const int a_xe =
      min(m0 + tid % BM, M - 1) * K + kbeg - a_off[tid % BM] + kBKB;
  const int a_xc = kBKB - a_off[tid % BM];
  int b_r[kBItems];                     // col: the output's bank row (-1: none)
#pragma unroll
  for (int i = 0; i < kBItems; ++i)
    b_r[i] = LAYOUT == kCol ? col_id[tid / kBUnits + kMmaThreads / kBUnits * i]
                            : 0;
  // row: the unit's outputs past N are zero-filled
  const int b_ce = n0 + bu * UE;
  const int b_bytes = max(0, min(UE, N - b_ce)) * BPE2 / 2;

  auto load_tile = [&](int st, int k0) {
    unsigned char* base = smem + st * S::kStage;
    bf16* As = reinterpret_cast<bf16*>(base);
    unsigned char* Bs = base + S::kA;
    // x: the aligned units covering values k0 .. k0 + kBKB - 1 of each row
    // (kAU + 1 of them at an offset, kAU without); values at or past kend
    // zero-fill
#pragma unroll
    for (int i = 0; i < kAItems; ++i) {
      const int n_ok = max(0, min(8, kend - k0 - a_c[i]));
      cp_async16(As + (tid / kAU + kMmaThreads / kAU * i) * kALdB + 8 * au,
                 n_ok ? x + a_e[i] + (k0 - kbeg) : x, 2 * n_ok);
    }
    if (a_x) {
      const int n_ok = max(0, min(8, kend - k0 - a_xc));
      cp_async16(As + tid * kALdB + kBKB, n_ok ? x + a_xe + (k0 - kbeg) : x,
                 2 * n_ok);
    }
    if (LAYOUT == kCol) {
      constexpr int kRowBytes = kBKB * BPE2 / 2;         // 128, 64, 32
      if (vec_w) {
        const int ke = k0 + bu * UE;
        const int bytes = max(0, min(UE, kend - ke)) * BPE2 / 2;
#pragma unroll
        for (int i = 0; i < kBItems; ++i) {
          const int nn = tid / kBUnits + kMmaThreads / kBUnits * i;
          const bool ok = b_r[i] >= 0 && bytes;
          cp_async16(Bs + nn * RB + bu * 16,
                     ok ? w + (long long)b_r[i] * ldw + (long long)ke * BPE2 / 2
                        : w, ok ? bytes : 0);
        }
      } else if (PREC == kBf16) {
        for (int e = tid; e < kBN * kBKB; e += kMmaThreads) {
          const int nn = e / kBKB, kk = e % kBKB;
          const int r = col_id[nn], k = k0 + kk;
          reinterpret_cast<unsigned short*>(Bs + nn * RB)[kk] =
              (r >= 0 && k < kend)
                  ? __ldg(reinterpret_cast<const unsigned short*>(
                        w + (long long)r * ldw) + k)
                  : (unsigned short)0;
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
      constexpr int kRowBytes = kBN * BPE2 / 2;          // 128, 64, 32
      if (vec_w) {
#pragma unroll
        for (int i = 0; i < kBItems; ++i) {
          const int kk = tid / kBUnits + kMmaThreads / kBUnits * i;
          const int j = k0 + kk;
          const bool ok = j < kend && b_bytes;
          const long long r = ok ? row_id[j - kbeg] : 0;
          cp_async16(Bs + kk * RB + bu * 16,
                     ok ? w + r * ldw + (long long)b_ce * BPE2 / 2 : w,
                     ok ? b_bytes : 0);
        }
      } else if (PREC == kBf16) {
        for (int e = tid; e < kBKB * kBN; e += kMmaThreads) {
          const int kk = e / kBN, nn = e % kBN;
          const int j = k0 + kk, c = n0 + nn;
          const bool ok = j < kend && c < N;
          const long long r = ok ? row_id[j - kbeg] : 0;
          reinterpret_cast<unsigned short*>(Bs + kk * RB)[nn] = ok
              ? __ldg(reinterpret_cast<const unsigned short*>(w + r * ldw) + c)
              : (unsigned short)0;
        }
      } else {
        for (int e = tid; e < kBKB * kRowBytes; e += kMmaThreads) {
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

  // this lane's fragment rows g and g + 8 of each 16-row tile: their
  // offsets, and the ldmatrix row address of lane l (row l % 16, column
  // 8 (l / 16); B col: row 8 (l / 16) + l % 8 at column 8 ((l / 8) % 2))
  int off[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    off[i][0] = a_off[wm * WTM + i * 16 + g];
    off[i][1] = a_off[wm * WTM + i * 16 + g + 8];
  }
  const int a_ldsm = (lane & 15) * kALdB + (lane >> 4) * 8;
  const int bc_ldsm = ((lane >> 4) * 8 + (lane & 7)) * RB +
                      ((lane >> 3) & 1) * 16;
  const int br_ldsm = (lane & 15) * RB + (lane >> 4) * 16;

  auto compute = [&](int st, int k0) {
    const unsigned char* base = smem + st * S::kStage;
    const bf16* As = reinterpret_cast<const bf16*>(base);
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
    for (int kk = 0; kk < kBKB; kk += 16) {
      // A: a0 (row g, k 2t, 2t + 1), a1 (row g + 8), a2, a3 (k + 8)
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* r0 = As + (wm * WTM + i * 16 + g) * kALdB;
        if (vec_x) {
          ldsm_x4(a[i], As + (wm * WTM + i * 16) * kALdB + a_ldsm + kk);
        } else {
          a[i][0] = lds_pair(r0, off[i][0] + kk + 2 * t);
          a[i][1] = lds_pair(r0 + 8 * kALdB, off[i][1] + kk + 2 * t);
          a[i][2] = lds_pair(r0, off[i][0] + kk + 8 + 2 * t);
          a[i][3] = lds_pair(r0 + 8 * kALdB, off[i][1] + kk + 8 + 2 * t);
        }
      }
      // B: b0 (k 2t, 2t + 1; n g), b1 (k + 8) of each 8-output tile
      uint32_t b[NT][2];
      if (PREC == kBf16) {
#pragma unroll
        for (int jn = 0; jn < NT; jn += 2) {
          uint32_t r[4];
          if (LAYOUT == kCol)
            ldsm_x4(r, Bs + (wn * WTN + jn * 8) * RB + bc_ldsm + 2 * kk);
          else
            ldsm_x4_t(r, Bs + kk * RB + br_ldsm + 2 * (wn * WTN + jn * 8));
          b[jn][0] = r[0];
          b[jn][1] = r[1];
          b[jn + 1][0] = r[2];
          b[jn + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int nc = wn * WTN + jn * 8 + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = kk + 8 * h + 2 * t;
            int v0, v1;
            if (LAYOUT == kCol) {
              const unsigned char* r = Bs + nc * RB;
              if (PREC == kInt8) {
                const unsigned short u = *reinterpret_cast<const unsigned short*>(r + k);
                v0 = byte_at(u, 0);
                v1 = byte_at(u, 1);
              } else {
                const unsigned u = r[k >> 1];
                v0 = nibble_at(u, 0);
                v1 = nibble_at(u, 1);
              }
            } else if (PREC == kInt8) {
              v0 = (signed char)Bs[k * RB + nc];
              v1 = (signed char)Bs[(k + 1) * RB + nc];
            } else {
              v0 = nibble_at(Bs[k * RB + (nc >> 1)], nc & 1);
              v1 = nibble_at(Bs[(k + 1) * RB + (nc >> 1)], nc & 1);
            }
            b[jn][h] = int_pair(v0, v1);
          }
        }
      }
      if (kSplitA) {
        // h times the rows' scales, in kRowTerms bf16 terms, the small first
        uint32_t ht[MT][4][kRowTerms];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = bf2(a[i][q]);
            const int k = kk + (q >> 1) * 8 + 2 * t;
            split_bf16(v.x * rs[k], v.y * rs[k + 1], ht[i][q]);
          }
#pragma unroll
        for (int e = kRowTerms - 1; e >= 0; --e)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint32_t ae[4] = {ht[i][0][e], ht[i][1][e], ht[i][2][e],
                                    ht[i][3][e]};
#pragma unroll
            for (int jn = 0; jn < NT; ++jn)
              mma_bf16(part[i][jn], ae, b[jn][0], b[jn][1]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jn = 0; jn < NT; ++jn)
            mma_bf16(part[i][jn], a[i], b[jn][0], b[jn][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jn][q] += part[i][jn][q];
  };

  const int ktiles = (kend - kbeg + kBKB - 1) / kBKB;
#pragma unroll
  for (int s = 0; s < kStagesB - 1; ++s) {
    if (s < ktiles) load_tile(s, kbeg + s * kBKB);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStagesB - 2>();
    __syncthreads();                       // stage kt landed; kt-1 is free
    const int nt = kt + kStagesB - 1;
    if (nt < ktiles) load_tile(nt % kStagesB, kbeg + nt * kBKB);
    cp_async_commit();
    compute(kt % kStagesB, kbeg + kt * kBKB);
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

template <int BM, int PREC, int LAYOUT>
int launch_mma_bf16(const Args& a) {
  using S = MmaSmemBf16<BM, PREC, LAYOUT>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_mma_bf16<BM, PREC, LAYOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::kTotal);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + BM - 1) / BM, a.R * a.splits);
  qmm_mma_bf16<BM, PREC, LAYOUT><<<grid, kMmaThreads, S::kTotal, a.st>>>(
      static_cast<const bf16*>(a.x), a.w, a.scale, a.idx, a.M, a.N, a.K,
      a.ldw, a.k_split, a.splits, a.vec_x, a.vec_w, a.accumulate, a.out,
      a.parts);
  return 0;
}

template <int PREC>
int dispatch_bf16(int layout, int kernel, int tile, const Args& a) {
  if (kernel == 0) {
    switch (tile) {
      case 1: return launch_gemv<PREC, 1, bf16>(layout, a);
      case 4: return launch_gemv<PREC, 4, bf16>(layout, a);
      case 8: return launch_gemv<PREC, 8, bf16>(layout, a);
      case 16: return launch_gemv<PREC, 16, bf16>(layout, a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (tile == 16)
    return layout == kCol ? launch_mma_bf16<16, PREC, kCol>(a)
                          : launch_mma_bf16<16, PREC, kRow>(a);
  if (tile == 64)
    return layout == kCol ? launch_mma_bf16<64, PREC, kCol>(a)
                          : launch_mma_bf16<64, PREC, kRow>(a);
  return (int)cudaErrorInvalidValue;
}

// qmatmul.cu's gathered<bf16> (the checks, the launch, the splits' sum)
// launches through these: kernel A's bf16 instances and this kernel B
template <>
int dispatch<kBf16, bf16>(int layout, int kernel, int tile, const Args& a) {
  return dispatch_bf16<kBf16>(layout, kernel, tile, a);
}
template <>
int dispatch<kInt8, bf16>(int layout, int kernel, int tile, const Args& a) {
  return dispatch_bf16<kInt8>(layout, kernel, tile, a);
}
template <>
int dispatch<kInt4, bf16>(int layout, int kernel, int tile, const Args& a) {
  return dispatch_bf16<kInt4>(layout, kernel, tile, a);
}

}  // namespace

// qmm_gathered's arguments and checks (qmatmul.cu) with x bf16; precision 0
// is then the bf16 fp tier (w bf16 rows), 1 and 2 the int8 and int4 banks;
// out stays fp32. Kernel B takes any x whose base is 16-byte aligned (its
// rows copy the aligned units around them); vec_x there means its rows are
// aligned too (K % 8 == 0).
extern "C" int qmm_gathered_bf16(const void* x, const void* w,
                                 const float* scale, const int* idx, int R,
                                 int M, int N, int K, long long ldw,
                                 int precision, int layout, int kernel,
                                 int tile, int splits, int k_split, int vec_x,
                                 int vec_w, int accumulate, float* out,
                                 float* parts, void* stream) {
  if (kernel == 1 && reinterpret_cast<unsigned long long>(x) % 16)
    return (int)cudaErrorInvalidValue;
  return gathered<bf16>(x, w, scale, idx, R, M, N, K, ldw, precision, layout,
                        kernel, tile, splits, k_split,
                        kernel == 1 ? (int)(vec_x && K % 8 == 0) : vec_x,
                        vec_w, accumulate, out, parts, stream);
}

// The number of bf16 terms h x scale takes in kernel B's int tiers' row
// form: those products issue kRowTerms x the MMAs of one
extern "C" int qmm_bf16_row_terms() { return kRowTerms; }
