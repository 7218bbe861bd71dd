// Gathered quantized matmul with bf16 x and a bf16 fp tier, built as a
// library of its own: kernel A is qmatmul.cu's at x = bf16 (its template
// instances, QMATMUL_BF16 defined), kernel B a kernel of its own on the bf16
// tensor cores, and the FFN's small-M form (M <= 4 a row) three kernels of
// its own: the gate and up products with the activation, every tier in one
// launch (`qmm_glu_bf16`), the down products' partial sums (kernel A's row
// form), and one fixed-order sum of every tier's partials into the bf16
// output (`qmm_down_sum_bf16`).
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
// The fused GLU (`qmm_glu_kernel`, below; M <= 4 a row): one launch for the
// three tiers, the fp tier's blocks first, then int8's and int4's (a
// launch a tier took 29.1 us of device time a layer's FFN at M = 1, each
// with its own ramp, staging and tail). In a tier, a warp takes one
// active neuron, its gate row and its up row together (kernel A's col form
// gave a warp two neurons of one product: 65 blocks of 8 warps at 1037
// neurons, half the card idle; here 130 blocks, one an SM), a lane reading
// 16-byte units lane, lane + 32, ... of both rows, kGluUnroll (2) units of
// each in flight and as many more loading while these are summed (4 took
// 24.9 us a layer's FFN at M = 1, 2 19.4: fewer registers, more blocks an
// SM; scripts/bf16_variants.py `glu:unroll*`). The first units are
// issued before x is staged (kernel A's col form staged x by scalar loads,
// widened one at a time, before any weight load), and x is read in 16-byte
// units of 8 values. The int tiers' values become fp32 by the exponent
// trick (a byte or nibble, offset to unsigned, under the exponent of 2^23,
// less 2^23 + offset: exact; no I2F). What bounds the int tiers is their
// weight loads, not the conversion (scripts/bf16_variants.py: no faster
// without it, `glu:no_convert`; twice as fast with no weight byte read,
// `glu:no_weights`). Each lane's sums run over the same units in the
// same order as the col form's, and the warp reduces them with the same
// shuffles, so gate and up are its products bit for bit. The epilogue
// rounds each product to bf16 and applies the activation with every op
// rounded to bf16, as models/common's _silu and _gelu_tanh and F.relu
// compute it at bf16 (expf, tanhf and IEEE division, as PyTorch's own
// kernels), so h equals activation(gate.to(bf16)) * up.to(bf16) bit for
// bit; h is written in bf16 for the down product. That composition took 29
// elementwise launches a layer's FFN beside the 6 col launches: 41 kernels
// in all (5 now). The down products (kernel A's row form) write
// their splits' partials into one buffer, and one launch sums every tier's
// in tier and split order, the order in which the per-tier sums added into
// a zeroed fp32 output, and rounds to bf16 once: the same bits, without the
// zeroing, the three per-tier sums and the final cast.
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

// ---------------------------------------------------------------------------
// The small-M FFN: fused GLU, the down products' partials, their sum

enum GluAct { kSilu = 0, kGelu = 1, kRelu = 2 };
constexpr int kGluMaxM = 4;        // rows of M a launch takes (tiles 1, 4)
constexpr int kGluUnroll = 2;      // 16-byte units of each row in flight a lane

// v rounded to bf16 (to nearest, ties to even) and widened back
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the activation of a bf16 value x, every op rounded to bf16 as
// models/common computes it at bf16: silu x * (1 / (1 + exp(-x))) (the
// reciprocal, then its product by 1, exact); gelu's tanh form with its
// constants rounded to bf16 first, x * (0.5 * (1 + tanh(c (x + k x^3))));
// relu max(x, 0), NaN kept
template <int ACT>
__device__ __forceinline__ float act_bf16(float x) {
  if (ACT == kSilu) {
    const float e = rbf(expf(-x));
    const float r = rbf(__fdiv_rn(1.0f, rbf(1.0f + e)));
    return rbf(x * r);
  } else if (ACT == kGelu) {
    const float c = 0.796875f;          // bf16(sqrt(2 / pi))
    const float k = 0.044677734375f;    // bf16(0.044715)
    const float x3 = rbf(rbf(x * x) * x);
    const float t = rbf(c * rbf(x + rbf(k * x3)));
    return rbf(x * rbf(0.5f * rbf(1.0f + rbf(tanhf(t)))));
  } else {
    return x != x ? x : fmaxf(x, 0.f);
  }
}

// value i (0..3) of a word whose bytes were offset to unsigned (b ^ 0x80,
// or a nibble's n ^ 8 in a byte of its own): 2^23 + u as a float's bits,
// less 2^23 + bias, exact
__device__ __forceinline__ float ubyte_f(uint32_t u, int i, float bias) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - bias;
}

// acc[j][m] += one 16-byte unit (k0 .. k0 + E) of row j (gate, up) against
// x[m]: the col form's unit_dot, its products in the same order, the int
// values widened by the exponent trick
template <int PREC, int MAXM>
__device__ __forceinline__ void glu_unit(const uint4 (&v)[kNpw],
                                         const float* xs, int k0, int ldx,
                                         int M, float (&acc)[kNpw][MAXM]) {
  if constexpr (PREC == kBf16) {
    unit_dot<PREC, MAXM>(v, xs, k0, ldx, M, acc);
  } else {
    constexpr int kPerWord = PREC == kInt8 ? 4 : 8;
    constexpr float kBias = PREC == kInt8 ? 8388736.f : 8388616.f;
    // four values of k at a time: each row's as fp32, then their products
    // with every row of x (each sum still over k in order)
#pragma unroll
    for (int q = 0; q < 4 * kPerWord; q += 4) {
      float w[kNpw][4];
#pragma unroll
      for (int j = 0; j < kNpw; ++j) {
        const int wi = q / kPerWord;
        const uint32_t word =
            wi == 0 ? v[j].x : wi == 1 ? v[j].y : wi == 2 ? v[j].z : v[j].w;
        if (PREC == kInt8) {
          const uint32_t u = word ^ 0x80808080u;
#pragma unroll
          for (int i = 0; i < 4; ++i) w[j][i] = ubyte_f(u, i, kBias);
        } else {                           // nibbles q % 8 .. + 3
          const uint32_t u = word ^ 0x88888888u;
          const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
          const int b0 = (q % 8) / 2;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            w[j][2 * i] = ubyte_f(lo, b0 + i, kBias);
            w[j][2 * i + 1] = ubyte_f(hi, b0 + i, kBias);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m >= M) break;
        const float4 a =
            *reinterpret_cast<const float4*>(xs + m * ldx + swz(k0 + q));
#pragma unroll
        for (int j = 0; j < kNpw; ++j) {
          float s = acc[j][m];
          s = fmaf(a.x, w[j][0], s);
          s = fmaf(a.y, w[j][1], s);
          s = fmaf(a.z, w[j][2], s);
          s = fmaf(a.w, w[j][3], s);
          acc[j][m] = s;
        }
      }
    }
  }
}

// x[:, kc:kc+klen] widened into xs (permuted as the col form's): 16-byte
// loads of 8 values where vec_x (K % 8 == 0, x 16-byte aligned)
__device__ __forceinline__ void stage_x_bf16(const bf16* x, float* xs, int M,
                                             int K, int kc, int klen,
                                             int kc_len, int vec_x) {
  if (vec_x) {
    const int q8 = klen / 8;
    for (int i = threadIdx.x; i < M * q8; i += kGemvThreads) {
      const int m = i / q8, kk = (i - m * q8) * 8;
      const uint4 u =
          __ldg(reinterpret_cast<const uint4*>(x + (long long)m * K + kc + kk));
      const float2 a = bf2(u.x), b = bf2(u.y), c = bf2(u.z), d = bf2(u.w);
      float* row = xs + m * kc_len;
      *reinterpret_cast<float4*>(row + swz(kk)) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(row + swz(kk + 4)) =
          make_float4(c.x, c.y, d.x, d.y);
    }
  } else {
    for (int i = threadIdx.x; i < M * klen; i += kGemvThreads) {
      const int m = i / klen, kk = i - m * klen;
      xs[m * kc_len + swz(kk)] = to_f(x[(long long)m * K + kc + kk]);
    }
  }
}

// one tier of the fused GLU: its banks (wg, wu: f rows of K values, ldw
// bytes apart), scales (int tiers), active set idx (R, N) or null, and its
// h (R, M, N) bf16 (gate_out, up_out: the fp32 products, or null)
struct GluTier {
  const char* wg;
  const char* wu;
  const float* sg;
  const float* su;
  const int* idx;
  bf16* h;
  float* gate_out;
  float* up_out;
  long long ldw;
  int N, vec_w, blocks;              // blocks: ceil(N / 8), 0 when empty
};
// the launch: x (R, M, K) bf16 and the fp, int8 and int4 tiers, in order
struct GluArgs {
  const bf16* x;
  GluTier t[3];
  int M, K, kc_len, vec_x;
};

// block blk of one tier (row blockIdx.y): warp w takes neuron 8 blk + w
template <int PREC, int MAXM, int ACT>
__device__ __forceinline__ void glu_block(const GluArgs& a, const GluTier& t,
                                          int blk, float* xs) {
  constexpr int E = Unit<PREC>::kElems;
  const int M = a.M, K = a.K, N = t.N, kc_len = a.kc_len;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.y;
  const bf16* x = a.x + (long long)row * M * K;
  const int* idx = t.idx ? t.idx + (long long)row * N : nullptr;
  const int n = blk * kGemvWarps + warp;
  const bool ok = n < N;                   // uniform across the warp
  const int rid = ok ? (idx ? idx[n] : n) : 0;
  const char* wr[kNpw] = {t.wg + (long long)rid * t.ldw,
                          t.wu + (long long)rid * t.ldw};
  float acc[kNpw][MAXM];
#pragma unroll
  for (int j = 0; j < kNpw; ++j)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[j][m] = 0.f;

  for (int kc = 0; kc < K; kc += kc_len) {
    const int klen = min(kc_len, K - kc);
    __syncthreads();                       // the last chunk's reads are done
    if (t.vec_w) {                         // K % E == 0, rows 16-byte aligned
      const int u0 = kc / E, nu = klen / E;
      uint4 v[kGluUnroll][kNpw];
      auto fetch = [&](int u) {
#pragma unroll
        for (int q = 0; q < kGluUnroll; ++q)
#pragma unroll
          for (int j = 0; j < kNpw; ++j) {
            const int uu = u + 32 * q;
            v[q][j] = (ok && uu < nu)
                ? __ldg(reinterpret_cast<const uint4*>(wr[j]) + u0 + uu)
                : make_uint4(0u, 0u, 0u, 0u);
          }
      };
      fetch(lane);                         // in flight while x is staged
      stage_x_bf16(x, xs, M, K, kc, klen, kc_len, a.vec_x);
      __syncthreads();
      for (int u = lane; u < nu; u += 32 * kGluUnroll) {
        uint4 cur[kGluUnroll][kNpw];
#pragma unroll
        for (int q = 0; q < kGluUnroll; ++q)
#pragma unroll
          for (int j = 0; j < kNpw; ++j) cur[q][j] = v[q][j];
        if (u + 32 * kGluUnroll < nu) fetch(u + 32 * kGluUnroll);
#pragma unroll
        for (int q = 0; q < kGluUnroll; ++q) {
          const int uu = u + 32 * q;
          if (uu < nu) glu_unit<PREC, MAXM>(cur[q], xs, uu * E, kc_len, M, acc);
        }
      }
    } else {
      stage_x_bf16(x, xs, M, K, kc, klen, kc_len, a.vec_x);
      __syncthreads();
      for (int kk = lane; kk < klen; kk += 32) {
        float wv[kNpw];
#pragma unroll
        for (int j = 0; j < kNpw; ++j)
          wv[j] = ok ? load_elem<PREC>(wr[j], kc + kk) : 0.f;
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
  if (lane != 0 || !ok) return;
  const float s0 = (is_int<PREC>() && t.sg) ? t.sg[rid] : 1.f;
  const float s1 = (is_int<PREC>() && t.su) ? t.su[rid] : 1.f;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    const float g = acc[0][m] * s0, u = acc[1][m] * s1;
    const long long o = ((long long)row * M + m) * N + n;
    if (t.gate_out) {
      t.gate_out[o] = g;
      t.up_out[o] = u;
    }
    t.h[o] = __float2bfloat16_rn(act_bf16<ACT>(rbf(g)) * rbf(u));
  }
}

// grid (the tiers' blocks, R): blocks 0 .. of the fp tier, then the int8
// tier's, then the int4 tier's
template <int MAXM, int ACT>
__global__ void __launch_bounds__(kGemvThreads)
qmm_glu_kernel(const GluArgs a) {
  __shared__ __align__(16) float xs[kXsFloats];
  int b = blockIdx.x;
  if (b < a.t[0].blocks) {
    glu_block<kBf16, MAXM, ACT>(a, a.t[0], b, xs);
    return;
  }
  b -= a.t[0].blocks;
  if (b < a.t[1].blocks) {
    glu_block<kInt8, MAXM, ACT>(a, a.t[1], b, xs);
    return;
  }
  glu_block<kInt4, MAXM, ACT>(a, a.t[2], b - a.t[1].blocks, xs);
}

template <int MAXM>
int launch_glu(int act, const GluArgs& a, int R, cudaStream_t st) {
  const dim3 grid(a.t[0].blocks + a.t[1].blocks + a.t[2].blocks, R);
  switch (act) {
    case kSilu:
      qmm_glu_kernel<MAXM, kSilu><<<grid, kGemvThreads, 0, st>>>(a);
      return 0;
    case kGelu:
      qmm_glu_kernel<MAXM, kGelu><<<grid, kGemvThreads, 0, st>>>(a);
      return 0;
    case kRelu:
      qmm_glu_kernel<MAXM, kRelu><<<grid, kGemvThreads, 0, st>>>(a);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// out[r, e] = bf16(sum over the tiers t, in order, of the sum over their
// splits z, in order, of parts_t[r, z, e]), from 0: parts holds the tiers'
// blocks (R, splits_t, count) one after another
__global__ void sum_tiers_bf16(const float* __restrict__ parts, int R,
                               long long count, int s0, int s1, int s2,
                               bf16* __restrict__ out) {
  const long long total = (long long)R * count;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / count, e = i % count;
    float s = 0.f;
    const float* p = parts;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int st = t == 0 ? s0 : t == 1 ? s1 : s2;
      const float* q = p + r * st * count + e;
      for (int z = 0; z < st; ++z) s += q[(long long)z * count];
      p += (long long)R * st * count;
    }
    out[i] = __float2bfloat16_rn(s);
  }
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

// kernel A's row form at bf16 h, every split's partial to a.parts
template <int PREC>
int launch_gemv_row_bf16(int tile, const Args& a) {
  switch (tile) {
    case 1: return launch_gemv<PREC, 1, bf16>(kRow, a);
    case 4: return launch_gemv<PREC, 4, bf16>(kRow, a);
  }
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

// The fused GLU of an FFN's tiers in one launch, small M: x (R, M, K)
// bf16; for tier t = 0, 1, 2 (fp: bf16 rows; int8; int4 packed along K) its
// banks wg[t], wu[t] (rows ldw[t] bytes apart; vec_w[t]: 16-byte aligned),
// per-neuron scales sg[t], su[t] (int tiers), idx[t] (R, N[t]) or null, and
// h[t] (R, M, N[t]) bf16 = act(bf16(gate)) * bf16(up), each op rounded to
// bf16 (act 0 silu, 1 gelu (tanh), 2 relu); gate_out[t], up_out[t] (R, M,
// N[t]) fp32 or null. N[t] = 0 leaves a tier out. tile = M's bound (1 or
// 4), kc_len the K chunk of x staged (kernels/qmatmul._plan's col form).
// Returns a cudaError_t.
extern "C" int qmm_glu_bf16(const void* x, const void* const* wg,
                            const void* const* wu, const float* const* sg,
                            const float* const* su, const int* const* idx,
                            const int* N, const long long* ldw,
                            const int* vec_w, void* const* h,
                            float* const* gate_out, float* const* up_out,
                            int R, int M, int K, int act, int tile,
                            int kc_len, int vec_x, void* stream) {
  if (R < 1 || R > 65535 || M < 1 || M > tile || M > kGluMaxM || K < 1 ||
      kc_len < 32 || kc_len % 32 || (long long)M * kc_len > kXsFloats)
    return (int)cudaErrorInvalidValue;
  GluArgs a{static_cast<const bf16*>(x), {}, M, K, kc_len, vec_x};
  for (int i = 0; i < 3; ++i) {
    if (N[i] < 0 || (gate_out[i] == nullptr) != (up_out[i] == nullptr) ||
        (N[i] > 0 && (!wg[i] || !wu[i] || !h[i])))
      return (int)cudaErrorInvalidValue;
    a.t[i] = GluTier{static_cast<const char*>(wg[i]),
                     static_cast<const char*>(wu[i]), sg[i], su[i], idx[i],
                     static_cast<bf16*>(h[i]), gate_out[i], up_out[i], ldw[i],
                     N[i], vec_w[i], (N[i] + kGemvWarps - 1) / kGemvWarps};
  }
  if (a.t[0].blocks + a.t[1].blocks + a.t[2].blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = tile == 1 ? launch_glu<1>(act, a, R, st)
                : tile == 4 ? launch_glu<4>(act, a, R, st)
                : (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}

// The down product of one tier into its block of partials, small M: kernel
// A's row form with h (R, M, K) bf16 over w's rows idx (R, K) (precision as
// qmm_gathered_bf16's), its `splits` partials (R, splits, M, N) fp32 written
// to parts (one split: the product itself), not summed. Returns a
// cudaError_t.
extern "C" int qmm_down_parts_bf16(const void* h, const void* w,
                                   const float* scale, const int* idx, int R,
                                   int M, int N, int K, long long ldw,
                                   int precision, int tile, int splits,
                                   int k_split, int vec_w, float* parts,
                                   void* stream) {
  if (R < 1 || (long long)R * splits > 65535 || splits < 1 ||
      k_split > kRowIds || (long long)M * k_split > kRowHs || !parts)
    return (int)cudaErrorInvalidValue;
  Args a{h, (const char*)w, scale, idx, R, M, N, K, ldw, k_split, splits,
         0, vec_w, 0, parts, parts, (cudaStream_t)stream};
  const int err =
      precision == kFp ? launch_gemv_row_bf16<kBf16>(tile, a)
      : precision == kInt8 ? launch_gemv_row_bf16<kInt8>(tile, a)
      : precision == kInt4 ? launch_gemv_row_bf16<kInt4>(tile, a)
      : (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}

// out (R, count) bf16 = the tiers' partials summed in tier and split order
// from 0 and rounded once: parts holds (R, s_t, count) fp32 for t = 0, 1, 2
// one after another (s_t = 0: the tier is empty). Returns a cudaError_t.
extern "C" int qmm_down_sum_bf16(const float* parts, int R, long long count,
                                 int s0, int s1, int s2, void* out,
                                 void* stream) {
  if (R < 1 || count < 1 || s0 < 0 || s1 < 0 || s2 < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)R * count;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_tiers_bf16<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      parts, R, count, s0, s1, s2, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// The number of bf16 terms h x scale takes in kernel B's int tiers' row
// form: those products issue kRowTerms x the MMAs of one
extern "C" int qmm_bf16_row_terms() { return kRowTerms; }
