// Causal prefill attention over bf16 q, k and v on Hopper's bf16 tensor
// cores, in the two forms of flash_attention.cu:
//   flash_attention_fwd_bf16       queries and keys both start at 0;
//   flash_attention_chunk_fwd_bf16 a chunk of S queries at a per-row offset
//                                  pos0[b] over the row's whole KV buffer.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (pallas_call at
// :96) at bf16 inputs, the reference's default precision (the Pallas kernel
// widens q, k and v to fp32, sums in fp32 and writes q.dtype), and for the
// chunk form the jnp `chunked_attention` of the reference's
// models/transformer.py in mode "prefill_resume".
//
// Semantics: flash_attention.cu's (GQA, the causal mask, the window of the
// whole-prompt form, the softcap, masked scores -1e30, slots above a row's
// front never read, so a NaN planted there leaves the output bit-identical),
// with q, k, v and out bf16. Every sum is fp32; the output is rounded to
// bf16 once (round to nearest even); a split's partials stay fp32. The
// scale 1/sqrt(D) multiplies the fp32 scores after the product, as in the
// fp32 form (q times the scale is not bf16, so it cannot enter the product).
//
// What bounds it on an H100: the whole prompt at the serve path's shapes
// (B 4, S 128, 40 query heads over 8 KV heads of 128) moves 12.6 MB, 3.8 us
// at 3.35 TB/s, for 0.68 GFLOP of causal products, 0.7 us at the bf16 peak
// of 989 TFLOP/s (1.26 GFLOP as issued here: whole 32-key tiles, S once
// and P V in kPTerms = 2 terms), so bytes bound it; the server's chunk (4
// rows of 16 queries over a 256-slot buffer) moves 2.6 MB (0.8 us). A
// 2048-token prompt issues 65 GFLOP against 50 MB: operations (66 us
// against 15 us).
//
// Design: the fp32 kernel's plan and block (GQA folded, each warp 16 query
// rows of one head, longest query tiles first and paired, the chunk form's
// key ranges with their ordered combine: flash_attention_common.cuh), with
// the tile loop rebuilt for bf16:
//  * Q and each 32-key K/V tile are staged raw, as bf16, by 16-byte
//    cp.async copies (keys past the front zero-filled) into a 3-stage ring,
//    the next two tiles in flight while one is multiplied. Rows are padded
//    by 16 bytes, so the 8 rows an ldmatrix phase reads fall on 8 distinct
//    16-byte bank groups. The bf16 tiles take half the fp32 form's shared
//    memory, so a block takes 8 warps at every head dim.
//  * Fragments come from ldmatrix: Q's as the A operand, K's rows as the
//    B operand of S = Q K^T, V's through ldmatrix.trans as the B operand of
//    O += P V.
//  * S = Q K^T is one mma.sync.m16n8k16 bf16 MMA per 16-deep slice: a bf16
//    product is exact in fp32, against 6 split-TF32 MMAs for the same 16
//    deep in the fp32 form.
//  * P (fp32, from expf) is split in registers into kPTerms = 2 bf16
//    terms, hi + lo, which carry p to within 2^-18 of it; each term is an
//    MMA against exact bf16 V, the small term first
//    (flash_attention_bf16_p_terms() gives the count to the bounds). A
//    third term (hi + mid + lo, all of fp32's 24 bits) was measured on the
//    card: 6 % slower at the serve prompt and 14 % at 2048 tokens, for
//    errors of 0.008 of the kernel tests' tolerance against 0.05 with two
//    (scripts/bf16_variants.py).
//  * The key tiles' range, the cp.async ring's loop and the online softmax
//    step are flash_attention.cu's (flash_attention_common.cuh).
//  * Each 32-deep slice (of D for S, the tile's 32 keys for P V) sums into
//    fresh registers that are then added to the fp32 sums, because the
//    tensor cores' own accumulation truncates.
//  * The masks, the softcap (tanhf and an IEEE division) and the epilogue
//    are the fp32 form's.
// The plan depends on one row's shape (S, Skv, Hq, Hkv, D) and the card's
// SM count, never on B or pos0 (kernels/flash_attention.py::_plan_bf16,
// chunk_attention.py::_plan_bf16), so a row gives the same bits alone and
// in a group. A thread holds up to 255 registers; at D = 256 the kernel
// spills 324 bytes of them (D <= 128: none, or 4 bytes with the softcap).
//
// Not used yet: wgmma, whose 64-row tiles do not fit a block of 16 x G
// query rows of one KV head (G = 5 here). Measured and not taken
// (scripts/bf16_variants.py): a 2-deep ring, the same time. Without the
// P V products the whole prompt at 2048 tokens took 0.46 ms on the card
// (0.58 with P V in three terms in that run; 0.51 with two in the next):
// the products of S, the online softmax and the 32-key tiles' barriers
// set its pace there, not P V.
#include "bf16_mma.cuh"
#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStagesBf16 = 3;    // cp.async ring depth
constexpr int kPTerms = 2;        // bf16 terms of P in O += P V

template <int D>
struct SmemBf16 {
  static constexpr int kLd = D + 8;          // bf16 a row: 16 bytes of padding
  static constexpr int kTile = kBKV * kLd;   // one K or V tile
  static constexpr int kStage = 2 * kTile;
  // the tiles, or the combine's (m, weights, l) of every range and row and
  // each row's denominator (flash_attention_common.cuh), whichever is more
  static constexpr int bytes(int warps) {
    const int tiles = (warps * 16 * kLd + kStagesBf16 * kStage) * 2;
    const int combine = warps * 16 * (2 * kMaxRanges + 1) * 4;
    return tiles > combine ? tiles : combine;
  }
};

// One query tile (qt) of one key range (rg) of KV head h, head group hg,
// batch row b: the tile loop, then finish_tile. kCap: the kept scores take
// the softcap.
template <int D, bool kCap>
__device__ __forceinline__ void query_tile(const Params& p,
                                           unsigned char* smem, int& is_last,
                                           int qt, int rg, int h, int hg,
                                           int b) {
  using L = SmemBf16<D>;
  constexpr int LD = L::kLd, C8 = D / 8, NT = D / 8;
  const int warps = blockDim.x >> 5;
  const int rows = warps * 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + rows * LD;

  TileKeys tk;
  if (!tile_keys(p, qt, rg, h, hg, b, warp, tk)) return;
  const int q0 = tk.q0, front = tk.front;

  // Q of every pair (rows past S or heads past G zero-fill): first group
  for (int e = tid; e < rows * C8; e += blockDim.x) {
    const int row = e / C8, c = e % C8, w = row >> 4;
    const int jj = hg * p.hb + w / p.qsub;
    const int qr = q0 + (w % p.qsub) * 16 + (row & 15);
    const bool ok = jj < p.G && qr < p.S;
    const bf16* src = static_cast<const bf16*>(p.q) +
                      (((long long)b * p.S + qr) * p.Hq + h * p.G + jj) * D + c * 8;
    cp_async16(Qs + row * LD + c * 8, ok ? src : p.q, ok ? 16 : 0);
  }
  const long long slot_stride = (long long)p.Hkv * D;
  const long long base = ((long long)b * p.Skv * p.Hkv + h) * D;
  auto load_tile = [&](int st, int tile) {
    bf16* Ks = ring + st * L::kStage;
    for (int e = tid; e < 2 * kBKV * C8; e += blockDim.x) {
      const bool isv = e >= kBKV * C8;
      const int e2 = isv ? e - kBKV * C8 : e;
      const int key = e2 / C8, c = e2 % C8;
      const int kp = tile * kBKV + key;
      const bool ok = kp <= front;              // zero-fill past the front
      const bf16* src = static_cast<const bf16*>(isv ? p.v : p.k) + base +
                        kp * slot_stride + c * 8;
      cp_async16(Ks + (isv ? L::kTile : 0) + key * LD + c * 8,
                 ok ? src : p.k, ok ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int qp0 = tk.p0 + tk.r0 + g;            // position of row g
  // ldmatrix row addresses: lane l names row l % 16 of the A tile (Q) at
  // column 8 (l / 16); row 8 (l / 16) + l % 8 of the B tile (K) at column
  // 8 ((l / 8) % 2); row l % 16 of V (transposed) at column 8 (l / 16)
  const bf16* Qa = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LD + (lane >> 4) * 8;

  key_loop<kStagesBf16>(tk, load_tile, [&](int st, int tile) {
    const bf16* Ks = ring + st * L::kStage;
    const bf16* Vs = Ks + L::kTile;
    const int kt0 = tile * kBKV;

    // S = Q K^T, a 16-deep slice an MMA, 32 deep in fresh registers
    float s[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jn][c] = 0.f;
#pragma unroll
    for (int dc = 0; dc < D; dc += 32) {
      float part[4][4];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[jn][c] = 0.f;
#pragma unroll
      for (int kk = dc; kk < dc + 32; kk += 16) {
        uint32_t a[4], k01[4], k23[4];
        ldsm_x4(a, Qa + kk);
        ldsm_x4(k01, Ks + k_off + kk);            // keys 0-15
        ldsm_x4(k23, Ks + k_off + 16 * LD + kk);  // keys 16-31
        mma_bf16(part[0], a, k01[0], k01[1]);
        mma_bf16(part[1], a, k01[2], k01[3]);
        mma_bf16(part[2], a, k23[0], k23[1]);
        mma_bf16(part[3], a, k23[2], k23[3]);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[jn][c] += part[jn][c];
    }

    // mask, then the online softmax of rows g (c = 0, 1) and g + 8 (2, 3)
    softmax_step<NT, kCap>(p, s, acc, kt0, qp0, t, m0, l0, m1, l1);

    // O += P V: P's A fragment of keys 16 ks .. 16 ks + 15 is the S
    // accumulator of key groups 2 ks and 2 ks + 1, in kPTerms bf16 terms
    uint32_t pt[2][4][kPTerms];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      split_bf16(s[2 * ks][0], s[2 * ks][1], pt[ks][0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], pt[ks][1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], pt[ks][2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], pt[ks][3]);
    }
#pragma unroll
    for (int dg = 0; dg < NT; dg += 4) {
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // columns 8 dg .. 8 dg + 15, then 8 dg + 16 .. 8 dg + 31
        uint32_t v01[4], v23[4];
        ldsm_x4_t(v01, Vs + v_off + 16 * ks * LD + dg * 8);
        ldsm_x4_t(v23, Vs + v_off + 16 * ks * LD + dg * 8 + 16);
        const uint32_t b0[4] = {v01[0], v01[2], v23[0], v23[2]};
        const uint32_t b1[4] = {v01[1], v01[3], v23[1], v23[3]};
#pragma unroll
        for (int e = kPTerms - 1; e >= 0; --e) {     // the small terms first
          const uint32_t a[4] = {pt[ks][0][e], pt[ks][1][e], pt[ks][2][e],
                                 pt[ks][3][e]};
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(part[n], a, b0[n], b1[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[dg + n][c] += part[n][c];
    }
  });
  finish_tile<D, bf16>(p, reinterpret_cast<float*>(smem), is_last, acc, m0,
                       l0, m1, l1, tk.active, qt, rg, h, hg, b, q0, tk.r0,
                       tk.hq, tk.r_lo, tk.r_hi);
}

// grid and query-tile order as flash_attention.cu's prefill_attention
template <int D, bool kCap>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
prefill_attention_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int xq = (int)blockIdx.x / p.ranges, rg = blockIdx.x % p.ranges;
  const int h = blockIdx.y / p.groups, hg = blockIdx.y % p.groups;
  const int qt = p.q_tiles - 1 - xq;
  const int jobs = p.pair && xq < qt ? 2 : 1;
#pragma unroll 1
  for (int job = 0; job < jobs; ++job) {   // one copy of the tile's code
    if (job) __syncthreads();              // Q and the ring are free again
    query_tile<D, kCap>(p, smem, is_last, job ? xq : qt, rg, h, hg,
                        blockIdx.z);
  }
}

template <int D, bool kCap>
int launch_d(const Params& p, int B, int warps, cudaStream_t st) {
  const int smem = SmemBf16<D>::bytes(warps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static unsigned long long ready = 0;   // the shared-memory opt-in, once
  int dev = 0;                           // per device
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_attention_bf16<D, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready |= bit;
  }
  dim3 grid(p.pair ? (p.q_tiles + 1) / 2 : p.q_tiles * p.ranges,
            p.Hkv * p.groups, B);
  prefill_attention_bf16<D, kCap><<<grid, warps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch(Params p, int B, int D, long long parts_floats, long long count_ints,
           cudaStream_t st) {
  const int err = prepare(p, B, D, parts_floats, count_ints);
  if (err) return err;
  const int warps = p.hb * p.qsub;
  const bool cap = p.softcap > 0.f;
  switch (D) {
    case 32: return cap ? launch_d<32, true>(p, B, warps, st)
                        : launch_d<32, false>(p, B, warps, st);
    case 64: return cap ? launch_d<64, true>(p, B, warps, st)
                        : launch_d<64, false>(p, B, warps, st);
    case 128: return cap ? launch_d<128, true>(p, B, warps, st)
                         : launch_d<128, false>(p, B, warps, st);
    case 256:  // the whole-prompt form only
      if (p.split || p.pos0) return (int)cudaErrorInvalidValue;
      return cap ? launch_d<256, true>(p, B, warps, st)
                 : launch_d<256, false>(p, B, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The whole-prompt form over bf16: q (B, S, Hq, D), k and v (B, S, Hkv, D),
// out (B, S, Hq, D), all bf16 and 16-byte aligned; hb heads of a KV head and
// qsub 16-row sub-tiles per block (hb * qsub <= 8); pair != 0 gives a block
// two query tiles; softcap > 0 caps the kept scaled scores (0: no cap).
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, int B, int S,
                                        int Hq, int Hkv, int D, float scale,
                                        float softcap, int window, int hb,
                                        int qsub, int pair, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return launch(make_params(q, k, v, nullptr, out, S, S, Hq, Hkv, scale,
                            softcap, window, hb, qsub, 0, pair),
                B, D, 0, 0, (cudaStream_t)stream);
}

// The chunked form over bf16: q (B, S, Hq, D) at positions pos0[b] + i,
// k and v (B, Skv, Hkv, D), out as q; pos0, split, parts and counts as in
// flash_attention_chunk_fwd (the partials stay fp32). Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_chunk_fwd_bf16(
    const void* q, const void* k, const void* v, const int* pos0, void* out,
    float* parts, long long parts_floats, int* counts, long long count_ints,
    int B, int S, int Skv, int Hq, int Hkv, int D, float scale, float softcap,
    int hb, int qsub, int split, void* stream) {
  Params p = make_params(q, k, v, pos0, out, S, Skv, Hq, Hkv, scale, softcap,
                         0, hb, qsub, split, 0);
  p.parts = parts;
  p.counts = counts;
  return launch(p, B, D, parts_floats, count_ints, (cudaStream_t)stream);
}

// The number of bf16 terms P takes in O += P V: the MMAs the kernels issue
// for a key tile are (1 + kPTerms) x those of one product
extern "C" int flash_attention_bf16_p_terms() { return kPTerms; }
