// Causal prefill attention on Hopper's tensor cores, in two forms:
//   flash_attention_fwd       queries and keys both start at position 0
//                             (launch/serve's prefill);
//   flash_attention_chunk_fwd a chunk of S queries at a per-row offset
//                             pos0[b] over the row's whole KV buffer
//                             (launch/server's block-chunked prefill).
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (the Pallas TPU
// kernel behind `flash_attention`, pallas_call at :96) and, for the chunk
// form, the jnp `chunked_attention` over the cache buffer that the
// reference's models/transformer.py runs in mode "prefill_resume".
//
// Semantics, both forms: q (B, S, Hq, D), k and v (B, Skv, Hkv, D), fp32;
// query head hq reads KV head hq / G (G = Hq / Hkv); query i of row b sits
// at position pos0[b] + i (pos0 = 0 and Skv = S in the whole-prompt form),
// key slot j at position j; causal mask k_pos <= q_pos, plus an optional
// sliding window k_pos > q_pos - window (whole-prompt form only); with a
// logit softcap c > 0 (grok-1's 30) a kept score s, already scaled, becomes
// tanh(s / c) * c, as the reference's jnp attention caps it before the mask
// (the Pallas kernel takes no cap); masked scores -1e30 (never capped) as
// in the Pallas kernel; output acc / max(l, 1e-20) in
// (B, S, Hq, D) fp32. S and Skv are ragged. Slots above the chunk's front
// pos0[b] + S - 1 may hold garbage (pad tokens of the last chunk, bytes of
// scrubbed or restored blocks): they are never copied into shared memory
// (the copy zero-fills them), so no key above a row's front is read into a
// product and a NaN or Inf planted there leaves the output bit-identical.
// bf16 (the _bf16 entry points, the reference's default precision) is
// flash_attention_bf16.cu, a kernel of its own on the bf16 tensor cores;
// the two share the plan, the Params and the epilogue
// (flash_attention_common.cuh).
//
// What bounds it on an H100: the whole prompt at the serve path's shapes
// (B 4, S 128, 40 query heads over 8 KV heads of 128) moves 25 MB, 7.5 us
// at 3.35 TB/s, for 0.68 GFLOP of causal products; issued as 3 TF32 MMAs
// per product that is 2.0 GFLOP, 4.1 us at 495 TFLOP/s, so bytes bound it
// (fp32 outside the tensor cores, 67 TFLOP/s, would take 10 us). The
// server's chunk (4 rows of 16 queries over a 256-slot buffer, fronts 15 to
// 127) moves 5.2 MB (1.6 us) for 0.29 GFLOP of TF32 MMAs (0.6 us): bytes
// again. The products grow with S^2: a 2048-token prompt is 129 GFLOP of
// TF32 MMAs (0.26 ms) against 101 MB (0.03 ms), bound by operations.
//
// Design: the kernel it replaced ran one block per (16-query tile, query
// head), staged K/V with scalar loads between two barriers, and scored
// each key with a serial fp32 FMA chain per lane. This one:
//  * Folds GQA as the Pallas kernel does: one block per (query tile, KV
//    head, batch row, key range) holds all G query heads of its KV head,
//    each warp 16 query rows of one head, so a K/V tile read once from
//    device memory serves G x 16 x qsub rows. G is a runtime value: a
//    block takes up to 8 heads, spread evenly over more blocks when G is
//    larger, and qsub 16-row sub-tiles of each
//    (kernels/flash_attention.py::_plan).
//  * Runs S = Q K^T and O += P V on the tensor cores, mma.sync.m16n8k8 in
//    TF32, with both operands split v = hi + lo and 3 MMAs per product
//    (lo*hi + hi*lo + hi*hi), which keeps fp32's accuracy. hi is v rounded
//    to TF32 in two integer ops, not cvt.rna.tf32; each 32-deep slice of a
//    contraction (32 of D for S, the 32 keys of a tile for O) sums into
//    fresh registers that are then added to the fp32 sum, because the
//    tensor cores' own accumulation truncates. The
//    online softmax (m, l, alpha) stays in fp32 registers, with expf. P
//    never leaves registers: the accumulator gives a lane keys 2t and
//    2t + 1 of each 8-key group, and the P V product takes them as its k
//    slots t and t + 4 by reading V's rows 2t and 2t + 1 there (a sum over
//    keys does not care which slot a key occupies); Q and K are read in
//    the same permuted order along D, one 8-byte load per fragment.
//  * Stages K and V tiles of 32 keys through a 2-stage cp.async ring of
//    16-byte copies, the next tile in flight while the current one is
//    multiplied; keys past the front zero-fill. Shared rows are padded (Q
//    and K by 8 floats, V by 4) so that every fragment load of a warp hits
//    each bank once. Each warp splits the fragments it loads; splitting a
//    tile once for the whole block into shared memory was slower on the
//    card (one more barrier and pass per tile), and a third stage gained
//    nothing.
//  * Splits the chunk form's key axis into ranges of a fixed number of
//    absolute slots (the plan's `split`; 32 measured fastest at the
//    server's shapes), one block each, so that its few (row, KV head) pairs
//    fill the card; a range above a row's front does nothing. Each busy
//    range writes its unnormalised (m, l, acc) to scratch, and the last
//    block of a (row, KV head, query tile) to finish, found with an atomic
//    counter (never an atomic on the values), combines the ranges in
//    ascending order with many loads in flight and sets the counter back
//    to 0 for the next launch. The whole-prompt form does not split.
//  * Skips the tiles above a warp's last query position, and issues query
//    tiles longest first. When one row's blocks fit one wave, a block of
//    the whole-prompt form takes two query tiles, the k-th longest and the
//    k-th shortest, so that blocks do about the same causal work and a
//    batch of rows fits one wave too (the plan's `pair`). Masked 8-key
//    groups of a diagonal tile are multiplied anyway: branching around
//    their MMAs put each MMA in a block of its own and was slower.
//  * Runs one block per SM, with up to 255 registers a thread: held to 204
//    for two blocks of 5 warps per SM it was slower on the card at the
//    main paths' shapes (faster only at a 2048-token prompt;
//    scripts/attention_variants.py).
//  * The softcap is a template flag: the uncapped kernels are the code
//    they were, and the capped ones add tanhf (not tanh.approx.f32, whose
//    ~5e-4 relative error times c = 30 would move a score by ~0.015) and
//    an IEEE division to each kept score: +14 % of device time at grok's
//    whole prompt, +4 % in the chunk form (PERF.md).
//  * Head dim 256 (recurrentgemma-2b, whole-prompt form only): the same
//    code, with Q rows of 264 floats and K/V tiles of 33.5 KB a stage, so a
//    block takes at most 5 warps (16 x 5 query rows) within the 227 KB of
//    shared memory (kernels/flash_attention.py::max_warps); a thread's
//    output accumulator is 128 floats.
// The plan (heads per block, query sub-tiles, key split) depends on one
// row's shape (S, Skv, Hq, Hkv, D) and the card's SM count, never on B or
// pos0, so a row gives the same bits alone and in a group.
//
// Not used yet: wgmma, the way to the 495 TFLOP/s TF32 peak (mma.sync
// measured 317 TFLOP/s dense on the card, scripts/tf32_mma_rate.py). Its
// 64-row tiles do not fit 16 x G = 80-row query tiles, and a TF32 wgmma
// takes both operands K-major, so V would need a transpose in shared
// memory (ROADMAP queue 2).
#include "flash_attention_common.cuh"

namespace {

constexpr int kStages = 2;        // cp.async ring depth

template <int D>
struct Smem {
  // float2 loads of rows g (0..7) at column 2t: a half-warp hits 32 banks
  // once when the row stride is 8 mod 32 floats
  static constexpr int kQLd = D + 8;
  // scalar loads of rows 2t, 2t + 1 at column g: 4 mod 32 floats
  static constexpr int kVLd = D + 4;
  static constexpr int kK = kBKV * kQLd;
  static constexpr int kStage = kK + kBKV * kVLd;
  static constexpr int bytes(int warps) {
    return (warps * 16 * kQLd + kStages * kStage) * 4;
  }
};

// v = hi + lo: hi is v rounded to TF32's 10 mantissa bits (half away from
// zero, in two integer ops), lo = v - hi is exact in fp32 with
// |lo| <= 2^-11 |v|, and the MMA reads lo's top 19 bits, so the pair
// carries v to ~2^-21 of its size
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One query tile (qt) of one key range (rg) of KV head h, head group hg,
// batch row b: the tile loop, then the normalised output, or with a split
// this range's partial and, in the last range to finish, the combine.
// kCap: the kept scores take the softcap. T: the type of q, k, v and out
// (fp32, or bf16 widened into the same fp32 tiles as it is staged).
template <int D, bool kCap, typename T>
__device__ __forceinline__ void query_tile(const Params& p, float* smem,
                                           int& is_last, int qt, int rg,
                                           int h, int hg, int b) {
  using L = Smem<D>;
  constexpr int QL = L::kQLd, VL = L::kVLd, C4 = D / 4, NT = D / 8;
  const int warps = blockDim.x >> 5;
  const int rows = warps * 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* Qs = smem;
  float* ring = smem + rows * QL;

  TileKeys tk;
  if (!tile_keys(p, qt, rg, h, hg, b, warp, tk)) return;
  const int q0 = tk.q0, front = tk.front;

  // Q of every pair (rows past S or heads past G zero-fill): first group
  for (int e = tid; e < rows * C4; e += blockDim.x) {
    const int row = e / C4, c = e % C4, w = row >> 4;
    const int jj = hg * p.hb + w / p.qsub;
    const int qr = q0 + (w % p.qsub) * 16 + (row & 15);
    const bool ok = jj < p.G && qr < p.S;
    const T* src = static_cast<const T*>(p.q) +
                   (((long long)b * p.S + qr) * p.Hq + h * p.G + jj) * D + c * 4;
    if constexpr (std::is_same<T, float>::value)
      cp_async16(Qs + row * QL + c * 4, ok ? src : p.q, ok ? 16 : 0);
    else
      *reinterpret_cast<float4*>(Qs + row * QL + c * 4) =
          ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long long slot_stride = (long long)p.Hkv * D;
  const long long base = ((long long)b * p.Skv * p.Hkv + h) * D;
  auto load_tile = [&](int st, int tile) {
    float* Ks = ring + st * L::kStage;
    float* Vs = Ks + L::kK;
    for (int e = tid; e < 2 * kBKV * C4; e += blockDim.x) {
      const bool isv = e >= kBKV * C4;
      const int e2 = isv ? e - kBKV * C4 : e;
      const int key = e2 / C4, c = e2 % C4;
      const int kp = tile * kBKV + key;
      const bool ok = kp <= front;              // zero-fill past the front
      const T* src = static_cast<const T*>(isv ? p.v : p.k) + base +
                     kp * slot_stride + c * 4;
      float* dst = (isv ? Vs + key * VL : Ks + key * QL) + c * 4;
      if constexpr (std::is_same<T, float>::value)
        cp_async16(dst, ok ? src : p.k, ok ? 16 : 0);
      else   // bf16: a synchronous load, widened (the tile after is in flight)
        *reinterpret_cast<float4*>(dst) =
            ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int qp0 = tk.p0 + tk.r0 + g;            // position of row g
  const float* Qw = Qs + (warp * 16 + g) * QL + 2 * t;

  key_loop<kStages>(tk, load_tile, [&](int st, int tile) {
    const float* Ks = ring + st * L::kStage;
    const float* Vs = Ks + L::kK;
    const int kt0 = tile * kBKV;

    // S = Q K^T: fragment k slots t, t + 4 hold d = kk + 2t, kk + 2t + 1
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
      for (int kk = dc; kk < dc + 32; kk += 8) {
        const float2 x0 = *reinterpret_cast<const float2*>(Qw + kk);
        const float2 x1 = *reinterpret_cast<const float2*>(Qw + 8 * QL + kk);
        uint32_t ahi[4], alo[4];
        split_tf32(x0.x, ahi[0], alo[0]);
        split_tf32(x1.x, ahi[1], alo[1]);
        split_tf32(x0.y, ahi[2], alo[2]);
        split_tf32(x1.y, ahi[3], alo[3]);
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Ks + (8 * jn + g) * QL + kk + 2 * t);
          split_tf32(kv.x, bhi[jn][0], blo[jn][0]);
          split_tf32(kv.y, bhi[jn][1], blo[jn][1]);
        }
        // one pass per term, small terms first: the MMAs of a pass are
        // independent, so a sum never waits on the MMA just issued
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_tf32(part[jn], alo, bhi[jn]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_tf32(part[jn], ahi, blo[jn]);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_tf32(part[jn], ahi, bhi[jn]);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[jn][c] += part[jn][c];
    }

    // mask, then the online softmax of rows g (c = 0, 1) and g + 8 (2, 3)
    softmax_step<NT, kCap>(p, s, acc, kt0, qp0, t, m0, l0, m1, l1);

    // O += P V: P's k slots t, t + 4 are keys 2t, 2t + 1 of each group
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      split_tf32(s[jn][0], phi[jn][0], plo[jn][0]);
      split_tf32(s[jn][2], phi[jn][1], plo[jn][1]);
      split_tf32(s[jn][1], phi[jn][2], plo[jn][2]);
      split_tf32(s[jn][3], phi[jn][3], plo[jn][3]);
    }
#pragma unroll
    for (int dg = 0; dg < NT; dg += 4) {
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[n][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float* v0 = Vs + (8 * ks + 2 * t) * VL + dg * 8 + g;
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          split_tf32(v0[n * 8], bhi[n][0], blo[n][0]);
          split_tf32(v0[VL + n * 8], bhi[n][1], blo[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(part[n], plo[ks], bhi[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(part[n], phi[ks], blo[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_tf32(part[n], phi[ks], bhi[n]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[dg + n][c] += part[n][c];
    }
  });

  finish_tile<D, T>(p, smem, is_last, acc, m0, l0, m1, l1, tk.active, qt,
                    rg, h, hg, b, q0, tk.r0, tk.hq, tk.r_lo, tk.r_hi);
}

// grid (q_tiles * ranges, or ceil(q_tiles / 2) when paired; Hkv * groups;
// B), hb * qsub warps, one block an SM. Query tiles go longest first; a
// paired block takes the k-th longest and then the k-th shortest, so that
// every block does about the same causal work and one wave holds twice
// the query tiles.
template <int D, bool kCap, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
prefill_attention(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  const int xq = (int)blockIdx.x / p.ranges, rg = blockIdx.x % p.ranges;
  const int h = blockIdx.y / p.groups, hg = blockIdx.y % p.groups;
  const int qt = p.q_tiles - 1 - xq;
  const int jobs = p.pair && xq < qt ? 2 : 1;
#pragma unroll 1
  for (int job = 0; job < jobs; ++job) {   // one copy of the tile's code
    if (job) __syncthreads();              // Q and the ring are free again
    query_tile<D, kCap, T>(p, smem, is_last, job ? xq : qt, rg, h, hg,
                        blockIdx.z);
  }
}

template <int D, bool kCap, typename T>
int launch_d(const Params& p, int B, int warps, cudaStream_t st) {
  const int smem = Smem<D>::bytes(warps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static unsigned long long ready = 0;   // the shared-memory opt-in, once
  int dev = 0;                           // per device
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_attention<D, kCap, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready |= bit;
  }
  dim3 grid(p.pair ? (p.q_tiles + 1) / 2 : p.q_tiles * p.ranges,
            p.Hkv * p.groups, B);
  prefill_attention<D, kCap, T><<<grid, warps * 32, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// parts_floats / count_ints: the capacity of the split's scratch
template <typename T>
int launch(Params p, int B, int D, long long parts_floats, long long count_ints,
           cudaStream_t st) {
  const int err = prepare(p, B, D, parts_floats, count_ints);
  if (err) return err;
  const int warps = p.hb * p.qsub;
  const bool cap = p.softcap > 0.f;
  switch (D) {
    case 32: return cap ? launch_d<32, true, T>(p, B, warps, st)
                        : launch_d<32, false, T>(p, B, warps, st);
    case 64: return cap ? launch_d<64, true, T>(p, B, warps, st)
                        : launch_d<64, false, T>(p, B, warps, st);
    case 128: return cap ? launch_d<128, true, T>(p, B, warps, st)
                         : launch_d<128, false, T>(p, B, warps, st);
    case 256:  // the whole-prompt form only
      if (p.split || p.pos0) return (int)cudaErrorInvalidValue;
      return cap ? launch_d<256, true, T>(p, B, warps, st)
                 : launch_d<256, false, T>(p, B, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The whole-prompt form: q (B, S, Hq, D), k and v (B, S, Hkv, D), all
// 16-byte aligned; hb heads of a KV head and qsub 16-row sub-tiles per
// block (hb * qsub <= 8); pair != 0 gives a block two query tiles;
// softcap > 0 caps the kept scaled scores (0: no cap).
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* out, int B, int S,
                                   int Hq, int Hkv, int D, float scale,
                                   float softcap, int window, int hb,
                                   int qsub, int pair, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return launch<float>(make_params(q, k, v, nullptr, out, S, S, Hq, Hkv,
                                   scale, softcap, window, hb, qsub, 0, pair),
                       B, D, 0, 0, (cudaStream_t)stream);
}

// The chunked form: q (B, S, Hq, D) at positions pos0[b] + i (pos0 an int
// array on the device), k and v (B, Skv, Hkv, D). Requires
// pos0[b] + S <= Skv. split > 0 (a multiple of 32) splits the key axis into
// ranges of that many slots; parts (parts_floats floats) and counts
// (count_ints ints, all 0) are then its scratch, and counts are 0 again
// when the launch ends; softcap as in the whole-prompt form. Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_chunk_fwd(const float* q, const float* k,
                                         const float* v, const int* pos0,
                                         float* out, float* parts,
                                         long long parts_floats, int* counts,
                                         long long count_ints, int B, int S,
                                         int Skv, int Hq, int Hkv, int D,
                                         float scale, float softcap, int hb,
                                         int qsub, int split, void* stream) {
  Params p = make_params(q, k, v, pos0, out, S, Skv, Hq, Hkv, scale, softcap,
                         0, hb, qsub, split, 0);
  p.parts = parts;
  p.counts = counts;
  return launch<float>(p, B, D, parts_floats, count_ints, (cudaStream_t)stream);
}
