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
// bf16 (the _bf16 entry points, the reference's default precision): q, k,
// v and out bf16; Q and the K/V tiles are widened to fp32 (exactly) as
// they are staged, with plain loads in place of cp.async, into the same
// fp32 tiles, and the output is rounded to bf16 (round to nearest even)
// once, as the Pallas kernel writes q.dtype; the split's partials stay
// fp32. q times the scale and P are not bf16, so the products keep the
// 3-MMA split. The fp32 forms are the same code at another instance.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBKV = 32;          // keys per tile: one 32-deep slice of P V
constexpr int kStages = 2;        // cp.async ring depth
constexpr int kMaxWarps = 8;      // warps per block: (head, sub-tile) pairs
constexpr int kMaxRanges = 32;    // key ranges of a split: their (m, l) fit
                                  // the shared memory freed for the combine
constexpr float kNegInf = -1e30f;

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

  const int q0 = qt * 16 * p.qsub;
  const int p0 = p.pos0 ? p.pos0[b] : 0;       // position of query 0
  // the tile's last query position is the front: no key above it is read
  const int front = min(p0 + min(q0 + 16 * p.qsub, p.S) - 1, p.Skv - 1);
  const int lo = p.window > 0 ? max(0, p0 + q0 - p.window + 1) : 0;
  int k_lo = lo, k_hi = front, r_lo = 0, r_hi = 0;
  if (p.split) {
    r_lo = lo / p.split;
    r_hi = front / p.split;
    if (rg < r_lo || rg > r_hi) return;        // the whole block: no keys
    k_lo = max(lo, rg * p.split);
    k_hi = min(front, rg * p.split + p.split - 1);
  }

  // this warp's (head, 16-row sub-tile) and the keys its rows can see
  const int j = hg * p.hb + warp / p.qsub;
  const int r0 = q0 + (warp % p.qsub) * 16;
  const bool active = j < p.G && r0 < p.S;
  const int hq = h * p.G + j;
  const int w_hi = min(p0 + min(r0 + 16, p.S) - 1, k_hi);
  const int w_lo = p.window > 0 ? max(k_lo, p0 + r0 - p.window + 1) : k_lo;
  const int wt_lo = w_lo / kBKV, wt_hi = w_lo <= w_hi ? w_hi / kBKV : -1;

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
  const int qp0 = p0 + r0 + g, qp1 = qp0 + 8;   // positions of rows g, g+8
  const float* Qw = Qs + (warp * 16 + g) * QL + 2 * t;

  const int t_lo = k_lo / kBKV;
  const int ntiles = k_lo <= k_hi ? k_hi / kBKV - t_lo + 1 : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, t_lo + s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile i landed; tile i-1 is free
    const int nx = i + kStages - 1;
    if (nx < ntiles) load_tile(nx % kStages, t_lo + nx);
    cp_async_commit();
    const int tile = t_lo + i;
    if (!active || tile < wt_lo || tile > wt_hi) continue;   // warp-uniform
    const float* Ks = ring + (i % kStages) * L::kStage;
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
  }
  cp_async_wait<0>();

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

// The same with q, k, v and out bf16 (16-byte aligned): staged widened to
// fp32, computed as the fp32 form, the output rounded to bf16 (q.dtype, as
// the Pallas kernel's).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, int B, int S,
                                        int Hq, int Hkv, int D, float scale,
                                        float softcap, int window, int hb,
                                        int qsub, int pair, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(
      make_params(q, k, v, nullptr, out, S, S, Hq, Hkv, scale, softcap,
                  window, hb, qsub, 0, pair),
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

// The chunked form with q, k, v and out bf16, as flash_attention_fwd_bf16
// (the partials stay fp32).
extern "C" int flash_attention_chunk_fwd_bf16(
    const void* q, const void* k, const void* v, const int* pos0, void* out,
    float* parts, long long parts_floats, int* counts, long long count_ints,
    int B, int S, int Skv, int Hq, int Hkv, int D, float scale, float softcap,
    int hb, int qsub, int split, void* stream) {
  Params p = make_params(q, k, v, pos0, out, S, Skv, Hq, Hkv, scale, softcap,
                         0, hb, qsub, split, 0);
  p.parts = parts;
  p.counts = counts;
  return launch<__nv_bfloat16>(p, B, D, parts_floats, count_ints,
                               (cudaStream_t)stream);
}
