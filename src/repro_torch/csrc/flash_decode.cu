// Flash-decoding attention on Hopper: one new query token per row over its
// KV cache, in one launch.
//
// Replaces: src/repro/kernels/flash_decode.py::_flash_kernel (the Pallas TPU
// kernel behind `flash_decode`, pallas_call at :78). Same inputs and
// masking: q (B, Hkv, G, D), k and v in the cache's own (B, S, Hkv, D)
// layout, slot_positions (B, S) int32 and lengths (B,) int32; a slot takes
// part when 0 <= slot_positions[b, s] <= lengths[b], wherever it sits in
// the buffer (ring buffers too). With a logit softcap c > 0 (grok-1's 30)
// a valid slot's score s, already scaled, becomes tanh(s / c) * c, as the
// reference's jnp attention caps it before the mask (the Pallas kernel
// takes no cap). Masked scores are -1e30 (not -inf, never capped), as in
// the Pallas kernel and its oracle. Output (B, Hkv, G, D) fp32 =
// acc / max(l, 1e-20); query head g of KV head h is q head h*G + g. A row
// with no valid slot gives what the oracle's softmax over S equal scores
// gives: the mean of V over all S slots.
// bf16 (flash_decode_fwd_bf16, the reference's default precision): q, k and
// v bf16, a kernel of its own on the bf16 tensor cores (flash_decode_mma,
// below), with the fp32 form's masks, plan, ranges and combine; the output
// fp32.
//
// What bounds it on an H100: a valid slot's K and V rows (2 x D x 4 bytes)
// serve 2 x 2 x G x D FLOP, 2.5 FLOP a byte at G = 5, which fp32 FMAs
// outside the tensor cores do in an eighth of the time the bytes take at
// 3.35 TB/s: bytes bound it. At the decode step's short caches (4.5 MB of
// valid K/V for 4 rows of ~140 slots, 1.4 us at 3.35 TB/s) latency bounds
// it as much: a chain of dependent trips to memory costs more than the
// bytes, so every step keeps all of its loads in flight and the call is one
// launch. At 4 K and 32 K slots (133 and 268 MB) it streams, and needs
// enough blocks, and few enough instructions a tile, to keep 132 SMs
// reading.
//
// Design:
//  * Grid (range, head group, row): a block of 8 warps takes `range`
//    absolute slots of one (row, KV head) and G / groups of that KV head's
//    G query heads, so a K/V byte read once serves them all. Up to 8 query
//    heads (a warp each in the softmax) take one group; more are spread
//    evenly over ceil(G / 8) groups, as the prefill forms spread them
//    (mistral-large's 12 as 2 x 6), each group a block that reads the K/V
//    range again, mostly from L2. Head group y is query heads y * (G /
//    groups) .. of the row, KV head y / groups: q and out seen as (B, Hkv *
//    groups, G / groups, D). The range and the groups come from one row's
//    shape and the card's SM count (kernels/flash_decode.py::_plan), never
//    from B, lengths or the slot positions, so a row's bits do not depend
//    on the rows beside it; a head's bits do not depend on its group
//    either. The heads of a block are a template parameter (1 to 8), so
//    that every loop over heads unrolls whole; so is the softcap, so that
//    the uncapped kernels are the code they were and the capped ones add
//    tanhf (not tanh.approx.f32, whose ~5e-4 relative error times c = 30
//    would move a score by ~0.015) and an IEEE division to each summed
//    score, before the mask.
//  * A block first reads its range's slot positions, all in flight at
//    once, 32 consecutive slots to a warp (one coalesced load), into one
//    valid-slot bit mask per 32-slot tile (a ballot). Only tiles with a
//    valid slot are staged: K and V rows of valid slots are copied into
//    shared memory by cp.async (16 bytes a thread, a warp a 512-byte row),
//    masked slots are zero-filled (source size 0) and never read. A tile
//    without a valid slot costs no K/V byte, and NaN or Inf in a masked
//    slot leaves the output bit-identical.
//  * The copies go through a ring of `stages` tiles, each tile as two
//    groups, K then V, so that the scores start while V is still landing.
//    The first `stages` busy tiles are issued before any score is
//    computed, so a range of up to `stages` busy tiles is wholly in flight
//    at once; afterwards each tile's slot is refilled as soon as every
//    thread has read it.
//  * Q K^T without a shuffle per slot and head: lane = slot, warp = an
//    eighth of D, the G scaled query rows in shared memory (read as
//    broadcasts); the eight partial scores meet in shared memory and are
//    added in a fixed order. Rows are padded to D + 4 floats so that a
//    quarter warp's float4 reads of one column hit 32 banks once.
//  * Softmax once per tile: warp g keeps query head g's running max (one
//    redux.sync over the tile's 32 slots) and its lane's share of the sum
//    (summed over the lanes once, at the end of the range); one rescale
//    alpha per tile, p = exp(s - m) into shared memory.
//  * P V: a lane covers 4 of D (float4); 1024 / D groups of consecutive
//    slots split the tile, so a thread reads its slots' p of a head as one
//    vector; the groups' sums meet in shared memory at the end of the
//    range, in a fixed order.
//  * One launch: each range writes its unnormalised (m, l, acc) to
//    scratch; the last block of a (row, KV head) to finish, found with an
//    atomic counter (acquire-release, never an atomic on the values),
//    combines the ranges in ascending order and sets the counter back to 0
//    for the next launch. It issues its loads of the first 8 ranges'
//    partials before anything else, and meanwhile computes each (head,
//    range) weight exp(m_r - M) once (a warp a head; the denominator in
//    ascending order through shuffles). A single range normalises and
//    stores directly.
//  * Head dim 256 (recurrentgemma-2b) takes the same layout: a warp's
//    eighth of D is 32 floats, 4 slot groups of 8 slots split a tile in
//    P V, and a 32-slot K+V tile of rows padded to 260 floats is 66.6 KB,
//    so the ring holds at most 3 tiles (Smem::kStagesFit) within the 227 KB
//    of shared memory a block may have, and an SM holds one block.
//  * bf16 (flash_decode_mma): the fp32 design's tile loop is three block
//    barriers a tile; with bf16's half-sized tiles it is the loop's work and
//    its barriers, not the bytes, that set the pace (the first bf16 form
//    widened each tile into the fp32 ring by plain loads: 0.067 ms over
//    long_500k's 8192-slot ring, 2.2 x the fp32 form; a bf16 ring by
//    cp.async, two tiles a step, still 0.022, and as fast with no K/V byte
//    read: scripts/decode_variants.py --bf16). So each warp takes its own
//    16-slot steps of the range (steps warp, warp + 8, ...), each through a
//    ring of its own (K and V rows raw by cp.async, masked slots
//    zero-filled), with no block barrier until the range ends: S = Q K^T
//    as m16n8k16 bf16 MMAs (the G query rows, raw bf16, as the A operand's
//    rows, the rest zero; K rows by ldmatrix), the scale after the sum; the
//    online softmax on the accumulator fragments (a head's 16 scores on the
//    4 lanes of its fragment row: two shuffles); P V with P (fp32) split
//    into kPTerms = 3 bf16 terms (all of fp32's 24 bits) as the A operand
//    straight from those fragments and V by ldmatrix.trans, each step into
//    fresh registers then added to the fp32 sums. At the range's end the 8
//    warps' (m, l, acc) meet in shared memory in warp order, and the
//    range's result takes the fp32 form's path (one range: normalised; more:
//    partials and the fixed-order combine). The sums run in another order
//    than the fp32 form's: the output is held within 1e-5 of the plain
//    version.
//  * Measured and dropped (scripts/decode_variants.py, PERF.md): 4 warps,
//    each a quarter of D and two heads, with strided slots in P V (one
//    tile took 2.0 us of math in a block); P V done by each head's own
//    warp over the whole tile (one barrier less a tile, but a 32-slot
//    chain a lane: slower); a whole row in one block (its tiles run one
//    after another: slower at 145 slots); the last range taking the rest
//    of S, so that 4 rows of 145 slots are 128 blocks, one wave (its
//    2-tile range cost more than the doubled SMs it spared).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <stdint.h>

#ifdef FLASH_DECODE_BF16
#include "bf16_mma.cuh"
#endif

namespace {

constexpr int kTile = 32;            // slots per tile: one per lane
constexpr int kWarps = 8;            // a warp per query head of a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = kWarps;
constexpr int kMinStages = 1;        // one stage only for a one-tile range
constexpr int kMaxStages = 6;        // at D <= 128 (Smem::kStagesFit)
constexpr int kSmemMax = 232448;     // dynamic shared memory of a block
constexpr int kMaxTiles = 64;        // tiles of one range: 2048 slots
constexpr int kMaxRanges = 128;      // ranges of one (row, KV head)
constexpr int kR = 8;                // ranges a combine step keeps in flight
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;     // fp32 or bf16 (the kernel's T), as are k and v
  const void* k;
  const void* v;
  const int* slot_pos;
  const int* lengths;
  float* out;
  float* parts;      // ranges > 1: acc (B, Hkv * groups, ranges, G, D),
                     // then m, l (.., G)
  int* counts;       // ranges > 1: one counter per (row, head group), 0
  int S, Hkv;
  int G;             // query heads of a block: of a KV head / groups
  int groups;        // blocks a KV head's query heads are spread over
  int range, ranges, stages;
  float scale;
  float softcap;     // > 0: tanh(s / softcap) * softcap on valid scores
};

// A block's dynamic shared memory, in floats: a fixed part, then the ring.
// At the end of a range the ring holds the slot groups' P V sums (`kRedF`,
// which sizes it where the stages alone would be smaller), and in the
// combine every range's weights.
template <int D>
struct Smem {
  static constexpr int kLd = D + 4;                 // padded row
  static constexpr int kTileF = kTile * kLd;        // K or V of one tile
  static constexpr int kStageF = 2 * kTileF;
  static constexpr int kRedF = (kThreads / (D / 4)) * kMaxG * D;
  static constexpr int kQ = 0;                      // (kMaxG, D) scaled q
  static constexpr int kPart = kQ + kMaxG * D;      // (kWarps, kMaxG, kTile)
  static constexpr int kP = kPart + kWarps * kMaxG * kTile;  // (kMaxG, kTile)
  static constexpr int kAlpha = kP + kMaxG * kTile;  // (kMaxG)
  static constexpr int kM = kAlpha + kMaxG;          // (kMaxG) range max
  static constexpr int kL = kM + kMaxG;              // (kMaxG) range sum
  static constexpr int kMask = kL + kMaxG;           // (kMaxTiles) bits
  static constexpr int kRing = kMask + kMaxTiles;
  static constexpr int bytes(int stages) {
    return (kRing + (stages * kStageF > kRedF ? stages * kStageF : kRedF)) * 4;
  }
  // the deepest ring that fits the shared memory (3 tiles at D = 256)
  static constexpr int kStagesFit =
      (kSmemMax / 4 - kRing) / kStageF < kMaxStages
          ? (kSmemMax / 4 - kRing) / kStageF : kMaxStages;
  // blocks an SM is asked to hold (their registers capped to fit)
  static constexpr int kMinBlocks = bytes(2) * 2 <= kSmemMax ? 2 : 1;
  static_assert(kRing % 4 == 0, "the ring must be 16-byte aligned");
  static_assert(kRedF >= 2 * kMaxRanges * kMaxG + 2 * kMaxG,
                "the ring must hold the combine's weights");
  static_assert(kStagesFit >= 2 && bytes(kStagesFit) <= kSmemMax,
                "two ring stages must fit the shared memory");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n (0 <= n <= N) groups are pending
template <int N = 2 * kMaxStages - 1>
__device__ __forceinline__ void cp_async_wait(int n) {
  if constexpr (N == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n >= N) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
  } else {
    cp_async_wait<N - 1>(n);
  }
}
// add 1 to a counter with release (this block's stores, ordered before by
// a barrier, are visible first) and acquire (the other blocks' are seen)
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int x) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(x) : "memory");
  return old;
}

// a float's bits as an int of the same order, and back (its own inverse)
__device__ __forceinline__ int ordered(int i) { return i >= 0 ? i : i ^ 0x7fffffff; }
__device__ __forceinline__ float warp_max(float x) {   // one redux.sync
  const int i = __reduce_max_sync(0xffffffffu, ordered(__float_as_int(x)));
  return __int_as_float(ordered(i));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// four consecutive values of global memory, widened to fp32 (bf16: 8-byte
// aligned, widened by the intrinsics, exactly)
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void fma4(float4& a, float w, const float4& x) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}
__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// n consecutive floats of shared memory (n = 1, 2, 4 or 8; aligned to
// min(n, 4))
template <int N>
__device__ __forceinline__ void load_n(const float* src, float (&dst)[N]) {
  if constexpr (N == 8) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 y = *reinterpret_cast<const float4*>(src + 4);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
    dst[4] = y.x; dst[5] = y.y; dst[6] = y.z; dst[7] = y.w;
  } else if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

// A row with no valid slot: the oracle's softmax over S equal scores of
// -1e30 weighs every slot 1/S, so each query head gets V's mean over the
// whole buffer. `red` holds kThreads * 4 floats of scratch.
template <int D, typename T>
__device__ void mean_of_v(const Params& p, int b, int h, long long bh,
                          float* red) {
  constexpr int C = D / 4, NR = kThreads / C;
  const int tid = threadIdx.x, c = tid % C, grp = tid / C;
  const T* vb = static_cast<const T*>(p.v) +
                ((long long)b * p.S * p.Hkv + h) * D + c * 4;
  const long long stride = (long long)p.Hkv * D;   // values from slot to slot
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = grp; s < p.S; s += NR) add4(a, ld4(vb + s * stride));
  reinterpret_cast<float4*>(red)[grp * C + c] = a;
  __syncthreads();
  if (tid < C) {
    float4 t = reinterpret_cast<float4*>(red)[tid];
    for (int r = 1; r < NR; ++r) add4(t, reinterpret_cast<float4*>(red)[r * C + tid]);
    const float n = (float)p.S;
    t = make_float4(t.x / n, t.y / n, t.z / n, t.w / n);
    for (int g = 0; g < p.G; ++g)
      reinterpret_cast<float4*>(p.out + (bh * p.G + g) * D)[tid] = t;
  }
}

// A range's end, from its (m, l) per head (m_s, l_s) and ``range_acc(e)``,
// its unnormalised P V sums of element e = (head, float4 column): one range
// normalised into out (no busy tile: V's mean); more, the partials to
// scratch, and the last block of the (row, head group) to finish combines
// every range in order. ``scratch`` holds the combine's weights (at least
// kThreads * 4 and (kMaxRanges + 2) * kMaxG floats).
template <int D, int G, typename T, typename RangeAcc>
__device__ __forceinline__ void finish_range(const Params& p, int b, int h,
                                             long long bh, int rg, bool busy,
                                             const float* m_s,
                                             const float* l_s, float* scratch,
                                             int& last_s,
                                             RangeAcc range_acc) {
  constexpr int C = D / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (p.ranges == 1) {                 // the whole row: normalise and store
    if (!busy) {                       // no busy tile: no valid slot
      mean_of_v<D, T>(p, b, h, bh, scratch);
      return;
    }
    for (int e = tid; e < G * C; e += kThreads) {
      const float4 a = range_acc(e);
      const float d = fmaxf(l_s[e / C], 1e-20f);
      reinterpret_cast<float4*>(p.out + bh * G * D)[e] =
          make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
    }
    return;
  }

  // this range's (m, l, acc) to scratch
  const long long nparts = (long long)gridDim.z * gridDim.y * p.ranges;
  float4* pacc = reinterpret_cast<float4*>(p.parts);      // (nparts, G, C)
  float* pm = p.parts + nparts * G * D;                    // (nparts, G)
  float* pl = pm + nparts * G;
  const long long first = bh * p.ranges;                   // this group's range 0
  for (int e = tid; e < G * C; e += kThreads)
    pacc[(first + rg) * G * C + e] = range_acc(e);
  if (tid < G) {
    pm[(first + rg) * G + tid] = m_s[tid];
    pl[(first + rg) * G + tid] = l_s[tid];
  }
  __syncthreads();
  if (tid == 0) last_s = atomic_add_acq_rel(p.counts + bh, 1) == p.ranges - 1;
  __syncthreads();
  if (!last_s) return;
  if (tid == 0) p.counts[bh] = 0;      // ready for the next launch

  // the last block of the group: the first kR ranges' partials of its elements in
  // flight first; meanwhile warp g takes head g's (m, l) of every range,
  // M, each weight exp(m_r - M) once and the denominator in ascending
  // order; then the elements, in ascending order of the ranges
  const int nr = p.ranges;
  constexpr int kE = (kMaxG * C + kThreads - 1) / kThreads;  // elements a thread
  const float4* src = pacc + first * G * C;
  int ee[kE];
  float4 x[kR][kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    ee[i] = min(tid + i * kThreads, G * C - 1);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      x[j][i] = __ldcg(src + (long long)min(j, nr - 1) * G * C + ee[i]);
  }
  float* w_s = scratch;                      // (nr, G) weights
  float* big_m = w_s + kMaxRanges * kMaxG;   // (kMaxG) M
  float* den = big_m + kMaxG;                // (kMaxG)
  if (warp < G) {                      // lane: ranges lane, lane + 32, ...
    const int g = warp;
    constexpr int kPerLane = kMaxRanges / 32;
    float mr[kPerLane], lr[kPerLane];
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int r = lane + 32 * k;
      mr[k] = r < nr ? __ldcg(pm + (first + r) * G + g) : kNegInf;
      lr[k] = r < nr ? __ldcg(pl + (first + r) * G + g) : 0.f;
      mx = fmaxf(mx, mr[k]);
    }
    mx = warp_max(mx);
    float d = 0.f;                     // every lane: the ranges in order
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int r = lane + 32 * k;
      const float w = r < nr ? expf(mr[k] - mx) : 0.f;
      if (r < nr) w_s[r * G + g] = w;
      for (int src = 0; src < 32 && 32 * k + src < nr; ++src)
        d = fmaf(__shfl_sync(0xffffffffu, w, src),
                 __shfl_sync(0xffffffffu, lr[k], src), d);
    }
    if (lane == 0) {
      den[g] = fmaxf(d, 1e-20f);
      big_m[g] = mx;
    }
  }
  __syncthreads();
  if (big_m[0] == kNegInf) {           // no valid slot in the whole row
    mean_of_v<D, T>(p, b, h, bh, scratch);  // over the weights, read no more
    return;
  }
  float4 o[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < nr; r0 += kR) {
    if (r0 > 0) {
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int i = 0; i < kE; ++i)
          x[j][i] = __ldcg(src + (long long)min(r0 + j, nr - 1) * G * C + ee[i]);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (r0 + j >= nr) break;
#pragma unroll
      for (int i = 0; i < kE; ++i)
        fma4(o[i], w_s[(r0 + j) * G + ee[i] / C], x[j][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kE; ++i) {
    const int e = tid + i * kThreads;
    if (e >= G * C) break;
    const float d = den[e / C];
    reinterpret_cast<float4*>(p.out + bh * G * D)[e] =
        make_float4(o[i].x / d, o[i].y / d, o[i].z / d, o[i].w / d);
  }
}

template <int D, int G, bool kCap, typename T>
__global__ void __launch_bounds__(kThreads, Smem<D>::kMinBlocks)
flash_decode_kernel(const Params p) {
  using L = Smem<D>;
  constexpr int C = D / 4;             // float4 columns of a row
  constexpr int NR = kThreads / C;     // slot groups of the P V pass
  constexpr int SPG = kTile / NR;      // consecutive slots of a group
  constexpr int KQ = C / kWarps;       // float4s of a warp's slice of D
  constexpr int kCopies = 2 * kTile * C / kThreads;   // cp.async a thread, a tile
  static_assert(SPG >= 1 && SPG <= 8 && KQ >= 1 && kCopies >= 2 &&
                    kTile % NR == 0,
                "D must be 32, 64, 128 or 256");
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_s;
  float* qs = smem + L::kQ;
  float* part = smem + L::kPart;
  float* ps = smem + L::kP;
  float* alpha_s = smem + L::kAlpha;
  float* m_s = smem + L::kM;
  float* l_s = smem + L::kL;
  unsigned* mask_s = reinterpret_cast<unsigned*>(smem + L::kMask);
  float* ring = smem + L::kRing;

  const int rg = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.groups;           // the KV head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * gridDim.y + blockIdx.y;  // (row, group)
  const int s0 = rg * p.range;
  const int s1 = min(p.S, s0 + p.range);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;

  // the range's slot positions, every load in flight, then a bit per valid
  // slot and tile
  {
    const int len = __ldg(p.lengths + b);
    const int* sp = p.slot_pos + (long long)b * p.S;
    constexpr int kPer = kMaxTiles / kWarps;
    int pos[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + (i * kWarps + warp) * kTile + lane;
      pos[i] = s < s1 ? __ldg(sp + s) : -1;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = i * kWarps + warp;
      const unsigned bits =
          __ballot_sync(0xffffffffu, pos[i] >= 0 && pos[i] <= len);
      if (lane == 0 && t < ntiles) mask_s[t] = bits;
    }
  }
  // the G query rows of this KV head, scaled
  for (int e = tid; e < G * C; e += kThreads) {
    const float4 x = ld4(static_cast<const T*>(p.q) + bh * G * D + e * 4);
    reinterpret_cast<float4*>(qs)[e] =
        make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
  }
  __syncthreads();
  // busy tiles (with a valid slot) in ascending order: every thread walks
  // the masks itself, the same way
  auto next_busy = [&](int t) {
    while (t < ntiles && mask_s[t] == 0u) ++t;
    return t;
  };

  // the j-th busy tile, t, into ring slot j % stages, as two groups, K then
  // V (two empty ones past the last); copy n of a thread is row
  // (tid + n * kThreads) / C, column c
  const int c = tid % C;
  int t_copy = next_busy(0);
  auto issue = [&](int j) {
    const int t = t_copy;
    if (t < ntiles) {
      t_copy = next_busy(t + 1);
      const unsigned bits = mask_s[t];
      float* dst = ring + (j % p.stages) * L::kStageF + c * 4;
      const long long row0 = ((long long)b * p.S + s0 + t * kTile) * p.Hkv + h;
      const T* kb = static_cast<const T*>(p.k) + row0 * D + c * 4;
      const T* vb = static_cast<const T*>(p.v) + row0 * D + c * 4;
#pragma unroll
      for (int n = 0; n < kCopies; ++n) {
        const bool isv = n >= kCopies / 2;
        const int slot = (tid + (isv ? n - kCopies / 2 : n) * kThreads) / C;
        const bool ok = (bits >> slot) & 1u;
        const long long off = (long long)slot * p.Hkv * D;
        cp_async16(dst + (isv ? L::kTileF : 0) + slot * L::kLd,
                   ok ? (isv ? vb : kb) + off : p.k, ok ? 16 : 0);
        if (n == kCopies / 2 - 1) cp_async_commit();
      }
    } else {
      cp_async_commit();
    }
    cp_async_commit();
  };
  for (int j = 0; j < p.stages; ++j) issue(j);

  // warp g: query head g's running max, and its lane's share of the sum
  float m_run = kNegInf, l_lane = 0.f;
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int grp = tid / C;

  int j = 0;
  for (int t = next_busy(0); t < ntiles; t = next_busy(t + 1), ++j) {
    cp_async_wait(2 * p.stages - (j == 0 ? 1 : 3));
    __syncthreads();                   // tile j's K landed; tile j - 1 read
    if (j > 0) issue(j + p.stages - 1);     // into tile j - 1's slot
    const float* ks = ring + (j % p.stages) * L::kStageF;
    const float* vs = ks + L::kTileF;

    {  // partial scores: lane = slot, warp = an eighth of D
      float4 kr[KQ];
      const float* krow = ks + lane * L::kLd + warp * (D / kWarps);
#pragma unroll
      for (int i = 0; i < KQ; ++i)
        kr[i] = *reinterpret_cast<const float4*>(krow + 4 * i);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qrow = qs + g * D + warp * (D / kWarps);
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < KQ; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + 4 * i);
          sc = fmaf(qv.x, kr[i].x, sc);
          sc = fmaf(qv.y, kr[i].y, sc);
          sc = fmaf(qv.z, kr[i].z, sc);
          sc = fmaf(qv.w, kr[i].w, sc);
        }
        part[(warp * kMaxG + g) * kTile + lane] = sc;
      }
    }
    cp_async_wait(2 * p.stages - 2);
    __syncthreads();                   // the partial scores and tile j's V
    if (warp < G) {                    // softmax: warp g, query head g
      const int g = warp;
      const unsigned bits = mask_s[t];
      float sc = part[g * kTile + lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sc += part[(w * kMaxG + g) * kTile + lane];
      if constexpr (kCap) sc = tanhf(sc / p.softcap) * p.softcap;
      if (!((bits >> lane) & 1u)) sc = kNegInf;
      const float mn = fmaxf(m_run, warp_max(sc));
      const float a = expf(m_run - mn);
      const float pr = expf(sc - mn);
      l_lane = l_lane * a + pr;
      m_run = mn;
      ps[g * kTile + lane] = pr;
      if (lane == 0) alpha_s[g] = a;
    }
    __syncthreads();
    // P V: group grp takes slots grp * SPG .. + SPG - 1, a lane 4 columns
    float4 vv[SPG];
#pragma unroll
    for (int n = 0; n < SPG; ++n)
      vv[n] = *reinterpret_cast<const float4*>(vs + (grp * SPG + n) * L::kLd + c * 4);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float a = alpha_s[g];
      acc[g] = make_float4(acc[g].x * a, acc[g].y * a, acc[g].z * a,
                           acc[g].w * a);
      float pg[SPG];
      load_n<SPG>(ps + g * kTile + grp * SPG, pg);
#pragma unroll
      for (int n = 0; n < SPG; ++n) fma4(acc[g], pg[n], vv[n]);
    }
  }
  cp_async_wait(0);
  __syncthreads();                     // the ring is free

  float* red = ring;                   // (NR, kMaxG, D) slot groups' sums
#pragma unroll
  for (int g = 0; g < G; ++g)
    reinterpret_cast<float4*>(red + (grp * kMaxG + g) * D)[c] = acc[g];
  if (warp < G) {
    const float l = warp_sum(l_lane);
    if (lane == 0) {
      m_s[warp] = m_run;
      l_s[warp] = l;
    }
  }
  __syncthreads();
  // the range's acc of element e = (g, column): the groups in order
  auto range_acc = [&](int e) {
    const int g = e / C, cc = e % C;
    float4 a = reinterpret_cast<const float4*>(red + g * D)[cc];
#pragma unroll
    for (int r = 1; r < NR; ++r)
      add4(a, reinterpret_cast<const float4*>(red + (r * kMaxG + g) * D)[cc]);
    return a;
  };

  finish_range<D, G, T>(p, b, h, bh, rg, j > 0, m_s, l_s, ring, last_s,
                        range_acc);
}

#ifdef FLASH_DECODE_BF16
// ---------------------------------------------------------------------------
// bf16 on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kStep = 16;        // slots a warp takes at a time: P V's k
constexpr int kPTerms = 3;       // bf16 terms of P in P V: fp32's 24 bits

// The bf16 kernel's dynamic shared memory, in bytes: q's rows as bf16 (the
// MMA's 16 rows, those past G zero), the tile masks, each warp's (m, l) a
// head (then each warp's weight), the range's (m, l), then each warp's
// ring of `stages` steps (K then V, 16 rows padded by 16 bytes, so that
// ldmatrix's 8 rows of a matrix hit each bank once). At the range's end the
// ring holds the warps' P V sums (fp32), and in the combine every range's
// weights.
template <int D>
struct SmemB {
  static constexpr int kLd = D + 8;                       // a row, in bf16
  static constexpr int kStepB = 2 * kStep * kLd * 2;      // K and V of a step
  static constexpr int kQ = 0;                            // (16, kLd) bf16
  static constexpr int kMask = kQ + 16 * kLd * 2;         // (kMaxTiles) bits
  static constexpr int kWm = kMask + kMaxTiles * 4;       // (kWarps, kMaxG)
  static constexpr int kWl = kWm + kWarps * kMaxG * 4;    // (kWarps, kMaxG)
  static constexpr int kM = kWl + kWarps * kMaxG * 4;     // (kMaxG)
  static constexpr int kL = kM + kMaxG * 4;               // (kMaxG)
  static constexpr int kRing = kL + kMaxG * 4;
  static constexpr int kRedB = kWarps * kMaxG * D * 4;    // the warps' sums
  static constexpr int kCombB = (kMaxRanges + 2) * kMaxG * 4;
  static constexpr int bytes(int stages) {
    return kRing + (kWarps * stages * kStepB > kRedB ? kWarps * stages * kStepB
                                                     : kRedB);
  }
  // the deepest ring that fits the shared memory (1 step a warp at D = 256)
  static constexpr int kStagesFit =
      (kSmemMax - kRing) / (kWarps * kStepB) < kMaxStages
          ? (kSmemMax - kRing) / (kWarps * kStepB) : kMaxStages;
  // blocks an SM is asked to hold at a one-step ring (registers capped to
  // fit): a decode step's short rows are more blocks than SMs
  static constexpr int kMinBlocks = bytes(1) * 2 <= kSmemMax ? 2 : 1;
  static_assert(kRing % 16 == 0, "the ring must be 16-byte aligned");
  static_assert(kRedB >= kCombB && kRedB >= kThreads * 16,
                "the ring must hold the combine's weights");
  static_assert(kStagesFit >= 1 && bytes(kStagesFit) <= kSmemMax,
                "a step a warp must fit the shared memory");
};

// grid as flash_decode_kernel's; q, k, v bf16; p.stages: each warp's ring
template <int D, int G, bool kCap>
__global__ void __launch_bounds__(kThreads, SmemB<D>::kMinBlocks)
flash_decode_mma(const Params p) {
  using L = SmemB<D>;
  constexpr int KS = D / 16;           // k steps of Q K^T; 16-column P V steps
  constexpr int kUnits = kStep * D / 8;   // 16-byte units of a step's K (or V)
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int last_s;
  bf16* qs = reinterpret_cast<bf16*>(sm + L::kQ);
  unsigned* mask_s = reinterpret_cast<unsigned*>(sm + L::kMask);
  float* wm = reinterpret_cast<float*>(sm + L::kWm);
  float* wl = reinterpret_cast<float*>(sm + L::kWl);
  float* m_s = reinterpret_cast<float*>(sm + L::kM);
  float* l_s = reinterpret_cast<float*>(sm + L::kL);
  float* scratch = reinterpret_cast<float*>(sm + L::kRing);

  const int rg = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.groups;           // the KV head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;       // fragment row, column pair
  const long long bh = (long long)b * gridDim.y + blockIdx.y;  // (row, group)
  const int s0 = rg * p.range;
  const int s1 = min(p.S, s0 + p.range);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  const int nsteps = 2 * ntiles;

  // q's 16 rows (those past G zero), 16 bytes a load, in flight with the
  // slot positions'
  constexpr int kQU = 16 * D / 8;
  constexpr int kQPer = (kQU + kThreads - 1) / kThreads;
  uint4 qv[kQPer];
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int e = tid + i * kThreads, row = e / (D / 8);
    qv[i] = e < kQU && row < G
        ? __ldg(reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(p.q) + bh * G * D) + e)
        : make_uint4(0u, 0u, 0u, 0u);
  }
  {  // the range's slot positions, then a bit per valid slot and tile
    const int len = __ldg(p.lengths + b);
    const int* sp = p.slot_pos + (long long)b * p.S;
    constexpr int kPer = kMaxTiles / kWarps;
    int pos[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = s0 + (i * kWarps + warp) * kTile + lane;
      pos[i] = s < s1 ? __ldg(sp + s) : -1;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = i * kWarps + warp;
      const unsigned bits =
          __ballot_sync(0xffffffffu, pos[i] >= 0 && pos[i] <= len);
      if (lane == 0 && t < ntiles) mask_s[t] = bits;
    }
  }
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < kQU)
      *reinterpret_cast<uint4*>(qs + (e / (D / 8)) * L::kLd + (e % (D / 8)) * 8) =
          qv[i];
  }
  __syncthreads();
  bool busy = false;                   // a valid slot in the range
  for (int t = 0; t < ntiles; ++t) busy |= mask_s[t] != 0u;
  // Q as the A operand: rows g4 and g4 + 8 of its 16 columns at kk, from
  // shared memory at every step (kept in registers they cost a second
  // block an SM)
  const bf16* qa_row = qs + (lane & 15) * L::kLd + (lane >> 4) * 8;

  // this warp's steps: warp, warp + kWarps, ... (16 slots from s0 + 16 i)
  auto bits16 = [&](int i) {
    return (mask_s[i >> 1] >> ((i & 1) * 16)) & 0xffffu;
  };
  auto next_step = [&](int i) {
    while (i < nsteps && bits16(i) == 0u) i += kWarps;
    return i;
  };
  unsigned char* wring = sm + L::kRing + warp * p.stages * L::kStepB;
  const long long row0 = ((long long)b * p.S + s0) * p.Hkv + h;
  // the warp's k-th busy step into ring slot k % stages, one copy group
  // (an empty one past the last); unit e of K (then V) is row e / (D / 8)
  int i_copy = next_step(warp);
  auto issue = [&](int k) {
    const int i = i_copy;
    if (i < nsteps) {
      i_copy = next_step(i + kWarps);
      const unsigned bits = bits16(i);
      bf16* dst = reinterpret_cast<bf16*>(wring + (k % p.stages) * L::kStepB);
#pragma unroll
      for (int isv = 0; isv < 2; ++isv) {
        const bf16* src = static_cast<const bf16*>(isv ? p.v : p.k) +
                          (row0 + (long long)i * kStep * p.Hkv) * D;
#pragma unroll
        for (int n = 0; n < kUnits / 32; ++n) {
          const int e = lane + 32 * n, slot = e / (D / 8), u = e % (D / 8);
          const bool ok = (bits >> slot) & 1u;
          cp_async16(dst + (isv * kStep + slot) * L::kLd + u * 8,
                     ok ? src + (long long)slot * p.Hkv * D + u * 8 : p.k,
                     ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < p.stages; ++k) issue(k);

  // head g4's running max and this lane's share of its sum; its P V sums
  // at columns 8 nt + 2 t4, + 1
  float m_run = kNegInf, l_lane = 0.f;
  float acc[2 * KS][2];
#pragma unroll
  for (int nt = 0; nt < 2 * KS; ++nt) acc[nt][0] = acc[nt][1] = 0.f;
  int k = 0;
  for (int i = next_step(warp); i < nsteps; i = next_step(i + kWarps), ++k) {
    cp_async_wait(p.stages - 1);
    __syncwarp();                      // step k landed, for every lane
    const bf16* ks = reinterpret_cast<const bf16*>(wring + (k % p.stages) * L::kStepB);
    const bf16* vs = ks + kStep * L::kLd;
    // S = Q K^T: slots 2 t4, + 1 (s[0]) and 8 + 2 t4, + 1 (s[1]) of head g4
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], r[4];
      ldsm_x4(qa, qa_row + kk * 16);
      ldsm_x4(r, ks + ((lane >> 4) * 8 + (lane & 7)) * L::kLd + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa, r[0], r[1]);
      mma_bf16(s[1], qa, r[2], r[3]);
    }
    const unsigned bits = bits16(i);
    float v[4] = {s[0][0], s[0][1], s[1][0], s[1][1]};
    float mx = kNegInf;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int slot = (q >> 1) * 8 + 2 * t4 + (q & 1);
      float x = v[q] * p.scale;
      if constexpr (kCap) x = tanhf(x / p.softcap) * p.softcap;
      v[q] = (bits >> slot) & 1u ? x : kNegInf;
      mx = fmaxf(mx, v[q]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_run, mx);
    const float a = expf(m_run - mn);
    float pr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) pr[q] = expf(v[q] - mn);
    l_lane = l_lane * a + ((pr[0] + pr[1]) + (pr[2] + pr[3]));
    m_run = mn;
    // P as the A operand in kPTerms bf16 terms: row g4 at k 2 t4, + 1 and
    // 8 + 2 t4, + 1 (the S fragments' own places); row g4 + 8 zero
    uint32_t lo[kPTerms], hi[kPTerms];
    split_bf16(pr[0], pr[1], lo);
    split_bf16(pr[2], pr[3], hi);
#pragma unroll
    for (int c2 = 0; c2 < KS; ++c2) {  // columns 16 c2 .. 16 c2 + 15
      uint32_t r[4];
      ldsm_x4_t(r, vs + (lane & 15) * L::kLd + c2 * 16 + (lane >> 4) * 8);
      float f0[4] = {}, f1[4] = {};
#pragma unroll
      for (int e = kPTerms - 1; e >= 0; --e) {   // the small terms first
        const uint32_t pa[4] = {lo[e], 0u, hi[e], 0u};
        mma_bf16(f0, pa, r[0], r[1]);
        mma_bf16(f1, pa, r[2], r[3]);
      }
      acc[2 * c2][0] = acc[2 * c2][0] * a + f0[0];
      acc[2 * c2][1] = acc[2 * c2][1] * a + f0[1];
      acc[2 * c2 + 1][0] = acc[2 * c2 + 1][0] * a + f1[0];
      acc[2 * c2 + 1][1] = acc[2 * c2 + 1][1] * a + f1[1];
    }
    __syncwarp();                      // every lane read ring slot k
    issue(k + p.stages);
  }
  cp_async_wait(0);
  float l = l_lane;                    // head g4's sum: its 4 lanes
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (t4 == 0 && g4 < G) {
    wm[warp * kMaxG + g4] = m_run;
    wl[warp * kMaxG + g4] = l;
  }
  __syncthreads();                     // every warp's ring is free
  float* red = scratch;                // (kWarps, kMaxG, D) the warps' sums
  if (g4 < G) {
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt)
      *reinterpret_cast<float2*>(red + (warp * kMaxG + g4) * D + nt * 8 +
                                 2 * t4) = make_float2(acc[nt][0], acc[nt][1]);
  }
  // head g's range max M over the warps, each warp's weight exp(m_w - M),
  // the range's sum, the warps in order
  if (tid < G) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxG + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * kMaxG + tid] - M);
      sum = fmaf(e, wl[w * kMaxG + tid], sum);
      wm[w * kMaxG + tid] = e;
    }
    m_s[tid] = M;
    l_s[tid] = sum;
  }
  __syncthreads();
  // the range's acc of element e = (g, float4 column): the warps in order
  auto range_acc = [&](int e) {
    const int g = e / (D / 4), cc = e % (D / 4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      fma4(o, wm[w * kMaxG + g],
           reinterpret_cast<const float4*>(red + (w * kMaxG + g) * D)[cc]);
    return o;
  };
  finish_range<D, G, bf16>(p, b, h, bh, rg, busy, m_s, l_s, scratch, last_s,
                           range_acc);
}

template <int D, int G, bool kCap>
int launch_mma(const Params& p, int B, cudaStream_t st) {
  using L = SmemB<D>;
  if (p.stages > L::kStagesFit) return (int)cudaErrorInvalidValue;
  static unsigned long long ready = 0;   // the shared-memory opt-in, once
  int dev = 0;                           // per device
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_mma<D, G, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(L::kStagesFit));
    if (e != cudaSuccess) return (int)e;
    ready |= bit;
  }
  flash_decode_mma<D, G, kCap><<<dim3(p.ranges, p.Hkv * p.groups, B),
                                  kThreads, L::bytes(p.stages), st>>>(p);
  return (int)cudaGetLastError();
}
#endif  // FLASH_DECODE_BF16

template <int D, int G, bool kCap, typename T>
int launch(const Params& p, int B, cudaStream_t st) {
#ifdef FLASH_DECODE_BF16
  if constexpr (!std::is_same<T, float>::value) {
    return launch_mma<D, G, kCap>(p, B, st);
  } else
#endif
  {
  using L = Smem<D>;
  if (p.stages > L::kStagesFit) return (int)cudaErrorInvalidValue;
  static unsigned long long ready = 0;   // the shared-memory opt-in, once
  int dev = 0;                           // per device
  cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<D, G, kCap, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes(L::kStagesFit));
    if (e != cudaSuccess) return (int)e;
    ready |= bit;
  }
  flash_decode_kernel<D, G, kCap, T><<<dim3(p.ranges, p.Hkv * p.groups, B),
                                       kThreads, L::bytes(p.stages), st>>>(p);
  return (int)cudaGetLastError();
  }
}

// G, the query heads of a block, is a compile-time constant of the kernel,
// so that its loops over heads unroll whole
template <int D, bool kCap, typename T>
int launch_g(const Params& p, int B, cudaStream_t st) {
  switch (p.G) {
    case 1: return launch<D, 1, kCap, T>(p, B, st);
    case 2: return launch<D, 2, kCap, T>(p, B, st);
    case 3: return launch<D, 3, kCap, T>(p, B, st);
    case 4: return launch<D, 4, kCap, T>(p, B, st);
    case 5: return launch<D, 5, kCap, T>(p, B, st);
    case 6: return launch<D, 6, kCap, T>(p, B, st);
    case 7: return launch<D, 7, kCap, T>(p, B, st);
    case 8: return launch<D, 8, kCap, T>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D, typename T>
int launch_cap(const Params& p, int B, cudaStream_t st) {
  return p.softcap > 0.f ? launch_g<D, true, T>(p, B, st)
                         : launch_g<D, false, T>(p, B, st);
}

template <typename T>
int fwd(const T* q, const T* k, const T* v, const int* slot_pos,
        const int* lengths, float* out, float* parts, long long parts_floats,
        int* counts, long long count_ints, int B, int S, int Hkv, int G, int D,
        int range, int stages, int groups, float scale, float softcap,
        void* stream) {
  // fp32: a ring of one tile holds a one-tile range only; bf16's ring is
  // each warp's and holds one step at least
  const bool one_ok = !std::is_same<T, float>::value || range == kTile;
  if (B < 1 || S < 1 || Hkv < 1 || G < 1 || groups < 1 || G % groups ||
      !(softcap >= 0.f) ||
      G / groups > kMaxG || stages < kMinStages ||
      stages > kMaxStages || (stages < 2 && !one_ok) || range < kTile ||
      range % kTile || range > kMaxTiles * kTile)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.slot_pos = slot_pos;
  p.lengths = lengths;
  p.out = out;
  p.parts = parts;
  p.counts = counts;
  p.S = S;
  p.Hkv = Hkv;
  p.G = G / groups;
  p.groups = groups;
  p.range = range;
  p.ranges = (S + range - 1) / range;
  p.stages = stages;
  p.scale = scale;
  p.softcap = softcap;
  if (p.ranges > kMaxRanges) return (int)cudaErrorInvalidValue;
  if (p.ranges > 1 &&
      (!parts || !counts || count_ints < (long long)B * Hkv * groups ||
       parts_floats < (long long)B * Hkv * p.ranges * G * (D + 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_cap<32, T>(p, B, st);
    case 64: return launch_cap<64, T>(p, B, st);
    case 128: return launch_cap<128, T>(p, B, st);
    case 256: return launch_cap<256, T>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hkv, G, D), k and v (B, S, Hkv, D) fp32, 16-byte aligned;
// slot_pos (B, S) and lengths (B,) int32; out (B, Hkv, G, D). Ranges of
// `range` slots (a multiple of 32, at most 2048; the last one takes the
// rest of S); a ring of `stages` tiles (1 to 6, to 3 at D = 256; 1 only
// where a range is one tile); a KV head's G query heads in `groups` blocks
// of G / groups <= 8 heads. With more than one range, parts holds parts_floats floats (at
// least B*Hkv*ranges*G*(D + 2)) and counts count_ints ints (at least
// B*Hkv*groups, all 0; they are 0 again when the launch ends); softcap > 0
// caps the valid scaled scores (0: no cap). Returns a cudaError_t (0 on
// success).
#ifndef FLASH_DECODE_BF16
extern "C" int flash_decode_fwd(const float* q, const float* k,
                                const float* v, const int* slot_pos,
                                const int* lengths, float* out, float* parts,
                                long long parts_floats, int* counts,
                                long long count_ints, int B, int S, int Hkv,
                                int G, int D, int range, int stages,
                                int groups, float scale, float softcap,
                                void* stream) {
  return fwd<float>(q, k, v, slot_pos, lengths, out, parts, parts_floats,
                    counts, count_ints, B, S, Hkv, G, D, range, stages, groups,
                    scale, softcap, stream);
}
#else

// The same with q, k and v bf16 (16-byte aligned), on the tensor cores
// (flash_decode_mma); `stages` is each warp's ring of 16-slot steps (1 to 6,
// 3 at D = 128, 1 at D = 256); the ranges, head groups and fp32 output as
// flash_decode_fwd's. It is built from flash_decode_bf16.cu, this file with
// FLASH_DECODE_BF16 defined, so that the two forms' template instances
// compile in parallel.
extern "C" int flash_decode_fwd_bf16(const void* q, const void* k,
                                     const void* v, const int* slot_pos,
                                     const int* lengths, float* out,
                                     float* parts, long long parts_floats,
                                     int* counts, long long count_ints, int B,
                                     int S, int Hkv, int G, int D, int range,
                                     int stages, int groups, float scale,
                                     float softcap, void* stream) {
  using bf16 = __nv_bfloat16;
  return fwd<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), slot_pos, lengths, out, parts,
                   parts_floats, counts, count_ints, B, S, Hkv, G, D, range,
                   stages, groups, scale, softcap, stream);
}
#endif  // FLASH_DECODE_BF16
