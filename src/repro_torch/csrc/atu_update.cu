// ATU cache-unit update: copies groups of bank columns into a compact unit.
//
// Replaces: src/repro/kernels/atu_update.py::_atu_kernel (the Pallas TPU
// kernel behind `atu_update`, paper §5.3). Same function: bank (d, f), unit
// (d, k), src and dst (m,) int32 with m % bg == 0 and m <= k; group g
// copies bank columns [src[g*bg] / bg * bg, + bg) into unit columns
// [dst[g*bg] / bg * bg, + bg), cast to the unit's type. Only each group's
// first entry is read; columns no group names keep their bytes (the
// Pallas call aliases the unit to its output; here the unit is updated in
// place). A group outside bank or unit is skipped (the wrapper's plain
// version refuses it; the Pallas block index would be out of range).
//
// Duplicate destinations: the Pallas grid runs its groups in order, so when
// two groups name the same destination block the later one wins. Blocks
// here run in no order, so a group that a later group (one inside bank and
// unit) overwrites is not stored: each block checks the later groups'
// destinations (m / bg ints), overlapped with its own loads.
//
// What bounds it on an H100: it moves d * bg elements per group, read once
// and written once, and computes nothing, so it is bound by device-memory
// bytes. But a group's rows are bg contiguous elements (32 bytes of fp32 at
// bg = 8) a row stride apart in both bank and unit, each row its own
// sector, and the card serves such sectors far below its streaming rate:
// at the ATU row's shape a plain copy of the same 32-byte rows, with no
// check, reaches ~0.9 TB/s in this order and ~1.1 TB/s with a row's groups
// on neighbouring threads; the TMA moves them at ~1.0 (against ~2.6 for a
// contiguous copy cold; scripts/atu_copy_probe.py).
//
// Design: each thread moves kItems words of up to 16 bytes ("items"): a
// group's rows are cut into items of C elements, the most (up to 16 bytes
// on either side) that divide the row, both row strides and both
// pointers' alignment, numbered row by row; a block takes kThreads *
// kItems consecutive items of one group, item u of thread t being t + u *
// kThreads (a warp's loads cover whole sectors). A block issues all its
// loads, then checks for a later duplicate (__syncthreads_or), then
// stores: the loads are in flight while it checks. Grid: groups x ceil(
// items of a group / items of a block) blocks, one launch. The plan (C,
// the blocks) is a function of (d, f, k, m, bg, kind) and the pointers'
// alignment, which is 256 bytes for every tensor PyTorch allocates.
// Element types: a bitwise copy when bank and unit share a type (1, 2 or 4
// bytes) and int8 -> float32 as a cast.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;   // items a thread moves

// an unsigned word of N bytes
template <int N> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

template <typename E, int C>
using Item = typename Word<C * sizeof(E)>::T;

// an item of C elements S as C elements D
template <typename S, typename D, int C>
__device__ __forceinline__ Item<D, C> convert(Item<S, C> v) {
  if constexpr (std::is_same<S, D>::value) {
    return v;
  } else {
    S s[C];
    D o[C];
    memcpy(s, &v, sizeof(v));
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = (D)s[c];
    Item<D, C> r;
    memcpy(&r, o, sizeof(r));
    return r;
  }
}

__device__ __forceinline__ bool inside(int s0, int d0, int bg, int f, int k) {
  return s0 >= 0 && d0 >= 0 && s0 / bg * bg + bg <= f && d0 / bg * bg + bg <= k;
}

// row_shift: log2(items a row); tiles: blocks a group
template <typename S, typename D, int C>
__global__ void __launch_bounds__(kThreads)
atu_copy(const Item<S, C>* __restrict__ bank, Item<D, C>* __restrict__ unit,
         const int* __restrict__ src, const int* __restrict__ dst, int d,
         int f, int k, int groups, int bg, int row_shift, int tiles) {
  const int g = blockIdx.x / tiles;
  const int s0 = __ldg(src + (long long)g * bg);
  const int d0 = __ldg(dst + (long long)g * bg);
  if (!inside(s0, d0, bg, f, k)) return;
  const long long sbase = s0 / bg * bg / C, dbase = d0 / bg * bg / C;
  const int row_mask = (1 << row_shift) - 1;
  const long long total = (long long)d << row_shift;
  const long long first =
      (long long)(blockIdx.x % tiles) * (kThreads * kItems) + threadIdx.x;

  Item<S, C> v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long i = first + u * kThreads;
    if (i < total)
      v[u] = __ldg(bank + (i >> row_shift) * (f / C) + sbase + (i & row_mask));
  }
  // a later group inside bank and unit with the same destination wins
  int later = 0;
  for (int h = g + 1 + threadIdx.x; h < groups; h += kThreads) {
    const int hs = __ldg(src + (long long)h * bg);
    const int hd = __ldg(dst + (long long)h * bg);
    later |= inside(hs, hd, bg, f, k) && hd / bg == d0 / bg;
  }
  if (__syncthreads_or(later)) return;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long i = first + u * kThreads;
    if (i < total)
      unit[(i >> row_shift) * (k / C) + dbase + (i & row_mask)] =
          convert<S, D, C>(v[u]);
  }
}

// The plan: items of the largest power of two C <= 16 bytes on either side
// that divides bg, f, k and both pointers' alignment in elements.
template <typename S, typename D,
          int C = 16 / (sizeof(S) > sizeof(D) ? sizeof(S) : sizeof(D))>
int launch(const void* bank, void* unit, const int* src, const int* dst,
           int d, int f, int k, int groups, int bg, cudaStream_t st) {
  if constexpr (C > 1) {
    if (bg % C || f % C || k % C || (uintptr_t)bank % (C * sizeof(S)) ||
        (uintptr_t)unit % (C * sizeof(D)))
      return launch<S, D, C / 2>(bank, unit, src, dst, d, f, k, groups, bg,
                                 st);
  }
  int row_shift = 0;
  while ((C << row_shift) < bg) ++row_shift;
  const long long per_group = (long long)d << row_shift;
  const int tiles =
      (int)((per_group + kThreads * kItems - 1) / (kThreads * kItems));
  const long long blocks = (long long)groups * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  atu_copy<S, D, C><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const Item<S, C>*)bank, (Item<D, C>*)unit, src, dst, d, f, k, groups,
      bg, row_shift, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 1, 2 or 4 = bitwise copy of that element size; 5 = int8 -> float32.
// bg must divide 256. Returns a cudaError_t (0 on success).
extern "C" int atu_update(const void* bank, void* unit, const int* src,
                          const int* dst, int d, int f, int k, int m, int bg,
                          int kind, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bg < 1 || bg > kThreads || kThreads % bg || m % bg)
    return (int)cudaErrorInvalidValue;
  const int groups = m / bg;
  if (groups == 0 || d == 0) return 0;
  switch (kind) {
    case 1:
      return launch<uint8_t, uint8_t>(bank, unit, src, dst, d, f, k, groups,
                                      bg, st);
    case 2:
      return launch<uint16_t, uint16_t>(bank, unit, src, dst, d, f, k, groups,
                                        bg, st);
    case 4:
      return launch<uint32_t, uint32_t>(bank, unit, src, dst, d, f, k, groups,
                                        bg, st);
    case 5:
      return launch<int8_t, float>(bank, unit, src, dst, d, f, k, groups, bg,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
