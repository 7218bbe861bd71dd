// ATU cache-unit update: copies groups of bank columns into a compact unit.
//
// Replaces: src/repro/kernels/atu_update.py::_atu_kernel (the Pallas TPU
// kernel behind `atu_update`, paper §5.3). Same function: bank (d, f), unit
// (d, k), src and dst (m,) int32 with m % bg == 0 and m <= k; group g
// copies bank columns [src[g*bg] / bg * bg, + bg) into unit columns
// [dst[g*bg] / bg * bg, + bg), cast to the unit's type. Only each group's
// first entry is read; columns no group names keep their bytes (the
// Pallas call aliases the unit to its output; here the unit is updated in
// place).
//
// Duplicate destinations: the Pallas grid runs its groups in order, so when
// two groups name the same destination block the later one wins. Blocks
// here run in no order, so a group that a later group overwrites is
// skipped: each block first checks the later groups' destinations (m / bg
// ints, read once per block) and returns if one equals its own.
//
// What bounds it on an H100: it moves d * bg elements per group, read once
// and written once, and computes nothing, so it is bound by device-memory
// bytes. A group's rows are bg contiguous elements (32 bytes of fp32) a
// row stride apart in both bank and unit, so each warp's access covers four
// rows of one 32-byte sector each: every byte of a sector it touches is
// used, and the copy can reach the memory rate once enough groups are in
// flight.
//
// Design: grid (groups, row tiles of 32 rows); 256 threads, one element
// each: thread t copies row t / bg, column t % bg of its tile. Element
// types are template parameters: a bitwise copy when bank and unit share a
// type (1, 2 or 4 bytes) and int8 -> float32 as a cast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
atu_copy(const S* __restrict__ bank, D* __restrict__ unit,
         const int* __restrict__ src, const int* __restrict__ dst, int d,
         int f, int k, int groups, int bg) {
  const int g = blockIdx.x;
  const int d0 = dst[g * bg];
  const int dbase = d0 / bg * bg;
  __shared__ int later;
  if (threadIdx.x == 0) later = 0;
  __syncthreads();
  for (int h = g + 1 + threadIdx.x; h < groups; h += blockDim.x)
    if (dst[h * bg] / bg * bg == dbase) later = 1;   // benign race: all write 1
  __syncthreads();
  if (later) return;
  const int s0 = src[g * bg];
  const int sbase = s0 / bg * bg;
  // a group outside bank or unit is not copied (the wrapper's plain version
  // refuses it; the Pallas block index would be out of range)
  if (s0 < 0 || sbase + bg > f || d0 < 0 || dbase + bg > k) return;
  const int rows_per_block = blockDim.x / bg;
  const int r = blockIdx.y * rows_per_block + threadIdx.x / bg;
  const int c = threadIdx.x % bg;
  if (threadIdx.x >= rows_per_block * bg || r >= d) return;
  unit[(long long)r * k + dbase + c] = (D)bank[(long long)r * f + sbase + c];
}

template <typename S, typename D>
int launch(const void* bank, void* unit, const int* src, const int* dst,
           int d, int f, int k, int groups, int bg, cudaStream_t st) {
  const int rows_per_block = kThreads / bg;
  dim3 grid(groups, (d + rows_per_block - 1) / rows_per_block);
  atu_copy<S, D><<<grid, kThreads, 0, st>>>((const S*)bank, (D*)unit, src,
                                            dst, d, f, k, groups, bg);
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
      return launch<int8_t, int8_t>(bank, unit, src, dst, d, f, k, groups, bg,
                                    st);
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
