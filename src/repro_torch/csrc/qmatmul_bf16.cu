// Gathered quantized matmul with bf16 x and a bf16 fp tier: the bf16 form of
// qmatmul.cu, built as a library of its own.
//
// Replaces: src/repro/kernels/qmatmul.py::_qmm_kernel at bf16 inputs (the
// reference's default precision; the Pallas kernel widens x and the bank to
// fp32 and writes fp32), in the gathered form the M2Cache FFN needs.
//
// What bounds it on an H100: as the fp32 form, the active rows' bytes at
// small M (the fp tier 2 bytes a value here) and the products at large M.
//
// Design: qmatmul.cu's own source with QMATMUL_BF16 defined, which compiles
// kernels A and B at XT = __nv_bfloat16 (the fp tier kBf16) and its
// extern "C" entry point qmm_gathered_bf16 in place of the fp32 one. It is a
// unit of its own so that the two forms' template instances compile in
// parallel.
#define QMATMUL_BF16
#include "qmatmul.cu"
