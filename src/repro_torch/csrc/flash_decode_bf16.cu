// Flash-decoding attention over bf16 q, k and v: the bf16 form of
// flash_decode.cu, built as a library of its own.
//
// Replaces: src/repro/kernels/flash_decode.py::_flash_kernel at bf16 inputs
// (the reference's default precision; the Pallas kernel widens q, k and v to
// fp32 and writes fp32).
//
// What bounds it on an H100: as the fp32 form, the valid slots' K and V
// bytes, here 2 bytes a value (half the fp32 form's).
//
// Design: flash_decode.cu's own source with FLASH_DECODE_BF16 defined, which
// compiles its kernels at T = __nv_bfloat16 and its extern "C" entry point
// flash_decode_fwd_bf16 in place of the fp32 one. It is a unit of its own so
// that the two forms' template instances (D x G x softcap each) compile in
// parallel, which halves the longest kernel build.
#define FLASH_DECODE_BF16
#include "flash_decode.cu"
