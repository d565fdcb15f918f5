// Per-row dynamic int8 quantization for Hopper (sm_90a).
//
// Replaces repro/kernels/dynamic_quant.py::_kernel (the Pallas TPU kernel
// behind dynamic_quant_kernel / dynamic_quant): for each row of x [M, K],
// scale = max(amax, 1e-30) * float32(1/qmax) and
// q = clamp(floor(x / scale + 0.5), -qmax, qmax) as int8, scale as f32.
//
// What bounds it on this card: bytes. It reads x once and writes a quarter
// (bf16 in) or an eighth (f32 in) of that back; the arithmetic is a few
// operations per element.
//
// Design. The TPU kernel keeps [bm, K] rows resident in VMEM and falls back
// to two XLA passes when they do not fit; here one block of 256 threads
// takes one row at any K: a strided abs-max pass (warp shuffles, then the 8
// warps in shared memory), then a quantize pass over the same row, which a
// block of this size reads back from L1/L2 rather than from device memory
// at serving widths. The kernel is B1's row prologue with no OCS tail
// (row_quant_kernel in qmatmul_common.cuh), so both round identically.
//
// Numerics: bitwise the plain version (the division and the add are the _rn
// intrinsics; no fast-math).

#include "qmatmul_common.cuh"

// x_bf16: 1 if x is bfloat16, 0 if float32. q [M, K] int8 and scale [M] f32
// come from the caller. Returns cudaGetLastError() (0 = ok).
extern "C" int dynamic_quant_launch(const void* x, int x_bf16, int M, int K, float qmax,
                                    float inv_qmax, int8_t* q, float* scale,
                                    void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    row_quant_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, 0, K, nullptr, M, qmax, inv_qmax, q, scale);
  } else {
    row_quant_kernel<float><<<M, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), K, 0, K, nullptr, M, qmax, inv_qmax, q, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
