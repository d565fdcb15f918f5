// Blocked quantized matmul (weight-only int8 and W8A8) for Hopper (sm_90a).
//
// Replaces repro/kernels/quant_matmul.py::_kernel (the Pallas TPU kernel
// behind quant_matmul_kernel / quant_matmul, and the S == 0 fallback of
// ocs_quant_matmul): y = (x @ w8) * (x_scale[m] * w_scale[n]) with
//   * x f32 or bf16: weight-only, int8 weights converted to f32 in
//     registers, f32 accumulation. Every linear layer of a clip-only tree
//     (ocs_ratio = 0, the paper's baseline) served in "dequant" mode;
//   * x int8: int8 x int8 -> int32.
//
// What bounds it on this card: as ocs_matmul.cu -- the int8 weight bytes at
// decode, the f32 CUDA-core FMAs at prefill (a later version can move the
// exact bf16 x int8 products onto bf16 tensor cores under the same
// contract).
//
// Design: the kernels of ocs_matmul.cu with no OCS tail (S = 0), from
// qmatmul_common.cuh: the weight-only split-K GEMM with a fixed-order f32
// reduction, or B1's __dp4a GEMM; then the epilogue. The int8 path reads x
// in place when K % 16 == 0 and otherwise copies it once into a
// zero-padded [M, Kp] buffer.

#include "qmatmul_common.cuh"

// Weight-only. x_bf16: 1 if x is bfloat16, 0 if float32. xs [M], ws [N]
// f32; part [nsplit, M, N] f32 scratch with k_chunk * nsplit >= K.
// Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_wo_launch(
    const void* x, int x_bf16, int M, int K, const int8_t* w8, const float* xs,
    const float* ws, int N, int k_chunk, int nsplit, float* part, void* out,
    int out_bf16, void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return wo_matmul_path<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, 0,
                                         nullptr, nullptr, w8, xs, ws, N, k_chunk, nsplit,
                                         part, out, out_bf16, st);
  }
  return wo_matmul_path<float>(static_cast<const float*>(x), M, K, 0, nullptr, nullptr,
                               w8, xs, ws, N, k_chunk, nsplit, part, out, out_bf16, st);
}

// int8. q: [M, Kp] int8 scratch (Kp = K rounded up to 16), or null when
// K % 16 == 0 (x is read in place, Kp = K); acc [M, N] int32 scratch.
// Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_int8_launch(
    const int8_t* x, int M, int K, const int8_t* w8, const float* xs, const float* ws,
    int N, int8_t* q, int Kp, int* acc, void* out, int out_bf16, void* stream) {
  return rtq::int8_matmul_path(x, M, K, 0, nullptr, nullptr, w8, xs, ws, N, q, Kp, acc,
                               out, out_bf16, static_cast<cudaStream_t>(stream));
}
