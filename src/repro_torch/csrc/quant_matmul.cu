// Blocked quantized matmul (weight-only int8 and W8A8) for Hopper (sm_90a).
//
// Replaces repro/kernels/quant_matmul.py::_kernel (the Pallas TPU kernel
// behind quant_matmul_kernel / quant_matmul, and the S == 0 fallback of
// ocs_quant_matmul): y = (x @ w8) * (x_scale[m] * w_scale[n]) with
//   * x bf16: weight-only on bf16 tensor cores, wo_tc_gemm.cuh's
//     wo_tc_gemm_kernel (the decode tile) or wo_tc_prefill.cuh's
//     wo_tc_prefill_kernel (the prefill tile) without the OCS tail (B4,
//     ocs_matmul.cu, runs the same kernels with it). Every linear layer of a clip-only tree
//     (ocs_ratio = 0, the paper's baseline) served in "dequant" mode;
//   * x f32 (no serving caller; its products are not exact in bf16):
//     weight-only on the CUDA cores, qmatmul_common.cuh's wo_gemm_kernel,
//     which ocs_matmul.cu (B4) shares;
//   * x int8: int8 x int8 -> int32 (qmatmul_common.cuh's __dp4a GEMM, bitwise).
//
// What bounds it on this card, why the tensor cores keep the weight-only
// contract, and the design of the tensor-core GEMM: wo_tc_gemm.cuh and
// wo_tc_prefill.cuh.
//
// The int8 path reads x in place when K % 16 == 0 and otherwise copies it
// once into a zero-padded [M, Kp] buffer.

#include "wo_tc_prefill.cuh"

// Weight-only, bf16 x, on the tensor cores (no OCS tail), over E experts
// of M rows each (E = 1: a 2-D call; E > 1: a MoE layer's stacked matrix in
// one launch, the vmapped call of the reference): tile 0 is wo_tc_gemm.cuh's
// decode tile, 1 wo_tc_prefill.cuh's prefill tile (the wrapper's tc_plan of
// one expert's shapes, so each expert's output is bitwise the 2-D call on
// it). x [E, M, K], w8 [E, K, N], xs [E, M] f32 or null (= 1), ws [E, N]
// f32, out [E, M, N]; k_chunk % 32 == 0 with k_chunk * nsplit >= K; part [E,
// nsplit, M, N] f32 scratch (unused with one split, or the prefill tile);
// counters: one int per (expert, token tile, column tile) of the launch,
// zero at rest (the kernels leave them zero). A stack needs N % 16 == 0 and
// K % 8 == 0. Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_tc_launch(
    const void* x, int E, int M, int K, const int8_t* w8, const float* xs, const float* ws,
    int N, int k_chunk, int nsplit, int tile, float* part, int* counters, void* out,
    int out_bf16, void* stream) {
  return rtq::wo_tc_tile_launch<false>(x, E, M, K, 0, nullptr, nullptr, w8, xs, ws, N, k_chunk,
                                       nsplit, tile, part, counters, out, out_bf16, stream);
}

// Weight-only on the CUDA cores (qmatmul_common.cuh's wo_gemm_kernel, B4's
// kernel with S = 0): the f32-x path (bf16 x takes the tensor cores).
// x_bf16 must be 0 (the argument keeps B4's calling convention). xs [M]
// f32 or null (= 1), ws [N] f32; part [nsplit, M, N] f32 scratch with
// k_chunk * nsplit >= K. Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for bf16 x.
extern "C" int quant_matmul_wo_launch(
    const void* x, int x_bf16, int M, int K, const int8_t* w8, const float* xs,
    const float* ws, int N, int k_chunk, int nsplit, float* part, void* out,
    int out_bf16, void* stream) {
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return rtq::wo_matmul_path<float>(static_cast<const float*>(x), M, K, 0, nullptr, nullptr,
                                    w8, xs, ws, N, k_chunk, nsplit, part, out, out_bf16,
                                    static_cast<cudaStream_t>(stream));
}

// int8. q: [M, Kp] int8 scratch (Kp = K rounded up to 16), or null when
// K % 16 == 0 (x is read in place, Kp = K); acc [M, N] int32 scratch; xs
// [M] or null (= 1). Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_int8_launch(
    const int8_t* x, int M, int K, const int8_t* w8, const float* xs, const float* ws,
    int N, int8_t* q, int Kp, int* acc, void* out, int out_bf16, void* stream) {
  return rtq::int8_matmul_path(x, M, K, 0, nullptr, nullptr, w8, xs, ws, N, q, Kp, acc,
                               out, out_bf16, static_cast<cudaStream_t>(stream));
}
