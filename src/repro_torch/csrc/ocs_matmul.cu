// Quantized matmul with fused OCS channel expansion for Hopper (sm_90a).
//
// Replaces repro/kernels/ocs_matmul.py::_kernel (the Pallas TPU kernel
// behind ocs_matmul_kernel / ocs_quant_matmul):
//     y = (x @ W_exp[:K] + x_tail @ W_exp[K:]) * (x_scale[m] * w_scale[n])
// with x_tail = x[:, src_tail] * tail_mult, in one accumulator, without the
// expanded activations [x | x_tail] ever going through device memory. Two
// modes, as in the TPU kernel:
//   * weight-only (x f32 or bf16): the int8 weights are converted to f32 in
//     registers and the products summed in f32. This is every linear layer
//     of the engine's default "dequant" mode.
//   * int8 (x int8, tail_mult a 0/1 mask): int8 x int8 -> int32.
//
// What bounds it on this card. At decode (M = 8) the int8 weight bytes over
// HBM bandwidth: one glm4-9b layer is ~207 MB, the lm_head ~633 MB, ~8.95
// GB a step, 2.7 ms at 3.35 TB/s. Every int8 weight is exact in bf16 and a
// bf16 x int8 product is exact in f32 (8 + 7 significant bits), so the same
// contract can later run on bf16 tensor cores with f32 accumulation
// (mma/wgmma, 989 TFLOP/s); this first version multiplies on the f32 CUDA
// cores (67 TFLOP/s), which bound it at prefill (M = 256).
//
// Design (the kernels are in qmatmul_common.cuh, shared with quant_matmul.cu,
// which is this file with S = 0):
//   * weight-only: wo_gemm_kernel. A block of 256 threads owns 256 output
//     columns and up to 8 rows; it stages its x rows for 128 rows of K at a
//     time in shared memory as f32, gathering the OCS tail rows there as
//     x[m, src_tail[j]] * tail_mult[j]; each thread reads one 32-bit word of
//     weights (4 columns) per K row, coalesced along N, converts the 4 bytes
//     and issues 4 x TM FMAs. K is split over 4 warps of the block (added in
//     shared memory in a fixed order) and over blockIdx.z so that decode's
//     small grids (wk/wv have N = 256: one column block) still fill the 132
//     SMs; the splits write f32 partial sums to a workspace [splits, M, N]
//     that the epilogue adds in a fixed order -- no float atomics, so a
//     call's output is the same from run to run and greedy tokens do not
//     wander.
//   * int8: the expanded int8 row is written once to a small [M, Kp]
//     buffer (copy, tail gather times the mask, zero padding), then B1's
//     __dp4a GEMM (exact int32, split K through atomics) and the epilogue.
// The epilogue is acc * (x_scale[m] * w_scale[n]), grouped as the TPU
// kernel groups it, rounded once to the output type (f32 or bf16).

#include "qmatmul_common.cuh"

// Weight-only. x_bf16: 1 if x is bfloat16, 0 if float32. tail_mult may be
// null (= 1). xs [M] f32 or null (= 1), ws [N] f32; part [nsplit, M, N]
// f32 scratch with k_chunk * nsplit >= K + S. Returns cudaGetLastError()
// (0 = ok).
extern "C" int ocs_matmul_wo_launch(
    const void* x, int x_bf16, int M, int K, int S, const int* src_tail,
    const float* tail_mult, const int8_t* w8, const float* xs, const float* ws,
    int N, int k_chunk, int nsplit, float* part, void* out, int out_bf16,
    void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return wo_matmul_path<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), M, K, S,
                                         src_tail, tail_mult, w8, xs, ws, N, k_chunk,
                                         nsplit, part, out, out_bf16, st);
  }
  return wo_matmul_path<float>(static_cast<const float*>(x), M, K, S, src_tail,
                               tail_mult, w8, xs, ws, N, k_chunk, nsplit, part, out,
                               out_bf16, st);
}

// int8. mask [S] 0/1 bytes or null; q [M, Kp] int8 and acc [M, N] int32
// scratch (Kp = K + S rounded up to 16). Returns cudaGetLastError().
extern "C" int ocs_matmul_int8_launch(
    const int8_t* x, int M, int K, int S, const int* src_tail, const int8_t* mask,
    const int8_t* w8, const float* xs, const float* ws, int N, int8_t* q, int Kp,
    int* acc, void* out, int out_bf16, void* stream) {
  return rtq::int8_matmul_path(x, M, K, S, src_tail, mask, w8, xs, ws, N, q, Kp, acc,
                               out, out_bf16, static_cast<cudaStream_t>(stream));
}
