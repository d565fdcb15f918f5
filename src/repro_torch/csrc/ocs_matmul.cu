// Quantized matmul with fused OCS channel expansion for Hopper (sm_90a).
//
// Replaces repro/kernels/ocs_matmul.py::_kernel (the Pallas TPU kernel
// behind ocs_matmul_kernel / ocs_quant_matmul):
//     y = (x @ W_exp[:K] + x_tail @ W_exp[K:]) * (x_scale[m] * w_scale[n])
// with x_tail = x[:, src_tail] * tail_mult, in one accumulator, without the
// expanded activations [x | x_tail] ever going through device memory. Three
// routes, chosen by the wrapper from the operands and the caller's
// declaration (never by a failure, never by reading the device):
//   * weight-only, bf16 x, tail_mult absent or declared a 0/1 mask: every
//     linear layer of the engine's default "dequant" mode. B5's bf16
//     tensor-core GEMM (wo_tc_gemm.cuh's decode tile, or for calls of many
//     rows wo_tc_prefill.cuh's prefill tile) with the OCS tail gathered
//     inside it (ocs_matmul_tc_launch): the weights stay the one [K + S, N]
//     int8 tensor behind one TMA map, the contraction walks Kb + S virtual
//     rows (Kb = K rounded up to 32), and a tail stage's token operand is
//     gathered as x[m, src_tail[j]] * tail_mult[j], exact in bf16 (by the
//     decode tile's threads into their B fragments, by the prefill tile's
//     producer warp into the stage's shared-memory slot). One launch a
//     call, the epilogue fused.
//   * weight-only, f32 x or multipliers not declared a mask (products that
//     need not be exact in bf16): qmatmul_common.cuh's wo_gemm_kernel on
//     the CUDA cores. A block of 256 threads owns 256 output columns and up
//     to 8 rows; it stages its x rows for 128 rows of K at a time in shared
//     memory as f32, gathering the OCS tail rows there as x[m, src_tail[j]]
//     * tail_mult[j]; f32 FMAs; split K writes f32 partial sums to a
//     workspace [splits, M, N] that the epilogue launch adds in a fixed
//     order.
//   * int8 (x int8, tail_mult a 0/1 mask): the expanded int8 row is written
//     once to a small [M, Kp] buffer (copy, tail gather times the mask,
//     zero padding), then qmatmul_common.cuh's __dp4a GEMM (exact int32, split K through
//     atomics) and the epilogue.
// The epilogue is acc * (x_scale[m] * w_scale[n]), grouped as the TPU
// kernel groups it, rounded once to the output type (f32 or bf16). Every
// route's split of K follows from (K, S, N) alone, never from M, so a
// row's bits do not depend on how many rows the call holds.
//
// What bounds it on this card. At decode (M = 8) the int8 weight bytes over
// HBM bandwidth: one glm4-9b layer is ~207 MB, the lm_head ~633 MB, ~8.95
// GB a step, 2.7 ms at 3.35 TB/s. At prefill (M = 256) the products: on the
// bf16 tensor cores (989 TFLOP/s) on the serving route, on the f32 CUDA
// cores (67 TFLOP/s) on the other weight-only one.

#include "wo_tc_prefill.cuh"

// Weight-only, bf16 x, on the tensor cores, over E experts of M rows each
// (E = 1: a 2-D call; E > 1: a MoE layer's stacked matrix in one launch, the
// vmapped call of the reference): tile 0 is wo_tc_gemm.cuh's decode tile, 1
// wo_tc_prefill.cuh's prefill tile (the wrapper's tc_plan of one expert's
// shapes, so each expert's output is bitwise the 2-D call on it). x [E, M,
// K], w8 [E, K + S, N], src_tail [E, S], tail_mult [E, S] f32 holding only 0
// and 1, or null (= 1); xs [E, M] f32 or null (= 1), ws [E, N] f32, out [E,
// M, N]; k_chunk % 32 == 0 with k_chunk * nsplit >= Kb + S (Kb = K rounded
// up to 32); part [E, nsplit, M, N] f32 scratch (unused with one split, or
// the prefill tile); counters: one int per (expert, token tile, column
// tile) of the launch, zero at rest. A stack needs N % 16 == 0 and K % 8 ==
// 0. Returns cudaGetLastError() (0 = ok).
extern "C" int ocs_matmul_tc_launch(
    const void* x, int E, int M, int K, int S, const int* src_tail, const float* tail_mult,
    const int8_t* w8, const float* xs, const float* ws, int N, int k_chunk, int nsplit,
    int tile, float* part, int* counters, void* out, int out_bf16, void* stream) {
  return rtq::wo_tc_tile_launch<true>(x, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N,
                                      k_chunk, nsplit, tile, part, counters, out, out_bf16,
                                      stream);
}

// Weight-only on the CUDA cores. x_bf16: 1 if x is bfloat16, 0 if float32.
// tail_mult may be null (= 1). xs [M] f32 or null (= 1), ws [N] f32; part
// [nsplit, M, N] f32 scratch with k_chunk * nsplit >= K + S. Returns
// cudaGetLastError() (0 = ok).
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
