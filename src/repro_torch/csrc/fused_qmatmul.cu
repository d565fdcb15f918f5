// Fused dynamic-quant + OCS-expanded W8A8 matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_qmatmul.py::_kernel (the Pallas TPU kernel
// behind fused_qmatmul_kernel / fused_quant_matmul): per-row dynamic int8
// quantization of x over its K original channels, duplication of the OCS
// tail columns q[:, src_tail], int8 x int8 -> int32 product against the
// packed expanded weights w8 [K+S, N], f32 epilogue acc * (scale * w_scale).
//
// What bounds it on this card: at decode (M <= 8) the int8 weight bytes
// (one layer of glm4-9b is ~207 MB, lm_head ~633 MB) over HBM bandwidth;
// at prefill (M = 256) the int8 multiply-adds.
//
// Design. The TPU kernel keeps a [bm, K] f32 row tile resident in VMEM; at
// K = 4096 or 13696 that tile does not fit a block's 227 KB of shared
// memory, so a call is two launches with unchanged numerics:
//   1. row_quant (qmatmul_common.cuh): one block per row computes the row
//      abs-max, the scale and the int8 row, and gathers the OCS tail, into
//      q_exp [M, Kp] (Kp = K+S rounded up to 16, zero padded: a row stride
//      the TMA can read) and scale [M];
//   2. i8_tc_gemm (i8_tc_gemm.cuh): q_exp @ w8 on the int8 tensor cores
//      (mma.sync m16n8k32 s8.s8.s32), weights and token rows streamed by
//      the TMA through a ring of shared-memory stages, the block tile and
//      the split of K chosen from M at the host (a decode tile of 8 tokens
//      x 256 columns, a tile of 64 tokens x 128 columns above M = 8, each
//      split over the grid to fill the SMs), the epilogue applied in the
//      kernel (split K
//      meets in an int32 accumulator through atomics, read back by the last
//      block of each tile).
// No memset and no separate epilogue launch. The TMA reads weight rows of a
// multiple of 16 bytes: the wrapper zero-pads a ragged N.
//
// Numerics (bitwise equal to the plain version and to the reference as it
// runs compiled): scale = max(amax, 1e-30) * float32(1/qmax);
// q = clamp(floor(x / scale + 0.5)). The division and the add use the _rn
// intrinsics so nvcc cannot contract or approximate them. The integer sums
// are exact in any order, so neither the tile nor the split moves a bit.

#include "i8_tc_gemm.cuh"

namespace rtq {
namespace {

// B1's GEMM launcher over E experts (E = 1: a 2-D call). `tile` (the host's
// choice from the rows an expert, kernels/fused_qmatmul.py's plan): 0 = 256
// columns x 8 tokens a block (decode, M <= 8); 1 = 128 columns x 64 tokens
// (M > 8), as i8_tc_gemm.cuh's launch_i8_tile describes them.
inline int i8_tc_launch(int tile, const int8_t* q, int E, int M, int Kp, const int8_t* w, int Ke,
                        int N, int stages_per_split, int nsplit, const float* xs,
                        const float* ws, int* acc_ws, int* counters, void* out, int out_bf16,
                        cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch_i8_tile<4, 1, 1, 1>(q, E, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws,
                                        acc_ws, counters, out, out_bf16, st);
    case 1:
      return launch_i8_tile<2, 2, 4, 2>(q, E, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws,
                                        acc_ws, counters, out, out_bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace rtq

// x_bf16: 1 if x is bfloat16, 0 if float32; out_bf16 likewise for out.
// Over E experts of M rows each (E = 1: a 2-D call; E > 1: a MoE layer's
// stacked matrix in one call, the vmapped call of the reference): x [E, M,
// K], src_tail [E, S], w8 [E, K+S, N] with N % 16 == 0, 16-byte aligned
// (else cudaErrorInvalidValue), w_scale [E, N], out [E, M, N]. Scratch from
// the caller: q_exp [E, M, Kp] int8 (16-byte aligned), scale [E, M] f32, and
// with nsplit > 1 acc_ws [E, M, N] int32 and counters (one int per expert,
// token tile and column tile), both zero at rest. tile, stages_per_split
// and nsplit: the host's plan of one expert's shapes (i8_tc_launch), so
// each expert's output is bitwise the 2-D call on it. Two launches, the
// prologue (one block a row of all E experts' rows) and the GEMM. Returns
// cudaGetLastError() of the first failing step (0 = ok).
extern "C" int fused_qmatmul_launch(
    const void* x, int x_bf16, int E, int M, int K, int S, int Kp,
    const int* src_tail, const int8_t* w8, const float* w_scale, int N,
    float qmax, float inv_qmax, int8_t* q_exp, float* scale,
    int tile, int stages_per_split, int nsplit, int* acc_ws, int* counters,
    void* out, int out_bf16, void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    row_quant_kernel<__nv_bfloat16><<<E * M, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, S, Kp, src_tail, M, qmax, inv_qmax,
        q_exp, scale);
  } else {
    row_quant_kernel<float><<<E * M, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), K, S, Kp, src_tail, M, qmax, inv_qmax, q_exp,
        scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return i8_tc_launch(tile, q_exp, E, M, Kp, w8, K + S, N, stages_per_split, nsplit, scale,
                      w_scale, acc_ws, counters, out, out_bf16, st);
}
