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
// memory, so the work is split into three launches with unchanged
// numerics:
//   1. row_quant: one block per row computes the row abs-max, the scale and
//      the int8 row, and gathers the OCS tail, into q_exp [M, Kp] (Kp = K+S
//      rounded up to 16, zero padded) and scale [M];
//   2. int8_gemm: __dp4a over 4-deep slices of K. Each thread owns 4
//      adjacent output columns and TM rows; it reads one 32-bit word of w8
//      (4 columns) from each of 4 consecutive rows, transposes the 4x4
//      bytes with __byte_perm and issues TM*4 dp4a. The weights are read in
//      their [K+S, N] layout with coalesced 128-byte warp loads. K is split
//      over threadIdx.y (reduced in shared memory) and over blockIdx.z so
//      that small-M, small-N shapes still fill the 132 SMs; the K slices
//      meet in an int32 workspace through atomicAdd, which is exact and
//      order-independent for integers;
//   3. epilogue: out = (float)acc * (scale[m] * w_scale[n]), rounded once
//      to the output type.
// The three kernels are in qmatmul_common.cuh, shared with dynamic_quant.cu
// (the prologue alone), quant_matmul.cu and ocs_matmul.cu (the GEMM and the
// epilogue). Tensor-core (mma/wgmma) tiles and TMA are later work.
//
// Numerics (bitwise equal to the plain version and to the reference as it
// runs compiled): scale = max(amax, 1e-30) * float32(1/qmax);
// q = clamp(floor(x / scale + 0.5)). The division and the add use the _rn
// intrinsics so nvcc cannot contract or approximate them.

#include "qmatmul_common.cuh"

// x_bf16: 1 if x is bfloat16, 0 if float32; out_bf16 likewise for out.
// Scratch from the caller: q_exp [M, Kp] int8, scale [M] f32, acc [M, N]
// int32. Returns cudaGetLastError() of the first failing step (0 = ok).
extern "C" int fused_qmatmul_launch(
    const void* x, int x_bf16, int M, int K, int S, int Kp,
    const int* src_tail, const int8_t* w8, const float* w_scale, int N,
    float qmax, float inv_qmax, int8_t* q_exp, float* scale, int* acc,
    void* out, int out_bf16, void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    row_quant_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, S, Kp, src_tail, qmax, inv_qmax,
        q_exp, scale);
  } else {
    row_quant_kernel<float><<<M, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), K, S, Kp, src_tail, qmax, inv_qmax, q_exp,
        scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_int8_gemm(q_exp, w8, M, K + S, Kp, N, acc, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  launch_epilogue<int>(acc, 1, scale, w_scale, M, N, out, out_bf16, st);
  return static_cast<int>(cudaGetLastError());
}
