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
// Tensor-core (mma/wgmma) tiles and TMA are later work.
//
// Numerics (bitwise equal to the plain version and to the reference as it
// runs compiled): scale = max(amax, 1e-30) * float32(1/qmax);
// q = clamp(floor(x / scale + 0.5)). The division and the add use the _rn
// intrinsics so nvcc cannot contract or approximate them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kGemmTx = 64;   // threads along N; 4 columns each -> 256 columns
constexpr int kGemmTy = 4;    // K slices per block, reduced in shared memory
constexpr int kGemmCols = 4 * kGemmTx;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_out(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quant_one(float x, float scale, float qmax) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), 0.5f));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) row_quant_kernel(
    const T* __restrict__ x, int K, int S, int Kp,
    const int* __restrict__ src_tail, float qmax, float inv_qmax,
    int8_t* __restrict__ q_exp, float* __restrict__ scale_out) {
  __shared__ float red[kQuantThreads / 32];
  __shared__ float s_scale;
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) {
    amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
    const float sc = __fmul_rn(fmaxf(m, 1e-30f), inv_qmax);
    s_scale = sc;
    scale_out[row] = sc;
  }
  __syncthreads();
  const float sc = s_scale;
  int8_t* qr = q_exp + row * (size_t)Kp;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) {
    qr[k] = quant_one(load_f32(xr, k), sc, qmax);
  }
  // OCS duplicates: re-quantize the source value; the arithmetic is the
  // same, so the byte equals q[src] exactly.
  for (int t = threadIdx.x; t < S; t += kQuantThreads) {
    qr[K + t] = quant_one(load_f32(xr, src_tail[t]), sc, qmax);
  }
  for (int k = K + S + threadIdx.x; k < Kp; k += kQuantThreads) qr[k] = 0;
}

template <int TM>
__global__ void __launch_bounds__(kGemmTx * kGemmTy) int8_gemm_kernel(
    const int8_t* __restrict__ a,  // [M, Kp], Kp % 16 == 0, zero padded
    const int8_t* __restrict__ w,  // [Ke, N] row-major, N % 4 == 0
    int M, int Ke, int Kp, int N, int k_chunk,
    int* __restrict__ acc) {       // [M, N] int32, zeroed
  __shared__ int red[kGemmTy][TM * 4][kGemmTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = (blockIdx.x * kGemmTx + tx) * 4;
  const int m0 = blockIdx.y * TM;
  const int kz0 = blockIdx.z * k_chunk;
  const int kz1 = min(kz0 + k_chunk, Kp);
  const bool col_ok = n0 < N;

  int sum[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0;

  for (int k = kz0 + 4 * ty; k < kz1; k += 4 * kGemmTy) {
    if (!col_ok) continue;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = (k + i < Ke)
                 ? __ldg(reinterpret_cast<const unsigned int*>(w + (size_t)(k + i) * N + n0))
                 : 0u;
    }
    // 4x4 byte transpose: b[j] holds column n0+j at rows k..k+3.
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    int b[4];
    b[0] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
    b[1] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
    b[2] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
    b[3] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + i;
      const int av =
          (m < M) ? __ldg(reinterpret_cast<const int*>(a + (size_t)m * Kp + k)) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = __dp4a(av, b[j], sum[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][i * 4 + j][tx] = sum[i][j];
  __syncthreads();
  if (ty != 0 || !col_ok) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int s = red[0][i * 4 + j][tx];
#pragma unroll
      for (int y = 1; y < kGemmTy; ++y) s += red[y][i * 4 + j][tx];
      if (n0 + j < N) atomicAdd(acc + (size_t)m * N + n0 + j, s);
    }
  }
}

template <typename TO>
__global__ void epilogue_kernel(const int* __restrict__ acc,
                                const float* __restrict__ scale,
                                const float* __restrict__ ws, int M, int N,
                                TO* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = static_cast<int>(i / N);
  const int n = static_cast<int>(i % N);
  const float v = __fmul_rn(__int2float_rn(acc[i]), __fmul_rn(scale[m], ws[n]));
  store_out(out, i, v);
}

template <int TM>
void launch_gemm(const int8_t* a, const int8_t* w, int M, int Ke, int Kp, int N,
                 int* acc, cudaStream_t st) {
  const int gx = (N + kGemmCols - 1) / kGemmCols;
  const int gy = (M + TM - 1) / TM;
  // Split K over the grid until ~2 blocks per SM are in flight, keeping at
  // least 64 rows of K per split.
  const int want = 264;
  int nsplit = (want + gx * gy - 1) / (gx * gy);
  const int max_split = Kp / 64 > 0 ? Kp / 64 : 1;
  if (nsplit > max_split) nsplit = max_split;
  if (nsplit < 1) nsplit = 1;
  int k_chunk = (Kp + nsplit - 1) / nsplit;
  k_chunk = (k_chunk + 15) / 16 * 16;
  nsplit = (Kp + k_chunk - 1) / k_chunk;
  dim3 grid(gx, gy, nsplit);
  dim3 block(kGemmTx, kGemmTy);
  int8_gemm_kernel<TM><<<grid, block, 0, st>>>(a, w, M, Ke, Kp, N, k_chunk, acc);
}

}  // namespace

// x_bf16: 1 if x is bfloat16, 0 if float32; out_bf16 likewise for out.
// Scratch from the caller: q_exp [M, Kp] int8, scale [M] f32, acc [M, N]
// int32. Returns cudaGetLastError() of the first failing step (0 = ok).
extern "C" int fused_qmatmul_launch(
    const void* x, int x_bf16, int M, int K, int S, int Kp,
    const int* src_tail, const int8_t* w8, const float* w_scale, int N,
    float qmax, float inv_qmax, int8_t* q_exp, float* scale, int* acc,
    void* out, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Ke = K + S;
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
  if (M <= 1) {
    launch_gemm<1>(q_exp, w8, M, Ke, Kp, N, acc, st);
  } else if (M <= 2) {
    launch_gemm<2>(q_exp, w8, M, Ke, Kp, N, acc, st);
  } else if (M <= 4) {
    launch_gemm<4>(q_exp, w8, M, Ke, Kp, N, acc, st);
  } else {
    launch_gemm<8>(q_exp, w8, M, Ke, Kp, N, acc, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  if (out_bf16) {
    epilogue_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        acc, scale, w_scale, M, N, static_cast<__nv_bfloat16*>(out));
  } else {
    epilogue_kernel<float><<<blocks, threads, 0, st>>>(
        acc, scale, w_scale, M, N, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
