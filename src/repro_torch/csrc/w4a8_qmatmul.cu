// W4A8 matmul with OCS-separated int8 outlier rows, for Hopper (sm_90a).
//
// Replaces repro/kernels/fused_qmatmul.py::_w4a8_kernel (the Pallas TPU
// kernel behind w4a8_qmatmul_kernel / w4a8_quant_matmul): per-row dynamic
// int8 quantization of x over its K original channels in the reciprocal
// form of quant_rows, the OCS tail q[:, src_tail] and the outlier rows
// q_exp[:, outlier_idx] gathered, then two exact integer sums — acc4 over
// the split-half packed int4 weights w4 [(K+S)/2, N] (outlier rows zero)
// and acc8 over the int8 outlier rows w8 [T, N] — and the f32 epilogue
// acc4 * (scale * s4) + acc8 * (scale * s8), as the reference computes it
// compiled: XLA contracts the first product and the add into one FMA.
//
// What bounds it on this card: at decode (M <= 8) the weight bytes (one
// glm4-9b layer is ~104 MB of nibbles plus ~12 MB of outlier rows, the
// lm_head ~317 + 32 MB) over HBM bandwidth; at prefill (M = 256) the int8
// multiply-adds.
//
// Design. As for B1 (fused_qmatmul.cu), the TPU kernel's resident [bm, K]
// row tile does not fit shared memory, so the work is four launches with
// the kernel's numerics:
//   1. w4a8_prologue: one block per row computes the row abs-max, the scale
//      and every value of the expanded int8 row, written split in two halves
//      q2 [M, 2*Hp]: expanded rows [0, H) at 0 and [H, K+S) at Hp (H =
//      (K+S)/2, Hp = H rounded up to 16, zero padded), so that the GEMM
//      reads the activations of the low and the high nibbles of one weight
//      byte row as two aligned 4-byte words; and the outlier activations
//      q8 [M, Tp] = q_exp[:, outlier_idx] (zero padded). The TPU's one-hot
//      gather matmuls become indexed loads: a duplicate or outlier value is
//      re-quantized from its source channel with the same arithmetic, so
//      the byte equals the original's.
//   2. int4_gemm: each thread owns 4 adjacent output columns and TM rows; it
//      reads one 32-bit word of w4 (4 columns) from each of 4 consecutive
//      byte rows — every weight byte is read once — transposes the 4x4
//      bytes with __byte_perm, sign-extends the low and the high nibbles
//      of each column word in registers (per-byte (v ^ 8) - 8 with
//      __vsub4) and issues two __dp4a per row and column: low nibbles
//      against q2[m, j..j+3], high nibbles against q2[m, Hp+j..Hp+j+3].
//      Split K as in int8_gemm (qmatmul_common.cuh): over threadIdx.y (shared memory) and
//      blockIdx.z, meeting in the int32 acc4 through atomicAdd (exact, so
//      order-free).
//   3. int8_gemm (qmatmul_common.cuh, the __dp4a GEMM): q8 @ w8
//      into acc8, when T > 0.
//   4. w4a8_epilogue: out = fma(f32(acc4), scale[m] * s4[n], f32(acc8) *
//      (scale[m] * s8[n])) when T > 0, f32(acc4) * (scale[m] * s4[n]) when
//      T == 0 (no +0.0 added, which would turn a -0.0 into +0.0); every
//      step an explicit _rn intrinsic, so nvcc contracts nothing else;
//      rounded once to the output type.
// Tensor-core (mma/wgmma) tiles and TMA are later work.
//
// Numerics (bitwise equal to the plain version, w4a8_matmul_ref, and to the
// reference's compiled w4a8_matmul_ref and interpret-mode kernel):
// scale = max(amax, 1e-30) * float32(1/qmax); q = clamp(floor(x * (1/scale)
// + 0.5)), the reciprocal by __fdiv_rn and the multiply and add by
// __fmul_rn / __fadd_rn; the integer sums are exact.

#include "qmatmul_common.cuh"

namespace {

using namespace rtq;

// One block per row of x [M, K].
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) w4a8_prologue_kernel(
    const T* __restrict__ x, int K, int S, const int* __restrict__ src_tail,
    const int* __restrict__ oidx, int Tn, float qmax, float inv_qmax,
    int8_t* __restrict__ q2, int Hp, int8_t* __restrict__ q8, int Tp,
    float* __restrict__ scale_out) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)K;
  const float sc = row_absmax_scale(xr, K, inv_qmax, red);
  if (threadIdx.x == 0) scale_out[row] = sc;
  const float rcp = __fdiv_rn(1.0f, sc);
  const int Ke = K + S;
  const int H = Ke / 2;
  int8_t* qr = q2 + row * (size_t)(2 * Hp);
  // Expanded row e reads source channel e (e < K) or src_tail[e - K].
  for (int i = threadIdx.x; i < 2 * Hp; i += kQuantThreads) {
    const int e = i < Hp ? i : H + (i - Hp);
    const bool live = i < Hp ? i < H : e < Ke;
    int8_t v = 0;
    if (live) v = quant_rcp(load_f32(xr, e < K ? e : src_tail[e - K]), rcp, qmax);
    qr[i] = v;
  }
  if (Tn > 0) {
    int8_t* q8r = q8 + row * (size_t)Tp;
    for (int t = threadIdx.x; t < Tp; t += kQuantThreads) {
      int8_t v = 0;
      if (t < Tn) {
        const int e = oidx[t];
        v = quant_rcp(load_f32(xr, e < K ? e : src_tail[e - K]), rcp, qmax);
      }
      q8r[t] = v;
    }
  }
}

// The 4 sign-extended nibbles (low, or high) of a word of packed bytes, as
// a word of int8 bytes for __dp4a.
__device__ __forceinline__ int nibbles_lo(uint32_t w) {
  return static_cast<int>(__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}
__device__ __forceinline__ int nibbles_hi(uint32_t w) {
  return static_cast<int>(__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}

template <int TM>
__global__ void __launch_bounds__(kGemmTx * kGemmTy) int4_gemm_kernel(
    const int8_t* __restrict__ q2,  // [M, 2*Hp] zero padded halves
    const uint8_t* __restrict__ w4,  // [H, N] packed, N % 4 == 0
    int M, int H, int Hp, int N, int k_chunk,
    int* __restrict__ acc) {         // [M, N] int32, zeroed
  __shared__ int red[kGemmTy][TM * 4][kGemmTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n0 = (blockIdx.x * kGemmTx + tx) * 4;
  const int m0 = blockIdx.y * TM;
  const int kz0 = blockIdx.z * k_chunk;
  const int kz1 = min(kz0 + k_chunk, Hp);
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
      r[i] = (k + i < H)
                 ? __ldg(reinterpret_cast<const unsigned int*>(w4 + (size_t)(k + i) * N + n0))
                 : 0u;
    }
    // 4x4 byte transpose: b[j] holds column n0+j at byte rows k..k+3.
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    uint32_t b[4];
    b[0] = __byte_perm(t0, t1, 0x5410);
    b[1] = __byte_perm(t0, t1, 0x7632);
    b[2] = __byte_perm(t2, t3, 0x5410);
    b[3] = __byte_perm(t2, t3, 0x7632);
    int lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = nibbles_lo(b[j]);
      hi[j] = nibbles_hi(b[j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + i;
      int a_lo = 0, a_hi = 0;
      if (m < M) {
        const int8_t* qm = q2 + (size_t)m * (2 * Hp);
        a_lo = __ldg(reinterpret_cast<const int*>(qm + k));
        a_hi = __ldg(reinterpret_cast<const int*>(qm + Hp + k));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sum[i][j] = __dp4a(a_lo, lo[j], sum[i][j]);
        sum[i][j] = __dp4a(a_hi, hi[j], sum[i][j]);
      }
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

template <int TM>
void launch_int4_gemm_tm(const int8_t* q2, const uint8_t* w4, int M, int H, int Hp, int N,
                         int* acc, cudaStream_t st) {
  int k_chunk;  // int8_gemm's split rule over the Hp byte rows
  const dim3 grid = split_k_grid(M, Hp, N, TM, &k_chunk);
  dim3 block(kGemmTx, kGemmTy);
  int4_gemm_kernel<TM><<<grid, block, 0, st>>>(q2, w4, M, H, Hp, N, k_chunk, acc);
}

void launch_int4_gemm(const int8_t* q2, const uint8_t* w4, int M, int H, int Hp, int N,
                      int* acc, cudaStream_t st) {
  if (M <= 1) {
    launch_int4_gemm_tm<1>(q2, w4, M, H, Hp, N, acc, st);
  } else if (M <= 2) {
    launch_int4_gemm_tm<2>(q2, w4, M, H, Hp, N, acc, st);
  } else if (M <= 4) {
    launch_int4_gemm_tm<4>(q2, w4, M, H, Hp, N, acc, st);
  } else {
    launch_int4_gemm_tm<8>(q2, w4, M, H, Hp, N, acc, st);
  }
}

template <typename TO>
__global__ void w4a8_epilogue_kernel(const int* __restrict__ acc4,
                                     const int* __restrict__ acc8,  // null when T == 0
                                     const float* __restrict__ xs,
                                     const float* __restrict__ s4,
                                     const float* __restrict__ s8, int M, int N,
                                     TO* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = static_cast<int>(i / N);
  const int n = static_cast<int>(i % N);
  const float a4 = __int2float_rn(acc4[i]);
  const float c4 = __fmul_rn(xs[m], s4[n]);
  float v;
  if (acc8 != nullptr) {
    v = __fmaf_rn(a4, c4, __fmul_rn(__int2float_rn(acc8[i]), __fmul_rn(xs[m], s8[n])));
  } else {
    v = __fmul_rn(a4, c4);
  }
  store_out(out, i, v);
}

}  // namespace

// x_bf16: 1 if x is bfloat16, 0 if float32; out_bf16 likewise for out.
// Scratch from the caller: q2 [M, 2*Hp] int8 (Hp = (K+S)/2 rounded up to
// 16), q8 [M, Tp] int8 (Tp = T rounded up to 16; unused when T == 0),
// scale [M] f32, acc [T > 0 ? 2 : 1, M, N] int32. Returns cudaGetLastError()
// of the first failing step (0 = ok).
extern "C" int w4a8_qmatmul_launch(
    const void* x, int x_bf16, int M, int K, int S, const int* src_tail,
    const int* outlier_idx, int Tn, const uint8_t* w4, const float* s4, const int8_t* w8,
    const float* s8, int N, float qmax, float inv_qmax, int8_t* q2, int Hp, int8_t* q8,
    int Tp, float* scale, int* acc, void* out, int out_bf16, void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    w4a8_prologue_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, S, src_tail, outlier_idx, Tn, qmax,
        inv_qmax, q2, Hp, q8, Tp, scale);
  } else {
    w4a8_prologue_kernel<float><<<M, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), K, S, src_tail, outlier_idx, Tn, qmax, inv_qmax, q2,
        Hp, q8, Tp, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t mn = (size_t)M * N;
  err = cudaMemsetAsync(acc, 0, (Tn > 0 ? 2 : 1) * mn * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_int4_gemm(q2, w4, M, (K + S) / 2, Hp, N, acc, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int* acc8 = nullptr;
  if (Tn > 0) {
    acc8 = acc + mn;
    launch_int8_gemm(q8, w8, M, Tn, Tp, N, acc8, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const unsigned int blocks = static_cast<unsigned int>((mn + kEpiThreads - 1) / kEpiThreads);
  if (out_bf16) {
    w4a8_epilogue_kernel<__nv_bfloat16><<<blocks, kEpiThreads, 0, st>>>(
        acc, acc8, scale, s4, s8, M, N, static_cast<__nv_bfloat16*>(out));
  } else {
    w4a8_epilogue_kernel<float><<<blocks, kEpiThreads, 0, st>>>(
        acc, acc8, scale, s4, s8, M, N, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
