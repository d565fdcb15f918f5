// Device code shared by the quantized kernels (fused_qmatmul.cu,
// dynamic_quant.cu, quant_matmul.cu, ocs_matmul.cu, w4a8_qmatmul.cu,
// paged_attention.cu): each source has its own C entry points and is
// compiled into its own library; this header only keeps one copy of the
// arithmetic they have in common.
//
//   row_absmax_scale     a block's row abs-max and quantization scale.
//   quant_one/quant_rcp  one value quantized in the division form (B1, B3)
//                        or the reciprocal form of quant_rows (B2's
//                        append, B6's prologue).
//   row_quant_kernel     per-row dynamic int8 quantization (+ OCS tail
//                        duplication): B1's prologue and the whole of B3.
//   int8_gemm_kernel     __dp4a int8 x int8 -> int32 GEMM over [K+S, N]
//                        int8 weights, split K meeting in an int32
//                        workspace through atomicAdd (exact, so order-free);
//                        split_k_grid picks the split (B6's int4 GEMM too).
//   wo_gemm_kernel       weight-only GEMM on the CUDA cores: float x (staged
//                        in shared memory as f32, OCS tail gathered there),
//                        int8 weights converted in registers, f32
//                        accumulation; split K writes per-split partial sums
//                        to an f32 workspace. (bf16 x with no tail multiplier
//                        or a 0/1 mask takes wo_tc_gemm.cuh's tensor cores.)
//   epilogue_kernel      out = sum_s acc[s] * (xs[m] * ws[n]), the splits
//                        added in a fixed order, rounded once to the output
//                        type; a null xs reads as 1 (1 * ws == ws: bitwise).
//   cp_async_*           asynchronous global -> shared copies of 16 bytes
//                        (4 or 8 where a page's rows are not 16-byte
//                        aligned) and their commit/wait (B2's page tiles).
//   ensure_dynamic_smem  cudaFuncSetAttribute for a kernel's dynamic shared
//                        memory, called once per device, kernel and larger
//                        size, not on every launch.
//
// Numerics. Quantization: scale = max(amax, 1e-30) * float32(1/qmax),
// q = clamp(floor(x / scale + 0.5)), or q = clamp(floor(x * (1/scale) +
// 0.5)) in the reciprocal form; the _rn intrinsics keep nvcc from
// contracting or approximating the division, the multiply and the add (no
// fast-math).
// Weight-only sums are f32 in a fixed order, so a call's result is the same
// from run to run; it differs from another summation order (the plain
// version's) by f32 rounding only.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace rtq {

constexpr int kQuantThreads = 256;
constexpr int kGemmTx = 64;   // threads along N; 4 columns each -> 256 columns
constexpr int kGemmTy = 4;    // K slices per block, reduced in shared memory
constexpr int kGemmCols = 4 * kGemmTx;
constexpr int kWoKt = 128;    // rows of K staged in shared memory per tile
constexpr int kEpiThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_out(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float acc_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_f32(float v) { return v; }

// The epilogue's scale of output (m, n): xs[m] * ws[n], or ws[n] when xs is
// null (x_scale = 1; __fmul_rn(1, ws) == ws, so the bits are the same).
__device__ __forceinline__ float out_scale(const float* xs, const float* ws, int m, int n) {
  return xs != nullptr ? __fmul_rn(xs[m], ws[n]) : ws[n];
}

// Asynchronous copies global -> shared (Ampere's cp.async, on Hopper too).
// src_bytes < size zero-fills the rest (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
// The narrow forms (N = 4 or 8 bytes, both addresses N-byte aligned; the
// .cg form takes 16 bytes only).
template <int N>
__device__ __forceinline__ void cp_async_narrow(void* dst, const void* src) {
  static_assert(N == 4 || N == 8, "cp.async.ca copies 4, 8 or 16 bytes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait until at most n of this thread's groups are pending; n past 7 waits
// for 7 (waiting for more than asked is always safe).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Allow `kernel` `bytes` of dynamic shared memory. The attribute is set once
// per device and larger size (`slot` names the kernel in the caller's
// table), not on every launch: the size a launch asks for is checked
// against the largest size set so far on the current device.
constexpr int kMaxDevices = 16;
template <typename K>
inline cudaError_t ensure_dynamic_smem(K* kernel, std::atomic<int>* slots, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot = dev < kMaxDevices ? &slots[dev] : nullptr;
  if (slot != nullptr && slot->load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && slot != nullptr) {
    int cur = slot->load();
    while (cur < bytes && !slot->compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

__device__ __forceinline__ int8_t quant_one(float x, float scale, float qmax) {
  float q = floorf(__fadd_rn(__fdiv_rn(x, scale), 0.5f));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(q));
}

// The reciprocal form, rcp = __fdiv_rn(1, scale).
__device__ __forceinline__ int8_t quant_rcp(float x, float rcp, float qmax) {
  float q = floorf(__fadd_rn(__fmul_rn(x, rcp), 0.5f));
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(q));
}

// The scale of row xr[0, n) for a block of kQuantThreads threads:
// max(amax, 1e-30) * inv_qmax, returned to every thread. ``red`` is
// kQuantThreads / 32 floats of shared memory; the first barrier lets a
// block call this again with the same ``red``.
template <typename T>
__device__ float row_absmax_scale(const T* xr, int n, float inv_qmax, float* red) {
  float amax = 0.f;
  for (int k = threadIdx.x; k < n; k += kQuantThreads) amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  return __fmul_rn(fmaxf(m, 1e-30f), inv_qmax);
}

// Byte j of a 32-bit word of int8 weights, sign-extended, as a float (exact).
__device__ __forceinline__ float byte_f32(uint32_t word, int j) {
  return __int2float_rn(static_cast<int>(word << (24 - 8 * j)) >> 24);
}

// One block per row of x [M, K]: row abs-max, scale, the int8 row into
// q [M, Kp] (K originals, then the S duplicates q[src_tail], then zero
// padding up to Kp) and scale[M]. With S = 0 and Kp = K it is plain per-row
// dynamic quantization (B3).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) row_quant_kernel(
    const T* __restrict__ x, int K, int S, int Kp,
    const int* __restrict__ src_tail, float qmax, float inv_qmax,
    int8_t* __restrict__ q, float* __restrict__ scale_out) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * (size_t)K;
  const float sc = row_absmax_scale(xr, K, inv_qmax, red);
  if (threadIdx.x == 0) scale_out[row] = sc;
  int8_t* qr = q + row * (size_t)Kp;
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

// One block per row of int8 x [M, K]: the expanded row [x | x[src_tail] *
// mask] into q [M, Kp], zero padded. ``mask`` (0/1 bytes) may be null.
__global__ void __launch_bounds__(kQuantThreads) int8_expand_kernel(
    const int8_t* __restrict__ x, int K, int S, int Kp,
    const int* __restrict__ src_tail, const int8_t* __restrict__ mask,
    int8_t* __restrict__ q) {
  const size_t row = blockIdx.x;
  const int8_t* xr = x + row * (size_t)K;
  int8_t* qr = q + row * (size_t)Kp;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) qr[k] = xr[k];
  for (int t = threadIdx.x; t < S; t += kQuantThreads) {
    const int v = xr[src_tail[t]];
    qr[K + t] = static_cast<int8_t>(mask ? v * mask[t] : v);
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

// The grid of a dp4a GEMM over Kp rows of K (Kp % 16 == 0) with TM rows of
// M a block: split K over blockIdx.z until ~2 blocks per SM are in flight,
// keeping at least 64 rows of K per split; *k_chunk (a multiple of 16) is
// each split's share.
inline dim3 split_k_grid(int M, int Kp, int N, int TM, int* k_chunk) {
  const int gx = (N + kGemmCols - 1) / kGemmCols;
  const int gy = (M + TM - 1) / TM;
  const int want = 264;
  int nsplit = (want + gx * gy - 1) / (gx * gy);
  const int max_split = Kp / 64 > 0 ? Kp / 64 : 1;
  if (nsplit > max_split) nsplit = max_split;
  if (nsplit < 1) nsplit = 1;
  int chunk = (Kp + nsplit - 1) / nsplit;
  chunk = (chunk + 15) / 16 * 16;
  *k_chunk = chunk;
  return dim3(gx, gy, (Kp + chunk - 1) / chunk);
}

template <int TM>
void launch_int8_gemm_tm(const int8_t* a, const int8_t* w, int M, int Ke, int Kp,
                         int N, int* acc, cudaStream_t st) {
  int k_chunk;
  const dim3 grid = split_k_grid(M, Kp, N, TM, &k_chunk);
  dim3 block(kGemmTx, kGemmTy);
  int8_gemm_kernel<TM><<<grid, block, 0, st>>>(a, w, M, Ke, Kp, N, k_chunk, acc);
}

// acc [M, N] int32 must be zeroed first (the caller's memset).
inline void launch_int8_gemm(const int8_t* a, const int8_t* w, int M, int Ke, int Kp,
                             int N, int* acc, cudaStream_t st) {
  if (M <= 1) {
    launch_int8_gemm_tm<1>(a, w, M, Ke, Kp, N, acc, st);
  } else if (M <= 2) {
    launch_int8_gemm_tm<2>(a, w, M, Ke, Kp, N, acc, st);
  } else if (M <= 4) {
    launch_int8_gemm_tm<4>(a, w, M, Ke, Kp, N, acc, st);
  } else {
    launch_int8_gemm_tm<8>(a, w, M, Ke, Kp, N, acc, st);
  }
}

// Weight-only GEMM. Block (64, 4): thread (tx, ty) owns columns n0..n0+3 of
// TM rows and every 4th group of 4 rows of K inside each staged tile. The
// block's x rows for kWoKt rows of K are staged in shared memory as f32 (the
// OCS tail rows gathered there as x[m, src_tail[j]] * tail_mult[j]), so the
// expanded activations never go through device memory. Each weight row is
// read as one 32-bit word per thread, 256 contiguous bytes per warp.
template <typename TX, int TM>
__global__ void __launch_bounds__(kGemmTx * kGemmTy) wo_gemm_kernel(
    const TX* __restrict__ x,            // [M, K]
    int M, int K, int S,
    const int* __restrict__ src_tail,     // [S]
    const float* __restrict__ tail_mult,  // [S] or null (= 1)
    const int8_t* __restrict__ w,         // [K + S, N], N % 4 == 0
    int N, int k_chunk,
    float* __restrict__ part) {           // [gridDim.z, M, N]
  __shared__ __align__(16) float xs[kWoKt][TM];
  __shared__ float red[kGemmTy][TM * 4][kGemmTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kGemmTx + tx;
  const int n0 = (blockIdx.x * kGemmTx + tx) * 4;
  const int m0 = blockIdx.y * TM;
  const int Ke = K + S;
  const int kz0 = blockIdx.z * k_chunk;
  const int kz1 = min(kz0 + k_chunk, Ke);
  const bool col_ok = n0 < N;

  float sum[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;

  for (int kt = kz0; kt < kz1; kt += kWoKt) {
    for (int e = tid; e < kWoKt * TM; e += kGemmTx * kGemmTy) {
      const int kk = e / TM, i = e - kk * TM;
      const int k = kt + kk, m = m0 + i;
      float v = 0.f;
      if (m < M && k < kz1) {
        if (k < K) {
          v = load_f32(x, (size_t)m * K + k);
        } else {
          const int j = k - K;
          v = load_f32(x, (size_t)m * K + src_tail[j]);
          if (tail_mult != nullptr) v = __fmul_rn(v, tail_mult[j]);
        }
      }
      xs[kk][i] = v;
    }
    __syncthreads();
    if (col_ok) {
      const int kend = min(kWoKt, kz1 - kt);
      for (int kk = 4 * ty; kk < kend; kk += 4 * kGemmTy) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = kt + kk + q;
          r[q] = (k < kz1)
                     ? __ldg(reinterpret_cast<const unsigned int*>(w + (size_t)k * N + n0))
                     : 0u;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float wf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wf[j] = byte_f32(r[q], j);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float a = xs[kk + q][i];
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[i][j] = fmaf(a, wf[j], sum[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // The 4 K slices of the block meet in shared memory, added in order y =
  // 0..3; row i of the tile is finished by the threads with ty == i % 4.
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][i * 4 + j][tx] = sum[i][j];
  __syncthreads();
  if (!col_ok) return;
  float* out = part + (size_t)blockIdx.z * M * N;
  for (int i = ty; i < TM; i += kGemmTy) {
    const int m = m0 + i;
    if (m >= M) break;
    float4 v;
    float* vp = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = red[0][i * 4 + j][tx];
#pragma unroll
      for (int y = 1; y < kGemmTy; ++y) s = __fadd_rn(s, red[y][i * 4 + j][tx]);
      vp[j] = s;
    }
    *reinterpret_cast<float4*>(out + (size_t)m * N + n0) = v;
  }
}

template <typename TX, int TM>
void launch_wo_gemm_tm(const TX* x, int M, int K, int S, const int* src_tail,
                       const float* tail_mult, const int8_t* w, int N, int k_chunk,
                       int nsplit, float* part, cudaStream_t st) {
  dim3 grid((N + kGemmCols - 1) / kGemmCols, (M + TM - 1) / TM, nsplit);
  dim3 block(kGemmTx, kGemmTy);
  wo_gemm_kernel<TX, TM><<<grid, block, 0, st>>>(x, M, K, S, src_tail, tail_mult, w,
                                                   N, k_chunk, part);
}

template <typename TX>
void launch_wo_gemm(const TX* x, int M, int K, int S, const int* src_tail,
                    const float* tail_mult, const int8_t* w, int N, int k_chunk,
                    int nsplit, float* part, cudaStream_t st) {
  if (M <= 1) {
    launch_wo_gemm_tm<TX, 1>(x, M, K, S, src_tail, tail_mult, w, N, k_chunk, nsplit, part, st);
  } else if (M <= 2) {
    launch_wo_gemm_tm<TX, 2>(x, M, K, S, src_tail, tail_mult, w, N, k_chunk, nsplit, part, st);
  } else if (M <= 4) {
    launch_wo_gemm_tm<TX, 4>(x, M, K, S, src_tail, tail_mult, w, N, k_chunk, nsplit, part, st);
  } else {
    launch_wo_gemm_tm<TX, 8>(x, M, K, S, src_tail, tail_mult, w, N, k_chunk, nsplit, part, st);
  }
}

template <typename TA, typename TO>
__global__ void epilogue_kernel(const TA* __restrict__ acc, int nsplit,
                                const float* __restrict__ xs,  // [M] or null (= 1)
                                const float* __restrict__ ws, int M, int N,
                                TO* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  const int m = static_cast<int>(i / N);
  const int n = static_cast<int>(i % N);
  float a = acc_f32(acc[i]);
  for (int s = 1; s < nsplit; ++s) a = __fadd_rn(a, acc_f32(acc[(size_t)s * mn + i]));
  store_out(out, i, __fmul_rn(a, out_scale(xs, ws, m, n)));
}

template <typename TA>
void launch_epilogue(const TA* acc, int nsplit, const float* xs, const float* ws,
                     int M, int N, void* out, int out_bf16, cudaStream_t st) {
  const size_t total = (size_t)M * N;
  const unsigned int blocks = static_cast<unsigned int>((total + kEpiThreads - 1) / kEpiThreads);
  if (out_bf16) {
    epilogue_kernel<TA, __nv_bfloat16><<<blocks, kEpiThreads, 0, st>>>(
        acc, nsplit, xs, ws, M, N, static_cast<__nv_bfloat16*>(out));
  } else {
    epilogue_kernel<TA, float><<<blocks, kEpiThreads, 0, st>>>(
        acc, nsplit, xs, ws, M, N, static_cast<float*>(out));
  }
}

// The int8 path of B4/B5: expand (copy, tail, zero pad) into q [M, Kp] when
// needed, dp4a GEMM into the zeroed int32 acc [M, N], epilogue. Returns the
// first failing step's cudaError (0 = ok).
inline int int8_matmul_path(const int8_t* x, int M, int K, int S, const int* src_tail,
                            const int8_t* mask, const int8_t* w8, const float* xs,
                            const float* ws, int N, int8_t* q, int Kp, int* acc,
                            void* out, int out_bf16, cudaStream_t st) {
  const int8_t* a = x;
  if (q != nullptr) {
    int8_expand_kernel<<<M, kQuantThreads, 0, st>>>(x, K, S, Kp, src_tail, mask, q);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a = q;
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_int8_gemm(a, w8, M, K + S, Kp, N, acc, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_epilogue<int>(acc, 1, xs, ws, M, N, out, out_bf16, st);
  return static_cast<int>(cudaGetLastError());
}

// The weight-only path of B4/B5: GEMM into part [nsplit, M, N], epilogue.
template <typename TX>
int wo_matmul_path(const TX* x, int M, int K, int S, const int* src_tail,
                   const float* tail_mult, const int8_t* w8, const float* xs,
                   const float* ws, int N, int k_chunk, int nsplit, float* part,
                   void* out, int out_bf16, cudaStream_t st) {
  launch_wo_gemm<TX>(x, M, K, S, src_tail, tail_mult, w8, N, k_chunk, nsplit, part, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_epilogue<float>(part, nsplit, xs, ws, M, N, out, out_bf16, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtq
