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
// row tile does not fit shared memory, so a call is two launches with the
// kernel's numerics:
//   1. w4a8_prologue: blocks of a row (one for each 4 KB of its q2 row, so
//      that a decode call's few rows still spread over many SMs) each
//      compute the row abs-max (16-byte loads) and the scale, and write
//      their share of the expanded int8 row, split in two halves
//      q2 [M, 2*Hp]: expanded rows [0, H) at 0 and [H, K+S) at Hp (H =
//      (K+S)/2, Hp = H rounded up to 32, zero padded), so that each 32-row
//      stage of the GEMM reads the activations of the low and the high
//      nibbles of its weight byte rows as two token boxes that never cross
//      the halves; and the outlier activations q8 [M, Tp] =
//      q_exp[:, outlier_idx] (Tp = T rounded up to 32, zero padded). The
//      TPU's one-hot gather matmuls become indexed loads: a duplicate or
//      outlier value is re-quantized from its source channel with the same
//      arithmetic, so the byte equals the original's.
//   2. w4_tc_gemm (i8_tc_gemm.cuh, B1's tile, ring and fragments): the int4 stages
//      (Hp / 32 of them, 32 byte rows of w4 against both halves' token
//      boxes, the nibbles unpacked in registers into the A fragments of two
//      int8 tensor-core k-steps) and then the outlier stages (ceil(T / 32),
//      B1's int8 stage over w8 and q8) stream through one TMA ring; the
//      tile and the split of K come from the host's plan
//      (kernels/w4a8_qmatmul.py); split K meets in a zero-at-rest int32
//      accumulator [T > 0 ? 2 : 1, M, N] through atomics, and the tile's
//      last block applies the epilogue in the kernel: out = fma(f32(acc4),
//      scale[m] * s4[n], f32(acc8) * (scale[m] * s8[n])) when T > 0,
//      f32(acc4) * (scale[m] * s4[n]) when T == 0 (no +0.0 added, which
//      would turn a -0.0 into +0.0); every step an explicit _rn intrinsic,
//      so nvcc contracts nothing else; rounded once to the output type.
// No memset and no separate epilogue launch. The TMA reads weight rows of a
// multiple of 16 bytes: the wrapper zero-pads a ragged N.
//
// Numerics (bitwise equal to the plain version, w4a8_matmul_ref, and to the
// reference's compiled w4a8_matmul_ref and interpret-mode kernel):
// scale = max(amax, 1e-30) * float32(1/qmax); q = clamp(floor(x * (1/scale)
// + 0.5)), the reciprocal by __fdiv_rn and the multiply and add by
// __fmul_rn / __fadd_rn; the integer sums are exact in any order, so
// neither the tile nor the split moves a bit.

#include "i8_tc_gemm.cuh"

namespace rtq {
namespace {

// The absolute values of the 16 bytes of x in u, as floats, folded into a
// running maximum (bf16: 8 values, f32: 4). Exact, and order-free: the same
// maximum as one value at a time.
__device__ __forceinline__ float absmax16(float m, uint4 u, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m = fmaxf(m, fabsf(__uint_as_float(w[i] << 16)));
    m = fmaxf(m, fabsf(__uint_as_float(w[i] & 0xFFFF0000u)));
  }
  return m;
}
__device__ __forceinline__ float absmax16(float m, uint4 u, const float*) {
  m = fmaxf(m, fabsf(__uint_as_float(u.x)));
  m = fmaxf(m, fabsf(__uint_as_float(u.y)));
  m = fmaxf(m, fabsf(__uint_as_float(u.z)));
  return fmaxf(m, fabsf(__uint_as_float(u.w)));
}

// row_absmax_scale (qmatmul_common.cuh) with the row read in 16-byte loads
// from its first 16-byte boundary on (scalar loads before it and after its
// last whole 16 bytes): at decode a call has one block a row, so the row's
// load latency is the prologue's time. The same scale, bit for bit.
template <typename T>
__device__ float row_absmax_scale16(const T* xr, int n, float inv_qmax, float* red) {
  constexpr int kV = 16 / sizeof(T);
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) /
                                           sizeof(T)));
  const int nv = (n - head) / kV;
  float amax = 0.f;
  for (int k = threadIdx.x; k < head; k += kQuantThreads) amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
#pragma unroll 4
  for (int v = threadIdx.x; v < nv; v += kQuantThreads) amax = absmax16(amax, __ldg(xv + v), xr);
  for (int k = head + nv * kV + threadIdx.x; k < n; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  return __fmul_rn(fmaxf(m, 1e-30f), inv_qmax);
}

// q2 words (4 bytes) a prologue block writes at most: a row's words are
// shared out among ceil(2 * Hp / 4 / kPrologueWords) blocks.
constexpr int kPrologueWords = 1024;

// Blocks (row, part) over x [M, K]: every part computes the row's scale (the
// same bits), part 0 stores it, and each writes its share of the row's
// expanded int8 values in q2's two halves, the last part the outlier
// activations in q8 too; 4 bytes a thread and store (2 * Hp and Tp are
// multiples of 32). At decode a call has few rows, and a row's parts run
// side by side. A stack of experts' rows (x [E, rows_per_src, K]) reads
// row r's tail and outlier rows from src_tail [E, S] and oidx [E, Tn] row
// r / rows_per_src.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) w4a8_prologue_kernel(
    const T* __restrict__ x, int K, int S, const int* __restrict__ src_tail,
    const int* __restrict__ oidx, int Tn, int rows_per_src, float qmax, float inv_qmax,
    int8_t* __restrict__ q2, int Hp, int8_t* __restrict__ q8, int Tp,
    float* __restrict__ scale_out) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const size_t ex = row / rows_per_src;
  if (S > 0) src_tail += ex * S;
  if (Tn > 0) oidx += ex * Tn;
  const bool last = blockIdx.y == gridDim.y - 1;
  const T* xr = x + row * (size_t)K;
  const float sc = row_absmax_scale16(xr, K, inv_qmax, red);
  if (blockIdx.y == 0 && threadIdx.x == 0) scale_out[row] = sc;
  const float rcp = __fdiv_rn(1.0f, sc);
  const int Ke = K + S;
  const int H = Ke / 2;
  const int words = (2 * Hp) / 4;
  const int per = (words + gridDim.y - 1) / gridDim.y;
  const int w1 = min(words, (int)(blockIdx.y + 1) * per);
  // Expanded row e reads source channel e (e < K) or src_tail[e - K].
  uint32_t* qr = reinterpret_cast<uint32_t*>(q2 + row * (size_t)(2 * Hp));
  for (int w = blockIdx.y * per + threadIdx.x; w < w1; w += kQuantThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * w + b;
      const int e = i < Hp ? i : H + (i - Hp);
      const bool live = i < Hp ? i < H : e < Ke;
      int8_t v = 0;
      if (live) v = quant_rcp(load_f32(xr, e < K ? e : src_tail[e - K]), rcp, qmax);
      word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
    }
    qr[w] = word;
  }
  if (Tn > 0 && last) {
    uint32_t* q8r = reinterpret_cast<uint32_t*>(q8 + row * (size_t)Tp);
    for (int w = threadIdx.x; w < Tp / 4; w += kQuantThreads) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * w + b;
        int8_t v = 0;
        if (t < Tn) {
          const int e = oidx[t];
          v = quant_rcp(load_f32(xr, e < K ? e : src_tail[e - K]), rcp, qmax);
        }
        word |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * b);
      }
      q8r[w] = word;
    }
  }
}

// B6's GEMM launcher over E experts (E = 1: a 2-D call). `tile` (the host's
// choice from the rows an expert, kernels/w4a8_qmatmul.py's plan, B1's
// tiles): 0 = 256 columns x 8 tokens a block (decode, M <= 8); 1 = 128
// columns x 64 tokens (M > 8), as i8_tc_gemm.cuh's launch_w4_tile describes
// them.
inline int w4_tc_launch(int tile, const int8_t* q2, int Hp, const uint8_t* w4, int H,
                        const int8_t* q8, int Tp, const int8_t* w8, int Tn, int E, int M, int N,
                        int stages_per_split, int nsplit, const float* xs, const float* s4,
                        const float* s8, int* acc_ws, int* counters, void* out, int out_bf16,
                        cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch_w4_tile<4, 1, 1, 1>(q2, Hp, w4, H, q8, Tp, w8, Tn, E, M, N, stages_per_split,
                                        nsplit, xs, s4, s8, acc_ws, counters, out, out_bf16, st);
    case 1:
      return launch_w4_tile<2, 2, 4, 2>(q2, Hp, w4, H, q8, Tp, w8, Tn, E, M, N, stages_per_split,
                                        nsplit, xs, s4, s8, acc_ws, counters, out, out_bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace rtq

// x_bf16: 1 if x is bfloat16, 0 if float32; out_bf16 likewise for out.
// Over E experts of M rows each (E = 1: a 2-D call; E > 1: a MoE layer's
// stacked matrix in one call, the vmapped call of the reference): x [E, M,
// K], src_tail [E, S], outlier_idx [E, T], w4 [E, H, N] uint8 and w8 [E, T,
// N] int8 with N % 16 == 0, 16-byte aligned (else cudaErrorInvalidValue),
// s4 and s8 [E, N], out [E, M, N]. Scratch from the caller: q2 [E, M, 2*Hp]
// int8 (Hp = H rounded up to 32), q8 [E, M, Tp] int8 (Tp = T rounded up to
// 32; unused when T == 0), scale [E, M] f32, and with nsplit > 1 acc_ws [E,
// T > 0 ? 2 : 1, M, N] int32 and counters (one int per expert, token tile
// and column tile), both zero at rest. tile, stages_per_split and nsplit:
// the host's plan of one expert's shapes (w4_tc_launch), so each expert's
// output is bitwise the 2-D call on it. Two launches, the prologue (blocks
// over all E experts' rows) and the GEMM. Returns cudaGetLastError() of the
// first failing step (0 = ok).
extern "C" int w4a8_qmatmul_launch(
    const void* x, int x_bf16, int E, int M, int K, int S, const int* src_tail,
    const int* outlier_idx, int Tn, const uint8_t* w4, const float* s4, const int8_t* w8,
    const float* s8, int N, float qmax, float inv_qmax, int8_t* q2, int Hp, int8_t* q8,
    int Tp, float* scale, int tile, int stages_per_split, int nsplit, int* acc_ws,
    int* counters, void* out, int out_bf16, void* stream) {
  using namespace rtq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 parts(E * M, ((2 * Hp) / 4 + kPrologueWords - 1) / kPrologueWords);
  if (x_bf16) {
    w4a8_prologue_kernel<__nv_bfloat16><<<parts, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, S, src_tail, outlier_idx, Tn, M, qmax,
        inv_qmax, q2, Hp, q8, Tp, scale);
  } else {
    w4a8_prologue_kernel<float><<<parts, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), K, S, src_tail, outlier_idx, Tn, M, qmax, inv_qmax, q2,
        Hp, q8, Tp, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return w4_tc_launch(tile, q2, Hp, w4, (K + S) / 2, q8, Tp, w8, Tn, E, M, N, stages_per_split,
                      nsplit, scale, s4, s8, acc_ws, counters, out, out_bf16, st);
}
