// The int8 tensor-core GEMM with its epilogue, for Hopper (sm_90a):
//     out[m, n] = f32(sum_k q[m, k] * w[k, n]) * (xs[m] * ws[n])
// with q [M, Kp] int8 (row stride Kp, a multiple of 16, zero past the
// contraction), w [Ke, N] int8 (N contiguous, Ke <= Kp), xs [M] (or null =
// 1) and ws [N] f32, out [M, N] f32 or bf16. B1 (fused_qmatmul.cu) runs it
// on the rows its prologue quantized, [x | x[:, src_tail]]; the header has
// no B1-specific piece, so B6's int4 pass and outlier rows can instantiate
// its ring and fragments later, as wo_tc_gemm.cuh serves B4 and B5.
//
// Why the bits are the plain version's. s8 x s8 products summed in s32 are
// exact in any order, tile or split ((K + S) * 127 * 127 < 2^31 at every
// glm4-9b shape: 13970 * 16129), so the tile and the split are chosen from
// M at the host and a row's bits still do not depend on the call's row
// count. The one float step is the epilogue, __fmul_rn(__int2float_rn(acc),
// xs[m] * ws[n]), grouped and rounded as the plain version's.
//
// What bounds it on this card: at decode (M <= 8) the int8 weight bytes over
// HBM (2.7 ms of a glm4-9b step at 3.35 TB/s); at prefill (M = 256) the
// products, on the int8 tensor cores (1,979 TOP/s dense, which mma.sync
// does not reach).
//
// Design of i8_tc_gemm_kernel<WC, WT, TG, MINB>. A block owns 64*WC output columns
// and 8*TG*WT tokens, and a range of whole 32-row stages of the contraction
// (split K over blockIdx.z). Its WC*WT consumer warps each own 64 columns x
// 8*TG tokens; one more warp is the producer. The producer's lane 0 streams
// the block's stages through a ring of kI8Stages slots in shared memory with
// the TMA: per stage the weights' [32 rows x 64*WC columns] as boxes of 128
// columns (128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r %
// 8)) and the tokens' [8*TG*WT rows x 32 bytes] (32-byte swizzle: chunk c
// of row r at c ^ ((r / 4) % 2)), counted on the slot's "full" mbarrier; a
// slot is refilled once every consumer warp has arrived on its "empty"
// mbarrier. The TMA zero-fills what lies past Ke, N or M.
//
// The MMA is mma.sync.m16n8k32.row.col.s32.s8.s8.s32 with the weights as
// operand A (16 output columns an MMA) and 8 tokens as operand B. The int8
// MMA wants 4 consecutive k bytes in each register; the weights hold N
// contiguous, and ldmatrix has no 8-bit transpose on sm_90, so each thread
// (g = lane / 4, t = lane % 4) reads 8 columns 8g..8g+7 of rows 4t..4t+3 and
// 16+4t..16+4t+3 (8-byte loads, conflict-free under the swizzle) and
// transposes each 4x4 byte block with __byte_perm: 32 PRMT a stage give the
// A fragments of 4 MMAs, which every one of the warp's TG token groups
// reuses. MMA j's A rows g and g+8 are columns 8g+2j and 8g+2j+1; its k
// slots {4t..4t+3, 16+4t..16+4t+3} are the stage's rows with the same
// numbers, so a B fragment is two 4-byte loads of a token's row.
//
// Epilogue in the kernel. The warps' int32 sums meet in shared memory (the
// ring's space), and the block writes them in coalesced rows: with one
// split it applies the epilogue itself; with several, each block adds its
// sums into an int32 accumulator [M, N] with atomics (exact, so the order
// does not matter), and the last block of a tile to finish (an atomic
// count, reset by that block) reads the totals, 16 in flight a thread,
// applies the epilogue and zeroes the accumulator again. No memset and no
// separate epilogue launch.
//
// The TMA needs N % 16 == 0 and 16-byte aligned weights; the launcher
// refuses anything else (cudaErrorInvalidValue), and a caller with a ragged
// N (hymba-1.5b's 32001-column lm_head) zero-pads the weights' columns.

#pragma once

#include "qmatmul_common.cuh"
#include "tma.cuh"

namespace rtq {
namespace {  // internal linkage: each library keeps its own copy

constexpr int kI8StageK = 32;    // rows of the contraction a stage (one MMA k-step)
constexpr int kI8WarpCols = 64;  // output columns a consumer warp
constexpr int kI8BoxCols = 128;  // columns of a weight box (the 128-byte swizzle's span)
constexpr int kI8Stages = 6;     // ring slots

// The block tile of i8_tc_gemm_kernel<WC, WT, TG> and its shared memory: the
// ring (every slot's weight boxes, then every slot's token tile) or the
// warps' int32 sums [tokens][columns + 4], whichever is larger, plus 1 KB
// to align the start (the 128-byte swizzle's unit).
template <int WC, int WT, int TG>
struct I8Tile {
  static constexpr int kWarps = WC * WT;              // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
  static constexpr int kCols = kI8WarpCols * WC;
  static constexpr int kToks = 8 * TG * WT;
  static constexpr int kWStage = kI8StageK * kCols;  // bytes
  static constexpr int kXStage = kToks * kI8StageK;  // bytes
  static constexpr int kOutStride = kCols + 4;       // int32 words a token row
  static constexpr int kRing = kI8Stages * (kWStage + kXStage);
  static constexpr int kOut = kToks * kOutStride * 4;
  static constexpr int kSmem = 1024 + (kRing > kOut ? kRing : kOut);
};

__device__ __forceinline__ void mma_16832_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 rows of 4 bytes (r[i] byte j: row i, column j) -> 4 columns of 4 bytes
// (c[j] byte i: row i, column j).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// The A fragments of one stage: a[h][c] holds column 8g + c of the thread's
// 8, rows 16h + 4t .. 16h + 4t + 3; lo[h][i] / hi[h][i] are columns 8g..8g+3
// / 8g+4..8g+7 of row 16h + 4t + i.
__device__ __forceinline__ void i8_a_fragments(const uint32_t (&lo)[2][4],
                                               const uint32_t (&hi)[2][4], uint32_t (&a)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    transpose4x4(lo[h][0], lo[h][1], lo[h][2], lo[h][3], &a[h][0]);
    transpose4x4(hi[h][0], hi[h][1], hi[h][2], hi[h][3], &a[h][4]);
  }
}

// The 4 MMAs of one token group: MMA j covers columns 8g+2j (A row g) and
// 8g+2j+1 (A row g+8).
__device__ __forceinline__ void i8_group_mmas(int (&acc)[4][4], const uint32_t (&a)[2][8],
                                              uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mma_16832_s8(acc[j], a[0][2 * j], a[0][2 * j + 1], a[1][2 * j], a[1][2 * j + 1], b0, b1);
}

template <int WC, int WT, int TG, int MINB, typename TO>
__global__ void __launch_bounds__(I8Tile<WC, WT, TG>::kThreads, MINB) i8_tc_gemm_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w [Ke, N], boxes 128 x 32
    const __grid_constant__ CUtensorMap qmap,  // q [M, Kp], boxes 32 x kToks
    int M, int Kp, int N, int stages_per_split, int nsplit,
    const float* __restrict__ xs,  // [M] or null (= 1)
    const float* __restrict__ ws,  // [N]
    int* __restrict__ acc_ws,      // [M, N] when nsplit > 1, zero at rest
    int* __restrict__ counters,    // [gridDim.x * gridDim.y], zero at rest
    TO* __restrict__ out) {        // [M, N]
  using T = I8Tile<WC, WT, TG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kI8Stages];
  __shared__ __align__(8) uint64_t empty[kI8Stages];
  __shared__ int s_last;
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * T::kToks;
  const int n0 = blockIdx.y * T::kCols;
  const int nst = (Kp + kI8StageK - 1) / kI8StageK;
  const int s0 = blockIdx.z * stages_per_split;
  const int mine = max(0, min(nst, s0 + stages_per_split) - s0);
  const int wc = warp % WC, wt = warp / WC;  // a consumer warp's column and token slot
  // Its token groups holding a token.
  const int live = max(0, min(TG, (M - m0 - wt * 8 * TG + 7) / 8));

  int acc[TG][4][4];
#pragma unroll
  for (int q = 0; q < TG; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0;

  unsigned char* wring = smem;
  unsigned char* xring = smem + kI8Stages * T::kWStage;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kI8Stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], T::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == T::kWarps) {
    // The producer: stage i into slot i % kI8Stages, once the consumers
    // have released the slot's previous stage.
    if (lane == 0)
      for (int i = 0; i < mine; ++i) {
        const int slot = i % kI8Stages;
        if (i >= kI8Stages) mbar_wait(&empty[slot], ((i / kI8Stages) - 1) & 1);
        const int k0 = (s0 + i) * kI8StageK;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(&full[slot], T::kWStage + T::kXStage);
#pragma unroll
        for (int b = 0; b < T::kCols / kI8BoxCols; ++b)
          tma_load_2d(wring + slot * T::kWStage + b * kI8StageK * kI8BoxCols, &wmap,
                      n0 + b * kI8BoxCols, k0, &full[slot]);
        tma_load_2d(xring + slot * T::kXStage, &qmap, k0, m0, &full[slot]);
      }
  } else {
    // A consumer: its 8 columns of the weight box lie in 16-byte chunk
    // `chunk`, at byte `half` of it.
    const int lcol = (wc & 1) * kI8WarpCols + 8 * g;
    const int chunk = lcol >> 4, half = lcol & 8;
    for (int i = 0; i < mine; ++i) {
      const int slot = i % kI8Stages;
      mbar_wait(&full[slot], (i / kI8Stages) & 1);
      const unsigned char* wbox =
          wring + slot * T::kWStage + (wc >> 1) * (kI8StageK * kI8BoxCols);
      const unsigned char* xt = xring + slot * T::kXStage;
      uint32_t lo[2][4], hi[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = 16 * h + 4 * t + ii;
          const uint2 v = *reinterpret_cast<const uint2*>(
              wbox + r * kI8BoxCols + ((chunk ^ (r & 7)) << 4) + half);
          lo[h][ii] = v.x;
          hi[h][ii] = v.y;
        }
      uint32_t a[2][8];
      i8_a_fragments(lo, hi, a);
      uint32_t b[TG][2];  // every group's B fragment (zeros past M), loaded at once
#pragma unroll
      for (int q = 0; q < TG; ++q) {
        const int tr = wt * 8 * TG + 8 * q + g;  // token row of the tile
        const int sw = (tr >> 2) & 1;
        const unsigned char* row = xt + tr * kI8StageK + 4 * t;
        b[q][0] = *reinterpret_cast<const uint32_t*>(row + (sw << 4));
        b[q][1] = *reinterpret_cast<const uint32_t*>(row + ((sw ^ 1) << 4));
      }
#pragma unroll
      for (int q = 0; q < TG; ++q)
        if (q < live) i8_group_mmas(acc[q], a, b[q][0], b[q][1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }

  // The warps' sums meet in shared memory (the ring's space), [token][column].
  __syncthreads();
  int* ot = reinterpret_cast<int*>(smem);
  if (warp < T::kWarps) {
#pragma unroll
    for (int q = 0; q < TG; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tok = wt * 8 * TG + 8 * q + 2 * t, c = wc * kI8WarpCols + 8 * g + 2 * j;
        *reinterpret_cast<int2*>(ot + tok * T::kOutStride + c) =
            make_int2(acc[q][j][0], acc[q][j][2]);
        *reinterpret_cast<int2*>(ot + (tok + 1) * T::kOutStride + c) =
            make_int2(acc[q][j][1], acc[q][j][3]);
      }
  }
  __syncthreads();
  const int mrows = min(T::kToks, M - m0);
  const int ncols = min(T::kCols, N - n0);
  if (nsplit == 1) {
    for (int e = tid; e < mrows * T::kCols; e += T::kThreads) {
      const int r = e / T::kCols, c = e % T::kCols;
      if (c < ncols) {
        const int m = m0 + r, n = n0 + c;
        store_out(out, (size_t)m * N + n,
                  __fmul_rn(__int2float_rn(ot[r * T::kOutStride + c]), out_scale(xs, ws, m, n)));
      }
    }
    return;
  }
  // Several splits: each block adds its sums into the int32 accumulator
  // (exact in any order); the last block of this (token tile, column tile)
  // reads the totals, applies the epilogue and leaves the accumulator zero.
  for (int e = tid; e < mrows * T::kCols; e += T::kThreads) {
    const int r = e / T::kCols, c = e % T::kCols;
    if (c < ncols) atomicAdd(acc_ws + (size_t)(m0 + r) * N + n0 + c, ot[r * T::kOutStride + c]);
  }
  __threadfence();
  __syncthreads();
  int* count = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(count, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  constexpr int kBatch = 16;  // totals in flight a thread
  for (int e0 = tid; e0 < mrows * T::kCols; e0 += kBatch * T::kThreads) {
    int a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T::kThreads, r = e / T::kCols, c = e % T::kCols;
      a[u] = e < mrows * T::kCols && c < ncols
                 ? __ldcg(acc_ws + (size_t)(m0 + r) * N + n0 + c)
                 : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T::kThreads, r = e / T::kCols, c = e % T::kCols;
      if (e < mrows * T::kCols && c < ncols) {
        const int m = m0 + r, n = n0 + c;
        acc_ws[(size_t)m * N + n] = 0;
        store_out(out, (size_t)m * N + n, __fmul_rn(__int2float_rn(a[u]), out_scale(xs, ws, m, n)));
      }
    }
  }
  if (tid == 0) *count = 0;
}

template <int WC, int WT, int TG, int MINB, typename TO>
int launch_i8(const int8_t* q, int M, int Kp, const int8_t* w, int Ke, int N,
              int stages_per_split, int nsplit, const float* xs, const float* ws, int* acc_ws,
              int* counters, void* out, cudaStream_t st) {
  using T = I8Tile<WC, WT, TG>;
  // The largest dynamic shared memory set for this instantiation, per device.
  static std::atomic<int> smem_set[kMaxDevices];
  CUtensorMap wmap{}, qmap{};
  if (N % 16 != 0 ||
      !(tensor_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Ke, N, kI8BoxCols, kI8StageK,
                   CU_TENSOR_MAP_SWIZZLE_128B) &&
        tensor_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, Kp, kI8StageK, T::kToks,
                   CU_TENSOR_MAP_SWIZZLE_32B)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = i8_tc_gemm_kernel<WC, WT, TG, MINB, TO>;
  cudaError_t err = ensure_dynamic_smem(kern, smem_set, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + T::kToks - 1) / T::kToks, (N + T::kCols - 1) / T::kCols, nsplit);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(wmap, qmap, M, Kp, N, stages_per_split, nsplit, xs,
                                            ws, acc_ws, counters, static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int WC, int WT, int TG, int MINB>
int launch_i8_tile(const int8_t* q, int M, int Kp, const int8_t* w, int Ke, int N,
                   int stages_per_split, int nsplit, const float* xs, const float* ws,
                   int* acc_ws, int* counters, void* out, int out_bf16, cudaStream_t st) {
  if (out_bf16)
    return launch_i8<WC, WT, TG, MINB, __nv_bfloat16>(q, M, Kp, w, Ke, N, stages_per_split,
                                                      nsplit, xs, ws, acc_ws, counters, out, st);
  return launch_i8<WC, WT, TG, MINB, float>(q, M, Kp, w, Ke, N, stages_per_split, nsplit, xs,
                                            ws, acc_ws, counters, out, st);
}

// The launcher. `tile` (the host's choice from M, kernels/fused_qmatmul.py's
// plan): 0 = 256 columns x 8 tokens a block, one block an SM (decode, M <=
// 8); 1 = 128 columns x 64 tokens, two blocks an SM (M > 8: verifies and
// prefills). q [M, Kp] int8, Kp % 16 == 0, zero past the contraction;
// w [Ke, N] int8, N % 16 == 0, 16-byte aligned; stages_per_split * nsplit 32-row stages
// cover Kp; acc_ws [M, N] int32 and counters (one int per token tile and
// column tile), both zero at rest and left zero by the kernel, unused when
// nsplit == 1. Returns cudaGetLastError() (0 = ok).
inline int i8_tc_launch(int tile, const int8_t* q, int M, int Kp, const int8_t* w, int Ke,
                        int N, int stages_per_split, int nsplit, const float* xs,
                        const float* ws, int* acc_ws, int* counters, void* out, int out_bf16,
                        cudaStream_t st) {
  switch (tile) {
    case 0:
      return launch_i8_tile<4, 1, 1, 1>(q, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws,
                                        acc_ws, counters, out, out_bf16, st);
    case 1:
      return launch_i8_tile<2, 2, 4, 2>(q, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws,
                                        acc_ws, counters, out, out_bf16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace rtq
