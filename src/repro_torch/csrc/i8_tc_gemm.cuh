// The int8 tensor-core GEMMs with their epilogues, for Hopper (sm_90a):
//   i8_tc_gemm_kernel (B1, fused_qmatmul.cu): one sum over int8 weights,
//     out[m, n] = f32(sum_k q[m, k] * w[k, n]) * (xs[m] * ws[n])
//   with q [M, Kp] int8 (row stride Kp, a multiple of 16, zero past the
//   contraction), w [Ke, N] int8 (N contiguous, Ke <= Kp), xs [M] (or null
//   = 1) and ws [N] f32, out [M, N] f32 or bf16;
//   w4_tc_gemm_kernel (B6, w4a8_qmatmul.cu), its sibling on the same tile,
//   ring and fragments: two sums, acc4 over split-half packed int4 weights
//   w4 [H, N] (byte row j: expanded row j in its low nibble, row H + j in
//   its high one) against q2 [M, 2 * Hp] (expanded rows [0, H) at column
//   0, [H, 2H) at column Hp), and acc8 over int8 outlier rows w8 [T, N]
//   against q8 [M, Tp], with B6's epilogue
//     out = fma(f32(acc4), xs[m] * s4[n], f32(acc8) * (xs[m] * s8[n]))
//   (f32(acc4) * (xs[m] * s4[n]) when T == 0), every step an _rn intrinsic.
// B1's kernel is its own, so that B6's stages and sums leave B1's code as
// it was. wo_tc_gemm.cuh is the bf16 counterpart that serves B4 and B5.
//
// Why the bits are the plain version's. s8 x s8 products summed in s32 are
// exact in any order, tile or split ((K + S) * 127 * 127 < 2^31 at every
// glm4-9b shape: 13970 * 16129; B6's nibbles enter as 16 x their value,
// (K + S) * 127 * 128 < 2^31 too), so the tile and the split are chosen
// from M at the host and a row's bits still do not depend on the call's row
// count. The one float step is the epilogue, one code path for every tile
// and split, grouped and rounded as the plain version's.
//
// What bounds it on this card: at decode (M <= 8) the weight bytes over HBM
// (B1's int8: 2.7 ms of a glm4-9b step at 3.35 TB/s; B6's nibbles and
// outlier rows: 1.5 ms); at prefill (M = 256) the products, on the int8
// tensor cores (1,979 TOP/s dense, which mma.sync does not reach).
//
// Design of i8_tc_gemm_kernel<WC, WT, TG, MINB>. A block owns 64*WC
// output columns and 8*TG*WT tokens, and a range of whole 32-row stages of
// the contraction (split K over blockIdx.z). Its WC*WT consumer warps each
// own 64 columns x 8*TG tokens; one more warp is the producer. The
// producer's lane 0 streams the block's stages through a ring of kI8Stages
// slots in shared memory with the TMA: per stage the weights' [32 rows x
// 64*WC columns] as boxes of 128 columns (128-byte swizzle: 16-byte chunk c
// of row r lies at chunk c ^ (r % 8)) and the tokens' [8*TG*WT rows x 32
// bytes] (32-byte swizzle: chunk c of row r at c ^ ((r / 4) % 2)), counted
// on the slot's "full" mbarrier; a slot is refilled once every consumer
// warp has arrived on its "empty" mbarrier. The TMA zero-fills what lies
// past the weight rows, N or M.
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
// B6's stages. The first nst4 stages of its contraction are int4 stages: 32
// byte rows of w4 (the same box as B1's, half of B1's bytes a contraction
// row) and two token boxes, q2's columns 32s.. and Hp + 32s.. (Hp a
// multiple of 32, so no box reads across the halves). After the transposes
// a word holds 4 consecutive byte rows of one column; w & 0xF0F0F0F0 is 16 x
// its high nibbles as int8 bytes and (w << 4) & 0xF0F0F0F0 16 x its low ones
// (two's complement: byte h << 4 is 16 * sext4(h)), the A fragments of two
// k-steps against the two token boxes: 8 MMAs a token group for one weight
// box, 3 integer operations a word to unpack. The sum is 16 x acc4, exact,
// and shifted back (>> 4, exact) where it leaves the registers. The rest are
// outlier stages, B1's stage exactly over w8 [T, N] and q8 (the TMA
// zero-fills past T). A stage's expect_tx count follows its kind. A block
// keeps one register sum: if its stage range crosses from the int4 stages
// to the outlier ones, each warp parks acc4 in shared memory (a region of
// its own, beside the ring) and starts acc8 from zero.
//
// Epilogue in the kernel. The warps' int32 sums meet in shared memory (the
// ring's space), and the block writes them in coalesced rows: with one
// split it applies the epilogue itself; with several, each block adds its
// sums into an int32 accumulator ([M, N]; B6 with T > 0: acc4 then acc8,
// [2, M, N]) with atomics (exact, so the order does not matter), and the
// last block of a tile to finish (an atomic count, reset by that block)
// reads the totals, 16 in flight a thread, applies the epilogue and zeroes
// the accumulator again. No memset and no separate epilogue launch.
//
// The TMA needs N % 16 == 0 and 16-byte aligned weights; the launchers
// refuse anything else (cudaErrorInvalidValue), and a caller with a ragged
// N (hymba-1.5b's 32001-column lm_head) zero-pads the weights' columns.
//
// The expert axis. Both kernels compute E products at once, one per matrix
// of a stack (a MoE layer's experts; every operand gains a leading [E],
// q [E, M, Kp], w [E, Ke, N], ...; a 2-D call is E = 1). In the STACK
// instantiation expert e is blockIdx.z / nsplit, its split blockIdx.z %
// nsplit; its boxes come from matrix e of 3-D TMA maps (zero-filled past
// its own rows and columns), its scales, outputs, accumulator and counters
// from its offsets; a 2-D call runs the instantiation without the offsets.
// Its blocks do a 2-D launch's work on its slice, so each expert's output
// is bitwise that launch's.

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
// ring (every slot's weight boxes, then every slot's token boxes: one, or
// two for B6's int4 stages) or the warps' int32 sums [tokens][columns + 4],
// whichever is larger, then (W4) the parked acc4 of the same shape, plus 1
// KB to align the start (the 128-byte swizzle's unit).
template <int WC, int WT, int TG, bool W4 = false>
struct I8Tile {
  static constexpr int kWarps = WC * WT;              // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
  static constexpr int kCols = kI8WarpCols * WC;
  static constexpr int kToks = 8 * TG * WT;
  static constexpr int kWStage = kI8StageK * kCols;  // bytes
  static constexpr int kXStage = kToks * kI8StageK;  // bytes of one token box
  static constexpr int kXSlot = (W4 ? 2 : 1) * kXStage;
  static constexpr int kOutStride = kCols + 4;       // int32 words a token row
  static constexpr int kRing = kI8Stages * (kWStage + kXSlot);
  static constexpr int kOut = kToks * kOutStride * 4;
  static constexpr int kMain = kRing > kOut ? kRing : kOut;
  static constexpr int kSmem = 1024 + kMain + (W4 ? kOut : 0);
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

template <int WC, int WT, int TG, int MINB, bool STACK, typename TO>
__global__ void __launch_bounds__(I8Tile<WC, WT, TG>::kThreads, MINB) i8_tc_gemm_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w [E, Ke, N], boxes 128 x 32
    const __grid_constant__ CUtensorMap qmap,  // q [E, M, Kp], boxes 32 x kToks
    int M, int Kp, int N, int stages_per_split, int nsplit,
    const float* __restrict__ xs,  // [E, M] or null (= 1)
    const float* __restrict__ ws,  // [E, N]
    int* __restrict__ acc_ws,      // [E, M, N] when nsplit > 1, zero at rest
    int* __restrict__ counters,    // [E, gridDim.x * gridDim.y], zero at rest
    TO* __restrict__ out) {        // [E, M, N]
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
  // The block's expert and split, and (STACK) the expert's operands.
  const int ex = STACK ? (int)blockIdx.z / nsplit : 0;
  const int zs = STACK ? (int)blockIdx.z - ex * nsplit : (int)blockIdx.z;
  if (STACK) {
    if (xs != nullptr) xs += (size_t)ex * M;
    ws += (size_t)ex * N;
    out += (size_t)ex * M * N;
    if (nsplit > 1) {
      acc_ws += (size_t)ex * M * N;
      counters += (size_t)ex * gridDim.x * gridDim.y;
    }
  }
  const int nst = (Kp + kI8StageK - 1) / kI8StageK;
  const int s0 = zs * stages_per_split;
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
          tma_load_3d(wring + slot * T::kWStage + b * kI8StageK * kI8BoxCols, &wmap,
                      n0 + b * kI8BoxCols, k0, ex, &full[slot]);
        tma_load_3d(xring + slot * T::kXStage, &qmap, k0, m0, ex, &full[slot]);
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

// A weight map ([E, rows, N] bytes, boxes 128 x 32, 128-byte swizzle) and a
// token map ([E, M, cols] bytes, boxes 32 x toks, 32-byte swizzle): B1's and
// B6's.
inline bool i8_weight_map(CUtensorMap* map, const void* w, int E, int rows, int N) {
  return stack_map(map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, rows, N, kI8BoxCols, kI8StageK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}
inline bool i8_token_map(CUtensorMap* map, const void* q, int E, int M, int cols, int toks) {
  return stack_map(map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, M, cols, kI8StageK, toks,
                   CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int WC, int WT, int TG, int MINB, bool STACK, typename TO>
int launch_i8(const int8_t* q, int E, int M, int Kp, const int8_t* w, int Ke, int N,
              int stages_per_split, int nsplit, const float* xs, const float* ws, int* acc_ws,
              int* counters, void* out, cudaStream_t st) {
  using T = I8Tile<WC, WT, TG>;
  // The largest dynamic shared memory set for this instantiation, per device.
  static std::atomic<int> smem_set[kMaxDevices];
  CUtensorMap wmap{}, qmap{};
  if (N % 16 != 0 || !(i8_weight_map(&wmap, w, E, Ke, N) &&
                       i8_token_map(&qmap, q, E, M, Kp, T::kToks)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = i8_tc_gemm_kernel<WC, WT, TG, MINB, STACK, TO>;
  cudaError_t err = ensure_dynamic_smem(kern, smem_set, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + T::kToks - 1) / T::kToks, (N + T::kCols - 1) / T::kCols, E * nsplit);
  kern<<<grid, T::kThreads, T::kSmem, st>>>(wmap, qmap, M, Kp, N, stages_per_split, nsplit, xs,
                                            ws, acc_ws, counters, static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int WC, int WT, int TG, int MINB>
int launch_i8_tile(const int8_t* q, int E, int M, int Kp, const int8_t* w, int Ke, int N,
                   int stages_per_split, int nsplit, const float* xs, const float* ws,
                   int* acc_ws, int* counters, void* out, int out_bf16, cudaStream_t st) {
  if (E > 1) {
    if (out_bf16)
      return launch_i8<WC, WT, TG, MINB, true, __nv_bfloat16>(
          q, E, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws, acc_ws, counters, out, st);
    return launch_i8<WC, WT, TG, MINB, true, float>(q, E, M, Kp, w, Ke, N, stages_per_split,
                                                    nsplit, xs, ws, acc_ws, counters, out, st);
  }
  if (out_bf16)
    return launch_i8<WC, WT, TG, MINB, false, __nv_bfloat16>(
        q, 1, M, Kp, w, Ke, N, stages_per_split, nsplit, xs, ws, acc_ws, counters, out, st);
  return launch_i8<WC, WT, TG, MINB, false, float>(q, 1, M, Kp, w, Ke, N, stages_per_split,
                                                   nsplit, xs, ws, acc_ws, counters, out, st);
}

// Every token group's B fragment from a token box (zeros past M), loaded at
// once, then the live groups' MMAs.
template <int TG>
__device__ __forceinline__ void i8_box_mmas(int (&acc)[TG][4][4], const uint32_t (&a)[2][8],
                                            const unsigned char* xt, int tr0, int g, int t,
                                            int live) {
  uint32_t b[TG][2];
#pragma unroll
  for (int q = 0; q < TG; ++q) {
    const int tr = tr0 + 8 * q + g;  // token row of the tile
    const int sw = (tr >> 2) & 1;
    const unsigned char* row = xt + tr * kI8StageK + 4 * t;
    b[q][0] = *reinterpret_cast<const uint32_t*>(row + (sw << 4));
    b[q][1] = *reinterpret_cast<const uint32_t*>(row + ((sw ^ 1) << 4));
  }
#pragma unroll
  for (int q = 0; q < TG; ++q)
    if (q < live) i8_group_mmas(acc[q], a, b[q][0], b[q][1]);
}

// A consumer warp's sums into ot [token][column] (row stride `stride`
// words), each shifted right by `shift` (4 for B6's 16 x acc4: exact).
template <int TG>
__device__ __forceinline__ void i8_store_sums(int* ot, int stride, const int (&acc)[TG][4][4],
                                              int tok0, int col0, int g, int t, int shift) {
#pragma unroll
  for (int q = 0; q < TG; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tok = tok0 + 8 * q + 2 * t, c = col0 + 8 * g + 2 * j;
      *reinterpret_cast<int2*>(ot + tok * stride + c) =
          make_int2(acc[q][j][0] >> shift, acc[q][j][2] >> shift);
      *reinterpret_cast<int2*>(ot + (tok + 1) * stride + c) =
          make_int2(acc[q][j][1] >> shift, acc[q][j][3] >> shift);
    }
}

// B6's epilogue of output (m, n) from its sums.
__device__ __forceinline__ float w4a8_out(int a4, int a8, bool outliers, const float* xs,
                                          const float* s4, const float* s8, int m, int n) {
  const float c4 = __fmul_rn(xs[m], s4[n]);
  if (!outliers) return __fmul_rn(__int2float_rn(a4), c4);
  return __fmaf_rn(__int2float_rn(a4), c4,
                   __fmul_rn(__int2float_rn(a8), __fmul_rn(xs[m], s8[n])));
}

// B6's GEMM: i8_tc_gemm_kernel's tile, ring, fragments and split-K
// epilogue over nst4 int4 stages (w4map, q2map) and then ceil(T / 32)
// outlier stages (w8map, q8map); two sums, acc4 and acc8.
template <int WC, int WT, int TG, int MINB, bool STACK, typename TO>
__global__ void __launch_bounds__(I8Tile<WC, WT, TG>::kThreads, MINB) w4_tc_gemm_kernel(
    const __grid_constant__ CUtensorMap w4map,  // w4 [E, H, N], boxes 128 x 32
    const __grid_constant__ CUtensorMap q2map,  // q2 [E, M, 2 Hp], boxes 32 x kToks
    const __grid_constant__ CUtensorMap w8map,  // w8 [E, T, N], boxes 128 x 32 (unset when T == 0)
    const __grid_constant__ CUtensorMap q8map,  // q8 [E, M, Tp], boxes 32 x kToks (unset when T == 0)
    int M, int nst4, int nst, int hp, int N, int stages_per_split, int nsplit,
    const float* __restrict__ xs,  // [E, M]
    const float* __restrict__ s4,  // [E, N]
    const float* __restrict__ s8,  // [E, N]
    int* __restrict__ acc_ws,      // [E, T > 0 ? 2 : 1, M, N] when nsplit > 1, zero at rest
    int* __restrict__ counters,    // [E, gridDim.x * gridDim.y], zero at rest
    TO* __restrict__ out) {        // [E, M, N]
  using T = I8Tile<WC, WT, TG, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kI8Stages];
  __shared__ __align__(8) uint64_t empty[kI8Stages];
  __shared__ int s_last;
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * T::kToks;
  const int n0 = blockIdx.y * T::kCols;
  // The block's expert and split, and (STACK) the expert's operands.
  const int ex = STACK ? (int)blockIdx.z / nsplit : 0;
  const int zs = STACK ? (int)blockIdx.z - ex * nsplit : (int)blockIdx.z;
  if (STACK) {
    xs += (size_t)ex * M;
    s4 += (size_t)ex * N;
    s8 += (size_t)ex * N;
    out += (size_t)ex * M * N;
    if (nsplit > 1) {
      acc_ws += (size_t)ex * (nst > nst4 ? 2 : 1) * M * N;
      counters += (size_t)ex * gridDim.x * gridDim.y;
    }
  }
  const int s0 = zs * stages_per_split;
  const int mine = max(0, min(nst, s0 + stages_per_split) - s0);
  const int wc = warp % WC, wt = warp / WC;  // a consumer warp's column and token slot
  // Its token groups holding a token.
  const int live = max(0, min(TG, (M - m0 - wt * 8 * TG + 7) / 8));
  const bool outliers = nst > nst4;
  // The parked acc4 of a block whose stages cross into the outlier rows.
  int* park = reinterpret_cast<int*>(smem + T::kMain);

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
    // have released the slot's previous stage; an int4 stage's second
    // token box (the high nibbles' activations) is q2's column hp + k0.
    if (lane == 0)
      for (int i = 0; i < mine; ++i) {
        const int slot = i % kI8Stages;
        if (i >= kI8Stages) mbar_wait(&empty[slot], ((i / kI8Stages) - 1) & 1);
        const int s = s0 + i;
        const bool four = s < nst4;
        const CUtensorMap* wm = four ? &w4map : &w8map;
        const CUtensorMap* qm = four ? &q2map : &q8map;
        const int k0 = (four ? s : s - nst4) * kI8StageK;
        unsigned char* xdst = xring + slot * T::kXSlot;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(&full[slot], T::kWStage + (four ? 2 : 1) * T::kXStage);
#pragma unroll
        for (int b = 0; b < T::kCols / kI8BoxCols; ++b)
          tma_load_3d(wring + slot * T::kWStage + b * kI8StageK * kI8BoxCols, wm,
                      n0 + b * kI8BoxCols, k0, ex, &full[slot]);
        tma_load_3d(xdst, qm, k0, m0, ex, &full[slot]);
        if (four) tma_load_3d(xdst + T::kXStage, qm, hp + k0, m0, ex, &full[slot]);
      }
  } else {
    // A consumer: its 8 columns of the weight box lie in 16-byte chunk
    // `chunk`, at byte `half` of it.
    const int lcol = (wc & 1) * kI8WarpCols + 8 * g;
    const int chunk = lcol >> 4, half = lcol & 8;
    for (int i = 0; i < mine; ++i) {
      const int slot = i % kI8Stages;
      const bool four = s0 + i < nst4;
      if (s0 + i == nst4 && i > 0) {
        // The block's int4 stages are done: park acc4, start acc8.
        i8_store_sums(park, T::kOutStride, acc, wt * 8 * TG, wc * kI8WarpCols, g, t, 4);
#pragma unroll
        for (int q = 0; q < TG; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][j][e] = 0;
      }
      mbar_wait(&full[slot], (i / kI8Stages) & 1);
      const unsigned char* wbox =
          wring + slot * T::kWStage + (wc >> 1) * (kI8StageK * kI8BoxCols);
      const unsigned char* xt = xring + slot * T::kXSlot;
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
      if (four) {
        uint32_t nib[2][8];  // 16 x the low nibbles, then 16 x the high ones
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 8; ++c) nib[h][c] = (a[h][c] << 4) & 0xF0F0F0F0u;
        i8_box_mmas<TG>(acc, nib, xt, wt * 8 * TG, g, t, live);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 8; ++c) nib[h][c] = a[h][c] & 0xF0F0F0F0u;
        i8_box_mmas<TG>(acc, nib, xt + T::kXStage, wt * 8 * TG, g, t, live);
      } else {
        i8_box_mmas<TG>(acc, a, xt, wt * 8 * TG, g, t, live);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }

  // The warps' sums meet in shared memory (the ring's space), [token][column];
  // acc4 leaves the registers as its value (>> 4).
  const int slast = s0 + mine - 1;  // the block's last stage
  __syncthreads();
  int* ot = reinterpret_cast<int*>(smem);
  if (warp < T::kWarps)
    i8_store_sums(ot, T::kOutStride, acc, wt * 8 * TG, wc * kI8WarpCols, g, t,
                  slast < nst4 ? 4 : 0);
  __syncthreads();
  // Where the block's sums lie; null where its stages hold none of a kind.
  const bool has4 = s0 < nst4, has8 = slast >= nst4;
  const int* p8 = has8 ? ot : nullptr;
  const int* p4 = has4 ? (has8 ? park : ot) : nullptr;
  const int mrows = min(T::kToks, M - m0);
  const int ncols = min(T::kCols, N - n0);
  const size_t mn = (size_t)M * N;
  if (nsplit == 1) {
    for (int e = tid; e < mrows * T::kCols; e += T::kThreads) {
      const int r = e / T::kCols, c = e % T::kCols;
      if (c < ncols) {
        const int m = m0 + r, n = n0 + c, o = r * T::kOutStride + c;
        store_out(out, (size_t)m * N + n,
                  w4a8_out(p4[o], outliers ? p8[o] : 0, outliers, xs, s4, s8, m, n));
      }
    }
    return;
  }
  // Several splits: each block adds its sums into the int32 accumulator
  // (exact in any order); the last block of this (token tile, column tile)
  // reads the totals, applies the epilogue and leaves the accumulator zero.
  for (int e = tid; e < mrows * T::kCols; e += T::kThreads) {
    const int r = e / T::kCols, c = e % T::kCols;
    if (c < ncols) {
      const size_t i = (size_t)(m0 + r) * N + n0 + c;
      const int o = r * T::kOutStride + c;
      if (p4 != nullptr) atomicAdd(acc_ws + i, p4[o]);
      if (p8 != nullptr) atomicAdd(acc_ws + mn + i, p8[o]);
    }
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
    int a[kBatch], b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T::kThreads, r = e / T::kCols, c = e % T::kCols;
      const bool in = e < mrows * T::kCols && c < ncols;
      const size_t i = (size_t)(m0 + r) * N + n0 + c;
      a[u] = in ? __ldcg(acc_ws + i) : 0;
      b[u] = outliers && in ? __ldcg(acc_ws + mn + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * T::kThreads, r = e / T::kCols, c = e % T::kCols;
      if (e < mrows * T::kCols && c < ncols) {
        const int m = m0 + r, n = n0 + c;
        const size_t i = (size_t)m * N + n;
        acc_ws[i] = 0;
        if (outliers) acc_ws[mn + i] = 0;
        store_out(out, i, w4a8_out(a[u], b[u], outliers, xs, s4, s8, m, n));
      }
    }
  }
  if (tid == 0) *count = 0;
}

// B6's GEMM of one block tile and one instantiation (STACK: E > 1), as
// launch_w4_tile describes it.
template <int WC, int WT, int TG, int MINB, bool STACK>
int launch_w4(const int8_t* q2, int Hp, const uint8_t* w4, int H, const int8_t* q8, int Tp,
              const int8_t* w8, int Tn, int E, int M, int N, int stages_per_split, int nsplit,
              const float* xs, const float* s4, const float* s8, int* acc_ws, int* counters,
              void* out, int out_bf16, cudaStream_t st) {
  using T = I8Tile<WC, WT, TG, true>;
  // The largest dynamic shared memory set for each output type, per device.
  static std::atomic<int> smem_set[2][kMaxDevices];
  CUtensorMap w4map{}, q2map{}, w8map{}, q8map{};
  if (N % 16 != 0 || Hp % kI8StageK != 0 || Hp < H || Tp < Tn ||
      !(i8_weight_map(&w4map, w4, E, H, N) &&
        i8_token_map(&q2map, q2, E, M, 2 * Hp, T::kToks)) ||
      (Tn > 0 && !(i8_weight_map(&w8map, w8, E, Tn, N) &&
                   i8_token_map(&q8map, q8, E, M, Tp, T::kToks))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst4 = Hp / kI8StageK;
  const int nst = nst4 + (Tn + kI8StageK - 1) / kI8StageK;
  const dim3 grid((M + T::kToks - 1) / T::kToks, (N + T::kCols - 1) / T::kCols, E * nsplit);
  cudaError_t err;
  if (out_bf16) {
    auto kern = w4_tc_gemm_kernel<WC, WT, TG, MINB, STACK, __nv_bfloat16>;
    err = ensure_dynamic_smem(kern, smem_set[1], T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, T::kThreads, T::kSmem, st>>>(w4map, q2map, w8map, q8map, M, nst4, nst, Hp, N,
                                              stages_per_split, nsplit, xs, s4, s8, acc_ws,
                                              counters, static_cast<__nv_bfloat16*>(out));
  } else {
    auto kern = w4_tc_gemm_kernel<WC, WT, TG, MINB, STACK, float>;
    err = ensure_dynamic_smem(kern, smem_set[0], T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, T::kThreads, T::kSmem, st>>>(w4map, q2map, w8map, q8map, M, nst4, nst, Hp, N,
                                              stages_per_split, nsplit, xs, s4, s8, acc_ws,
                                              counters, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// B6's launcher of one block tile (B1's tiles: <4, 1, 1, 1> at decode, <2,
// 2, 4, 2> above M = 8), over E experts (E = 1: a 2-D call). q2 [E, M, 2 *
// Hp] int8 (Hp % 32 == 0, Hp >= H), w4 [E, H, N] uint8; q8 [E, M, Tp] int8
// (Tp % 16 == 0, Tp >= Tn) and w8 [E, Tn, N] int8, both unused when Tn ==
// 0; N % 16 == 0, 16-byte aligned weights; stages_per_split * nsplit stages
// cover the Hp / 32 int4 stages and the ceil(Tn / 32) outlier stages; xs
// [E, M], s4 and s8 [E, N]; acc_ws [E, Tn > 0 ? 2 : 1, M, N] int32 and
// counters (one int per expert, token tile and column tile), both zero at
// rest and left zero by the kernel, unused when nsplit == 1. Returns
// cudaGetLastError() (0 = ok).
template <int WC, int WT, int TG, int MINB>
int launch_w4_tile(const int8_t* q2, int Hp, const uint8_t* w4, int H, const int8_t* q8, int Tp,
                   const int8_t* w8, int Tn, int E, int M, int N, int stages_per_split, int nsplit,
                   const float* xs, const float* s4, const float* s8, int* acc_ws,
                   int* counters, void* out, int out_bf16, cudaStream_t st) {
  if (E > 1)
    return launch_w4<WC, WT, TG, MINB, true>(q2, Hp, w4, H, q8, Tp, w8, Tn, E, M, N,
                                             stages_per_split, nsplit, xs, s4, s8, acc_ws,
                                             counters, out, out_bf16, st);
  return launch_w4<WC, WT, TG, MINB, false>(q2, Hp, w4, H, q8, Tp, w8, Tn, 1, M, N,
                                            stages_per_split, nsplit, xs, s4, s8, acc_ws,
                                            counters, out, out_bf16, st);
}

}  // namespace
}  // namespace rtq
