// The weight-only bf16 tensor-core GEMM that B5 (quant_matmul.cu) and B4
// (ocs_matmul.cu) share, for Hopper (sm_90a):
//     y = (x_exp @ w8) * (x_scale[m] * w_scale[n]),
//     x_exp = [x | x[:, src_tail] * tail_mult]   (B4; B5 has no tail)
// with x [M, K] bf16, w8 [K + S, N] int8 and tail_mult absent or a 0/1
// mask. Each source keeps its own C entry point and library; this header
// keeps the one copy of the kernel and its launcher, wo_tc_launch<TAIL>
// (TAIL = false is B5's instantiation, TAIL = true B4's).
//
// The expert axis. A launch computes E such products at once, one per
// matrix of a stack (a MoE layer's experts: x [E, M, K], w8 [E, K + S, N],
// src_tail and tail_mult [E, S], xs [E, M], ws [E, N], out [E, M, N]); a
// plain 2-D call is E = 1. In the STACK instantiation, expert e is
// blockIdx.z / nsplit (its split blockIdx.z % nsplit), its operands are
// read at their offsets (the TMA boxes at matrix e of 3-D maps, which
// zero-fill past its own rows and columns), and it has its own partials
// and counters; a 2-D call runs the instantiation without those offsets,
// whose code is the 2-D kernel's (its registers, its speed). A block's work
// is that of a 2-D launch on expert e's slice, so each expert's output is
// bitwise that launch's. Stacks take the TMA path only (N % 16 == 0, K % 8
// == 0; every MoE expert shape).
//
// Why tensor cores keep the contract. Every int8 weight converts exactly to
// bf16, a bf16 activation times a multiplier of 0 or 1 is the activation or
// zero (exact), and a bf16 x bf16 product is exact in f32, so
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 sums the same exact products
// the plain version sums, in f32; only the order (and the tensor core's
// internal alignment) differs, within the summation-order bound chip_smoke
// holds it to. Then * (x_scale * w_scale) as before.
//
// What bounds it on this card: at decode (M = 8) the int8 weight bytes over
// HBM (2.6-2.7 ms of a glm4-9b step at 3.35 TB/s); at prefill (M = 256) the
// products, on the bf16 tensor cores rather than the f32 CUDA cores -- but
// this tile is built for decode (8-32 tokens a block, each weight stage
// converted once per block), so at M = 256 it still trails a bf16 GEMM.
// Calls of many rows take wo_tc_prefill.cuh's prefill tile instead, which
// sums every output element in this kernel's exact order.
//
// Design of wo_tc_gemm_kernel. A block of 4 warps owns 128 output columns
// (one warp's width) and 8*G tokens (G groups of 8, the MMA's n) and a
// range of the contraction (split K over blockIdx.z, from (K, S, N) alone:
// the wrapper's tc_split_plan). Weights are operand A -- 16 columns of N
// per MMA "row" block -- and tokens operand B. The warps take the block's
// 32-row stages in turn (warp w: stages w, w+4, ...); each warp streams its
// stages through a ring of kTcStages slots in shared memory with the TMA:
// per stage one 2-D box of the weights (32 rows x 128 columns, 128-byte
// swizzled) and one of the tokens (8G rows x 32 bf16), both counted on the
// slot's mbarrier, which the warp waits on before it reads the slot; the
// TMA zero-fills what lies past the tensor's rows, N or M. (Copies of 16
// bytes a thread with cp.async streamed the same tiles markedly slower on
// the H100: PERF.md §6.) A thread reads the 16 columns 16g..16g+15 (g =
// lane / 4) of rows 4t..4t+3 (t = lane % 4) of each 16-row step: with the
// MMA's k slots {2t, 2t+1, 2t+8, 2t+9} mapped to rows 4t..4t+3 and MMA
// j's rows g and g+8 mapped to columns 16g+2j and 16g+2j+1, the A fragment
// of MMA j is 8 of those bytes, converted exactly in registers (the byte
// XOR 0x80 under the f32 pattern of 2^23, minus 2^23 + 128; the bf16 is the
// f32's high half), and the B fragment is 4 consecutive bf16 of a token's
// row. Each warp sums its stages in order with the MMA's f32 accumulators;
// the 4 warps meet in shared memory in order w = 0..3; with one split the
// block applies the epilogue itself; with several, each block writes its
// partial [z, m, n] and the last block of a tile to finish (an atomic
// count, reset by that block) adds the partials in order z = 0..nsplit-1
// and applies the epilogue: one launch a call, no float atomics. A row's
// bits thus follow from (K, S, N) alone, not from M, G or the row chunk it
// ran in. Shapes the TMA cannot take (N % 16 != 0 or K % 8 != 0: no
// serving shape) read the same pieces straight from global memory.
//
// The OCS tail (TAIL, B4). The contraction walks Kb + S virtual rows, Kb =
// K rounded up to a stage (32 rows); split boundaries are whole stages, so
// no stage mixes base and tail rows. A base stage (virtual rows < Kb) is
// B5's stage unchanged: its weight rows K..Kb-1 (tail rows, or past the
// tensor) meet tokens the TMA zero-filled past K, so they add exact zeros.
// A tail stage (virtual row r >= Kb) loads its weight box at real row
// K + (r - Kb) (TMA coordinates need no alignment) and arms its mbarrier
// with the weight box's bytes alone; the threads gather its B fragment,
// x[m, src_tail[j]] * tail_mult[j] rounded to bf16 (exact: the multiplier
// is 0 or 1), zero past S, past the split or past M -- direct bf16 loads of
// rows L2 already holds, the same 4 consecutive k slots a thread as a base
// stage, issued before the wait for the weight box. The expanded
// activations never go through device memory, and no pre-pass is
// launched.

#pragma once

#include "qmatmul_common.cuh"
#include "tma.cuh"

namespace rtq {
namespace {  // internal linkage: each library keeps its own copy

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcCols = 128;                   // columns a block (a warp's width)
constexpr int kTcStageK = 32;                  // rows of K a ring stage (a row a lane)
constexpr int kTcStages = 3;                   // ring slots a warp
constexpr int kTcWTile = kTcStageK * kTcCols;  // a stage's weight tile (4 KB)
constexpr int kTcRedStride = kTcCols + 4;      // padded row of the warps' sums

// Largest dynamic shared memory set per instantiation (G 1/2/4 x TMA x
// STACK x output type) and device.
std::atomic<int> g_tc_smem_set[24][kMaxDevices];

__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t wx, int byte) {
  // wx holds the bytes XOR 0x80: 0x4B0000uu is 2^23 + uu, uu = v + 128.
  const float f = __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7540u | byte)) - 8388736.0f;
  return __float_as_uint(f);
}

// bf16x2 (lo, hi) of byte `byte` of two weight words (exact: |v| <= 128).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo_x, uint32_t hi_x, int byte) {
  return __byte_perm(i8_f32_bits(lo_x, byte), i8_f32_bits(hi_x, byte), 0x7632u);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Dynamic shared memory of the TMA path: every warp's ring of weight tiles
// (32 rows x 128 bytes, 128-byte swizzled by the TMA: 16-byte chunk c of
// row r lies at chunk c ^ (r % 8), 1024-byte aligned), then every warp's
// ring of token tiles (8G rows of 32 bf16), plus 1 KB to align the start.
// The warps' sums reuse it at the end.
__host__ __device__ constexpr int tc_xtile_bytes(int G) { return 8 * G * kTcStageK * 2; }

__host__ __device__ constexpr int tc_smem_bytes(int G, bool tma) {
  return 1024 + (tma && kTcWarps * kTcStages * (kTcWTile + tc_xtile_bytes(G)) >
                            kTcWarps * 8 * G * kTcRedStride * 4
                     ? kTcWarps * kTcStages * (kTcWTile + tc_xtile_bytes(G))
                     : kTcWarps * 8 * G * kTcRedStride * 4);
}

// One 16-row k-step of a warp: raw[rr] holds the thread's 16 weight bytes
// (columns 16g..16g+15) of row 4t + rr of the step; bf[q] the B fragment of
// token group q. MMA j covers columns 16g+2j (A row g) and 16g+2j+1 (A row
// g+8), its k slots {2t, 2t+1, 2t+8, 2t+9} rows 4t..4t+3.
template <int G>
__device__ __forceinline__ void tc_step(float (&acc)[G][8][4], uint4 (&raw)[4],
                                        const uint32_t (&bf)[G][2], int live_groups) {
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    raw[rr].x ^= 0x80808080u;
    raw[rr].y ^= 0x80808080u;
    raw[rr].z ^= 0x80808080u;
    raw[rr].w ^= 0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int byte = 2 * (j & 1);
    const uint32_t w0 = (&raw[0].x)[j >> 1], w1 = (&raw[1].x)[j >> 1];
    const uint32_t w2 = (&raw[2].x)[j >> 1], w3 = (&raw[3].x)[j >> 1];
    const uint32_t a0 = bf16_pair(w0, w1, byte);      // column 16g+2j,   rows 4t, 4t+1
    const uint32_t a1 = bf16_pair(w0, w1, byte + 1);  // column 16g+2j+1, rows 4t, 4t+1
    const uint32_t a2 = bf16_pair(w2, w3, byte);      // column 16g+2j,   rows 4t+2, 4t+3
    const uint32_t a3 = bf16_pair(w2, w3, byte + 1);  // column 16g+2j+1, rows 4t+2, 4t+3
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (q < live_groups) mma_16816(acc[q][j], a0, a1, a2, a3, bf[q][0], bf[q][1]);
  }
}

// The B fragments of one 16-row step of a tail stage: token m0 + 8q + g,
// tail entries j0..j0+3 (the thread's k slots), x[m, src_tail[j]] *
// tail_mult[j] rounded to bf16 (exact for a multiplier of 0 or 1; null
// reads as 1), zero for j >= jend (past S, or past this split) or a token
// past M.
template <int G>
__device__ __forceinline__ void tail_fragments(uint32_t (&bf)[G][2],
                                               const __nv_bfloat16* __restrict__ x, int M,
                                               int K, int m0, int g, int j0, int jend,
                                               const int* __restrict__ src_tail,
                                               const float* __restrict__ tail_mult) {
  int src[4];
  float mult[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool ok = j0 + u < jend;
    src[u] = ok ? __ldg(src_tail + j0 + u) : -1;
    mult[u] = ok && tail_mult != nullptr ? __ldg(tail_mult + j0 + u) : 1.f;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int m = m0 + 8 * q + g;
    uint32_t e[4] = {0u, 0u, 0u, 0u};
    if (m < M) {
      const __nv_bfloat16* xr = x + (size_t)m * K;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (src[u] >= 0)
          e[u] = __bfloat16_as_ushort(
              __float2bfloat16_rn(__fmul_rn(__bfloat162float(xr[src[u]]), mult[u])));
    }
    bf[q][0] = e[0] | (e[1] << 16);
    bf[q][1] = e[2] | (e[3] << 16);
  }
}

template <int G, bool TMA, bool TAIL, bool STACK, typename TO>
__global__ void __launch_bounds__(kTcThreads) wo_tc_gemm_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w [E, K + S, N] int8, boxes 128 x 32 (TMA)
    const __grid_constant__ CUtensorMap xmap,  // x [E, M, K] bf16, boxes 32 x 8G (TMA)
    const __nv_bfloat16* __restrict__ x,  // [E, M, K]; K % 8 == 0 when TMA
    int M, int K,
    int S, int Kb,                        // TAIL: tail rows; K rounded up to a stage
    const int* __restrict__ src_tail,     // [E, S] (TAIL)
    const float* __restrict__ tail_mult,  // [E, S] of 0 and 1, or null (= 1) (TAIL)
    const int8_t* __restrict__ w,         // [E, K + S, N], N % 4 == 0; N % 16 == 0 when TMA
    int N, int k_chunk, int nsplit,
    const float* __restrict__ xs,         // [E, M] or null (= 1)
    const float* __restrict__ ws,         // [E, N]
    float* __restrict__ part,             // [E, nsplit, M, N] when nsplit > 1
    int* __restrict__ counters,           // [E, gridDim.x * gridDim.y], zero at rest
    TO* __restrict__ out) {               // [E, M, N]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kTcWarps][kTcStages];
  __shared__ int s_last;
  // 1024-byte aligned start (the 128-byte swizzle's unit).
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 8 * G;
  const int n0 = blockIdx.y * kTcCols;
  // The block's expert and split, and (STACK) the expert's operands.
  const int ex = STACK ? (int)blockIdx.z / nsplit : 0;
  const int zs = STACK ? (int)blockIdx.z - ex * nsplit : (int)blockIdx.z;
  if (STACK) {
    x += (size_t)ex * M * K;
    w += (size_t)ex * (K + S) * N;
    if (TAIL) {
      src_tail += (size_t)ex * S;
      if (tail_mult != nullptr) tail_mult += (size_t)ex * S;
    }
    if (xs != nullptr) xs += (size_t)ex * M;
    ws += (size_t)ex * N;
    out += (size_t)ex * M * N;
    if (nsplit > 1) {
      part += (size_t)ex * nsplit * M * N;
      counters += (size_t)ex * gridDim.x * gridDim.y;
    }
  }
  const int kv = TAIL ? Kb + S : K;  // rows of the contraction (virtual with TAIL)
  const int kz0 = zs * k_chunk;
  const int kz1 = min(kv, kz0 + k_chunk);
  const int nstage = (kz1 - kz0 + kTcStageK - 1) / kTcStageK;
  const int mine = nstage > warp ? (nstage - warp + kTcWarps - 1) / kTcWarps : 0;
  const int live_groups = min(G, (M - m0 + 7) / 8);
  const int mrows = min(8 * G, M - m0);

  float acc[G][8][4];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;

  if (TMA) {
    unsigned char* wring = smem + warp * kTcStages * kTcWTile;
    unsigned char* xring =
        smem + kTcWarps * kTcStages * kTcWTile + warp * kTcStages * tc_xtile_bytes(G);
    uint64_t* bar = bars[warp];
    if (lane < kTcStages)
      asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_addr(bar + lane)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
    // Stage s into slot `slot`: lane 0 arms the slot's mbarrier with the
    // boxes' bytes and asks the TMA for the weight tile (rows kz0 + 32s ..,
    // the block's 128 columns) and the token tile (the block's 8G tokens,
    // the same 32 rows of K); a tail stage's weight tile starts at real row
    // K + (r - Kb), and it has no token tile. Elements past the tensors'
    // rows, N or M come as zeros; rows past kz1 (the next split's) are
    // masked out of the B fragments.
    auto issue = [&](int s, int slot) {
      __syncwarp();  // every lane done with the slot's last contents
      if (lane == 0) {
        const int k0 = kz0 + s * kTcStageK;
        const bool tail = TAIL && k0 >= Kb;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                         smem_addr(bar + slot)),
                     "r"(kTcWTile + (tail ? 0 : tc_xtile_bytes(G)))
                     : "memory");
        tma_load_3d(wring + slot * kTcWTile, &wmap, n0, tail ? K + (k0 - Kb) : k0, ex,
                    bar + slot);
        if (!tail)
          tma_load_3d(xring + slot * tc_xtile_bytes(G), &xmap, k0, m0, ex, bar + slot);
      }
    };
#pragma unroll
    for (int i = 0; i < kTcStages - 1; ++i)
      if (i < mine) issue(warp + kTcWarps * i, i);
    for (int i = 0; i < mine; ++i) {
      const int slot = i % kTcStages;
      const int s = warp + kTcWarps * i;
      const int k0 = kz0 + s * kTcStageK;
      const unsigned char* wsrc = wring + slot * kTcWTile;
      // The thread's 16 weight bytes of row 16h + 4t + rr of the stage.
      auto load_raw = [&](int h, uint4(&raw)[4]) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = 16 * h + 4 * t + rr;
          raw[rr] = *reinterpret_cast<const uint4*>(wsrc + r * kTcCols + ((g ^ (r & 7)) << 4));
        }
      };
      if (TAIL && k0 >= Kb) {
        // A tail stage: its token operand is gathered before the wait for
        // the weight box, so the loads overlap it.
        uint32_t bf[kTcStageK / 16][G][2];
#pragma unroll
        for (int h = 0; h < kTcStageK / 16; ++h)
          tail_fragments<G>(bf[h], x, M, K, m0, g, k0 - Kb + 16 * h + 4 * t, kz1 - Kb,
                            src_tail, tail_mult);
        mbar_wait(bar + slot, (i / kTcStages) & 1);
#pragma unroll
        for (int h = 0; h < kTcStageK / 16; ++h) {
          uint4 raw[4];
          load_raw(h, raw);
          tc_step<G>(acc, raw, bf[h], live_groups);
        }
      } else {
        mbar_wait(bar + slot, (i / kTcStages) & 1);
        const unsigned char* xsrc = xring + slot * tc_xtile_bytes(G);
#pragma unroll
        for (int h = 0; h < kTcStageK / 16; ++h) {
          uint4 raw[4];
          load_raw(h, raw);
          const bool k_ok = k0 + 16 * h + 4 * t < kz1;
          uint32_t bf[G][2];
#pragma unroll
          for (int q = 0; q < G; ++q) {
            uint2 v = make_uint2(0u, 0u);
            if (k_ok)
              v = *reinterpret_cast<const uint2*>(xsrc + (8 * q + g) * kTcStageK * 2 +
                                                  (16 * h + 4 * t) * 2);
            bf[q][0] = v.x;
            bf[q][1] = v.y;
          }
          tc_step<G>(acc, raw, bf, live_groups);
        }
      }
      if (i + kTcStages - 1 < mine)
        issue(warp + kTcWarps * (i + kTcStages - 1), (i + kTcStages - 1) % kTcStages);
    }
    __syncthreads();  // every warp done with its rings: reuse them for the sums
  } else {
    // N % 16 != 0 or K % 8 != 0 (no serving shape): each thread reads its
    // pieces straight from global memory, 4 bytes and one bf16 at a time.
    const int col = n0 + 16 * g;
    const int kx1 = min(kz1, K);  // base rows past K meet zero tokens (B5: kx1 == kz1)
    for (int i = 0; i < mine; ++i) {
      const int s = warp + kTcWarps * i;
      const int k0 = kz0 + s * kTcStageK;
      const bool tail = TAIL && k0 >= Kb;
#pragma unroll
      for (int h = 0; h < kTcStageK / 16; ++h) {
        const int k = k0 + 16 * h + 4 * t;  // the row of the thread's first k slot
        // Its real weight row, and the end of the rows that are live here.
        const int wk = tail ? K + (k - Kb) : k;
        const int wend = tail ? K + (kz1 - Kb) : kx1;
        uint4 raw[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          uint32_t* r32 = &raw[rr].x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r32[e] = wk + rr < wend && col + 4 * e < N
                         ? __ldg(reinterpret_cast<const unsigned int*>(
                               w + (size_t)(wk + rr) * N + col + 4 * e))
                         : 0u;
        }
        uint32_t bf[G][2];
        if (tail) {
          tail_fragments<G>(bf, x, M, K, m0, g, k - Kb, kz1 - Kb, src_tail, tail_mult);
        } else {
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const int m = m0 + 8 * q + g;
            uint32_t e[4] = {0u, 0u, 0u, 0u};
            if (m < M) {
              const unsigned short* xp =
                  reinterpret_cast<const unsigned short*>(x + (size_t)m * K + k);
#pragma unroll
              for (int u = 0; u < 4; ++u) e[u] = k + u < kx1 ? xp[u] : 0u;
            }
            bf[q][0] = e[0] | (e[1] << 16);
            bf[q][1] = e[2] | (e[3] << 16);
          }
        }
        tc_step<G>(acc, raw, bf, live_groups);
      }
    }
  }

  // The 4 warps' sums meet in shared memory, added in order w = 0..3.
  float* red = reinterpret_cast<float*>(smem);
  float* mine_red = red + warp * 8 * G * kTcRedStride;
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 16 * g + 2 * j, tok = 8 * q + 2 * t;
      *reinterpret_cast<float2*>(mine_red + tok * kTcRedStride + col) =
          make_float2(acc[q][j][0], acc[q][j][2]);
      *reinterpret_cast<float2*>(mine_red + (tok + 1) * kTcRedStride + col) =
          make_float2(acc[q][j][1], acc[q][j][3]);
    }
  __syncthreads();
  const int n = n0 + tid;  // one column a thread
  const bool col_ok = n < N;
  if (nsplit == 1) {
    if (col_ok)
      for (int tok = 0; tok < mrows; ++tok) {
        float a = red[tok * kTcRedStride + tid];
#pragma unroll
        for (int v = 1; v < kTcWarps; ++v)
          a = __fadd_rn(a, red[(v * 8 * G + tok) * kTcRedStride + tid]);
        store_out(out, (size_t)(m0 + tok) * N + n, __fmul_rn(a, out_scale(xs, ws, m0 + tok, n)));
      }
    return;
  }
  if (col_ok)
    for (int tok = 0; tok < mrows; ++tok) {
      float a = red[tok * kTcRedStride + tid];
#pragma unroll
      for (int v = 1; v < kTcWarps; ++v)
        a = __fadd_rn(a, red[(v * 8 * G + tok) * kTcRedStride + tid]);
      part[((size_t)zs * M + m0 + tok) * N + n] = a;
    }
  // The last block of this (token tile, column tile) adds the partials.
  __threadfence();
  __syncthreads();
  int* count = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(count, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // 8 tokens x 4 splits of partials in flight at a time (from L2), added
  // per token in order z = 0..nsplit-1.
  if (col_ok)
    for (int t0 = 0; t0 < mrows; t0 += 8) {
      float a[8];
      for (int z0 = 0; z0 < nsplit; z0 += 4) {
        float v[8][4];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[u][e] = t0 + u < mrows && z0 + e < nsplit
                          ? __ldcg(part + ((size_t)(z0 + e) * M + m0 + t0 + u) * N + n)
                          : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (z0 + e < nsplit) a[u] = z0 + e == 0 ? v[u][e] : __fadd_rn(a[u], v[u][e]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int m = m0 + t0 + u;
        if (t0 + u < mrows)
          store_out(out, (size_t)m * N + n, __fmul_rn(a[u], out_scale(xs, ws, m, n)));
      }
    }
  if (tid == 0) *count = 0;
}

template <int G, bool TMA, bool TAIL, bool STACK>
int launch_tc(const __nv_bfloat16* x, int E, int M, int K, int S, const int* src_tail,
              const float* tail_mult, const int8_t* w8, const float* xs, const float* ws, int N,
              int k_chunk, int nsplit, float* part, int* counters, void* out, int out_bf16,
              cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(G, TMA);
  const dim3 grid((M + 8 * G - 1) / (8 * G), (N + kTcCols - 1) / kTcCols, E * nsplit);
  const int slot =
      (((G == 1 ? 0 : G == 2 ? 1 : 2) * 2 + (TMA ? 1 : 0)) * 2 + (STACK ? 1 : 0)) * 2 +
      (out_bf16 ? 1 : 0);
  const int Kb = (K + kTcStageK - 1) / kTcStageK * kTcStageK;
  CUtensorMap wmap{}, xmap{};
  if (TMA && !(stack_map(&wmap, w8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, K + S, N, kTcCols,
                         kTcStageK, CU_TENSOR_MAP_SWIZZLE_128B) &&
               stack_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E, M, K, kTcStageK,
                         8 * G, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (out_bf16) {
    auto kern = wo_tc_gemm_kernel<G, TMA, TAIL, STACK, __nv_bfloat16>;
    err = ensure_dynamic_smem(kern, g_tc_smem_set[slot], smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kTcThreads, smem, st>>>(wmap, xmap, x, M, K, S, Kb, src_tail, tail_mult, w8, N,
                                         k_chunk, nsplit, xs, ws, part, counters,
                                         static_cast<__nv_bfloat16*>(out));
  } else {
    auto kern = wo_tc_gemm_kernel<G, TMA, TAIL, STACK, float>;
    err = ensure_dynamic_smem(kern, g_tc_smem_set[slot], smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kTcThreads, smem, st>>>(wmap, xmap, x, M, K, S, Kb, src_tail, tail_mult, w8, N,
                                         k_chunk, nsplit, xs, ws, part, counters,
                                         static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G, bool TAIL>
int launch_tc_g(const __nv_bfloat16* x, int E, int M, int K, int S, const int* src_tail,
                const float* tail_mult, const int8_t* w8, const float* xs, const float* ws,
                int N, int k_chunk, int nsplit, float* part, int* counters, void* out,
                int out_bf16, cudaStream_t st) {
  if (N % 16 == 0 && K % 8 == 0) {
    if (E > 1)
      return launch_tc<G, true, TAIL, true>(x, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N,
                                            k_chunk, nsplit, part, counters, out, out_bf16, st);
    return launch_tc<G, true, TAIL, false>(x, 1, M, K, S, src_tail, tail_mult, w8, xs, ws, N,
                                           k_chunk, nsplit, part, counters, out, out_bf16, st);
  }
  if (E > 1) return static_cast<int>(cudaErrorInvalidValue);  // stacks take the TMA path
  return launch_tc<G, false, TAIL, false>(x, 1, M, K, S, src_tail, tail_mult, w8, xs, ws, N,
                                          k_chunk, nsplit, part, counters, out, out_bf16, st);
}

// The launcher of both entry points, over E experts (E = 1: a 2-D call).
// x [E, M, K] bf16; w8 [E, K + S, N] int8 (S = 0, no tail, without TAIL);
// src_tail [E, S] int32, tail_mult [E, S] f32 of 0 and 1, or null (= 1); xs
// [E, M] f32 or null (= 1), ws [E, N] f32; k_chunk % 32 == 0 with k_chunk *
// nsplit >= K (B5) or Kb + S (B4, Kb = K rounded up to 32); part [E, nsplit,
// M, N] f32 scratch (unused when nsplit == 1); counters: one int per
// (expert, token tile, column tile) of the launch, zero at rest (the kernel
// leaves them zero). Tokens a block: 8 for M <= 8, 16 for M <= 16, else 32
// (the bits do not depend on it). A stack (E > 1) needs N % 16 == 0 and K %
// 8 == 0, else cudaErrorInvalidValue. Returns cudaGetLastError() (0 = ok).
template <bool TAIL>
int wo_tc_launch(const void* x, int E, int M, int K, int S, const int* src_tail,
                 const float* tail_mult, const int8_t* w8, const float* xs, const float* ws,
                 int N, int k_chunk, int nsplit, float* part, int* counters, void* out,
                 int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (M <= 8)
    return launch_tc_g<1, TAIL>(xb, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N, k_chunk,
                                nsplit, part, counters, out, out_bf16, st);
  if (M <= 16)
    return launch_tc_g<2, TAIL>(xb, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N, k_chunk,
                                nsplit, part, counters, out, out_bf16, st);
  return launch_tc_g<4, TAIL>(xb, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N, k_chunk,
                              nsplit, part, counters, out, out_bf16, st);
}

}  // namespace
}  // namespace rtq
