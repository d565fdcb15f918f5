// The prefill tile of the weight-only bf16 tensor-core GEMM that B5
// (quant_matmul.cu) and B4 (ocs_matmul.cu) share, for Hopper (sm_90a):
//     y = (x_exp @ w8) * (x_scale[m] * w_scale[n]),
//     x_exp = [x | x[:, src_tail] * tail_mult]   (B4; B5 has no tail)
// the function of wo_tc_gemm.cuh's decode tile, on the same operands, for
// calls of many rows (the wrapper's tc_plan picks the tile from M at the
// host). wo_tc_prefill_kernel is a sibling of wo_tc_gemm_kernel: it reuses
// that header's constants, bf16_pair and mma_16816 and leaves its kernel
// and launchers as they are.
//
// What bounds it on this card: the products, on the bf16 tensor cores (a
// glm4-9b step's M = 256 calls: 4.58 ms at 989 TFLOP/s). The decode tile
// converts each int8 weight stage to bf16 once per 32 tokens and splits K
// over the grid whatever M is, so at M = 256 each weight box is converted 8
// times and every split writes an [nsplit, M, N] f32 partial. This tile
// converts a box once per 64 tokens, keeps 16 warps of an SM busy on four
// stages at once, and walks all of a block's splits in time, with no
// partial and no workspace. The plan gives it the calls where that pays:
// 64 rows or more, and enough 64 x 128 tiles to give most SMs a block (at
// glm4-9b: w_gate/w_up and the lm_head from 64 rows on, wq/wo and w_down
// from 129); calls with few tiles (wk/wv) keep the decode tile, which was
// faster there on the H100 (PERF.md).
//
// The bits are the decode tile's, row for row, whatever M is: each output
// element goes through the same chain of operations. In the decode tile,
// within split z (tc_split_plan's, from (K, S, N) alone), warp w sums the
// stages s = w, w + 4, ... in order, two 16-row mma_16816 steps a stage
// from an f32 zero, contraction row 4t + rr of a step in k slot {2t, 2t+1,
// 2t+8, 2t+9}[rr], zero B entries included; the 4 warps' sums are added with
// __fadd_rn in order w = 0..3, the split totals in order z = 0..nsplit-1,
// and the total is multiplied by out_scale. Here the decode tile's warp c is
// the block's warp group c ("chain" c): the group's 4 warps sum the stages
// s = c, c + 4, ... of the split, each for 32 of the block's 128 columns,
// with the same fragments and MMAs; at the split's end the four chain sums
// meet in shared memory in order c = 0..3 and the split's total joins the
// running total of the splits, in z order. Which MMA row, token column or
// warp computes an element does not change its bits; the k slot of each
// contraction row and the order of the adds do, and they are the decode
// tile's. No block ever adds a subset of the splits ahead of the rest.
//
// Design of wo_tc_prefill_kernel. A block owns 64 tokens x 128 columns and
// has 16 warps: group c = warp / 4 takes chain c, and its warp w = warp % 4
// columns 32w .. 32w + 31 of all 64 tokens (2 MMA row blocks x 8 token
// groups: 64 f32 accumulators a thread). Each group streams its own stages
// through its own ring of kPfRing slots with the TMA (lane 0 of the group's
// warp 0 asks for stage i + kPfRing - 1 once the group has released stage
// i - 1): the weights' [32 rows x 128 columns] box (128-byte swizzle, as
// the decode tile's) and the tokens' [64 rows x 32 bf16] box (64-byte
// swizzle: 16-byte chunk c of row r at c ^ ((r / 2) % 4)), counted on the
// slot's "full" mbarrier; the group's 4 warps arrive on its "empty" one. So
// four stages, one a chain, are in work at once, and each is read by the 4
// warps that need it. The ring's depth, the group layout and the row and
// tile thresholds of the plan were chosen by timing on the H100 (PERF.md):
// one block of 16 warps an SM (196 KB of shared memory).
//
// A thread (g = lane / 4, t = lane % 4) reads 4 weight bytes, columns
// 4g..4g+3 of its warp's 32, from each of rows 4t..4t+3 of a step, and
// converts them exactly in registers (bf16_pair): the A fragments of 2 MMAs
// (row block 0: columns 4g, 4g+1 as MMA rows g, g+8; row block 1: 4g+2,
// 4g+3), each fed to 8 token groups. The B fragment of token group q
// is one 8-byte load of token row 8q + p(g), p = (0, 1, 4, 5, 2, 3, 6, 7):
// under the 64-byte swizzle each half-warp's 16 loads then hit 32 distinct
// banks.
//
// The chain sums' meeting. Group 0 writes its sum of split z to a shared
// buffer T and arrives on named barrier 1; group 1 waits there, adds its
// sum (T = T + c1, __fadd_rn) and arrives on barrier 2; group 2 likewise on
// 3; group 3 waits on 3, forms T + c3 and adds it into the running total of
// the splits (its own elements: z == first ? t : total + t), then arrives
// on barrier 4, where group 0 waits before it writes T for the next split.
// Every group goes on to the next split as soon as its sum has been added.
//
// A block walks every split of its tile, and the running total never leaves
// shared memory until the epilogue multiplies it by out_scale: one launch,
// no workspace, no counter.
//
// The OCS tail (TAIL, B4). Split boundaries are whole stages, so no stage
// mixes base and tail rows. A base stage is B5's. A tail stage (virtual row
// r >= Kb) loads its weight box at real row K + (r - Kb) and no token box:
// once the group has released the slot's previous stage, the group's 128
// threads gather the token tile into the slot, x[m, src_tail[j]] *
// tail_mult[j] rounded to bf16 as tail_fragments rounds it (zero past S,
// past the split or past M), meet on the group's own named barrier, and
// read it as a base stage's. Gathering into the B fragments in the hot
// loop, as the decode tile does, made every B4 stage slower, tail or not.
// Shapes the TMA cannot take (N % 16 != 0 or K % 8 != 0) are never planned
// here: they stay on the decode tile's non-TMA branch, and this launcher
// refuses them.
//
// The expert axis, as the decode tile's (wo_tc_gemm.cuh): in the STACK
// instantiation expert e of a stacked launch is blockIdx.z, its operands
// are read at their offsets and at matrix e of the TMA maps, so each
// expert's output is bitwise a 2-D launch's on its slice; a 2-D call runs
// the instantiation without the offsets.

#pragma once

#include "wo_tc_gemm.cuh"

namespace rtq {
namespace {  // internal linkage: each library keeps its own copy

constexpr int kPfToks = 64;                        // tokens a block
constexpr int kPfWarps = 16;                       // 4 groups (chains) x 4 warps
constexpr int kPfThreads = 32 * kPfWarps;
constexpr int kPfGroupThreads = 128;
constexpr int kPfRing = 4;                         // ring slots a group
constexpr int kPfXTile = kPfToks * kTcStageK * 2;  // a stage's token tile (4 KB)
constexpr int kPfSumStride = kTcCols + 4;          // padded row of a [64][128] f32 buffer
constexpr int kPfSumBytes = kPfToks * kPfSumStride * 4;
// Dynamic shared memory: the 4 groups' rings (weight tiles, then token
// tiles), the chain sums' buffer T and the running total, and 1 KB to align
// the start (the 128-byte swizzle's unit): 196 KB, one block an SM.
constexpr int kPfSmem = 1024 + 4 * kPfRing * (kTcWTile + kPfXTile) + 2 * kPfSumBytes;

// Byte offset of byte `byte` (0..63) of row `row` in a 64-byte-swizzled
// token tile.
__device__ __forceinline__ int pf_xoff(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// The bounds [kz0, kz1) of split z's rows of the contraction, and its
// stages.
__device__ __forceinline__ int pf_split(int z, int k_chunk, int kv, int& kz0, int& kz1) {
  kz0 = z * k_chunk;
  kz1 = min(kv, kz0 + k_chunk);
  return (kz1 - kz0 + kTcStageK - 1) / kTcStageK;
}

__device__ __forceinline__ void pf_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(2 * kPfGroupThreads) : "memory");
}
__device__ __forceinline__ void pf_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(2 * kPfGroupThreads) : "memory");
}
// Group c's own barrier (5 + c: 1-4 are the chain sums').
__device__ __forceinline__ void pf_group_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(5 + c), "r"(kPfGroupThreads) : "memory");
}

// The stages of chain c in a block's walk, in order: split z (0 ..
// nsplit - 1), stage s = c, c + 4, ... of it (a split with fewer than c + 1
// stages has none of chain c).
struct PfChainCursor {
  int z, s, kz0, kz1, nst;
  bool ok;
  __device__ __forceinline__ void settle(int c, int nsplit, int k_chunk, int kv) {
    while (s >= nst) {
      if (++z >= nsplit) {
        ok = false;
        return;
      }
      nst = pf_split(z, k_chunk, kv, kz0, kz1);
      s = c;
    }
    ok = true;
  }
  __device__ __forceinline__ void start(int c, int nsplit, int k_chunk, int kv) {
    z = 0;
    s = c;
    nst = pf_split(z, k_chunk, kv, kz0, kz1);
    settle(c, nsplit, k_chunk, kv);
  }
  __device__ __forceinline__ void next(int c, int nsplit, int k_chunk, int kv) {
    s += 4;
    settle(c, nsplit, k_chunk, kv);
  }
};

template <bool TAIL, bool STACK, typename TO>
__global__ void __launch_bounds__(kPfThreads, 1) wo_tc_prefill_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w [E, K + S, N] int8, boxes 128 x 32
    const __grid_constant__ CUtensorMap xmap,  // x [E, M, K] bf16, boxes 32 x 64
    const __nv_bfloat16* __restrict__ x,       // [E, M, K], K % 8 == 0
    int M, int K,
    int S, int Kb,                             // TAIL: tail rows; K rounded up to a stage
    const int* __restrict__ src_tail,          // [E, S] (TAIL)
    const float* __restrict__ tail_mult,       // [E, S] of 0 and 1, or null (= 1) (TAIL)
    int N, int k_chunk, int nsplit,            // N % 16 == 0
    const float* __restrict__ xs,              // [E, M] or null (= 1)
    const float* __restrict__ ws,              // [E, N]
    TO* __restrict__ out) {                    // [E, M, N]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[4][kPfRing];
  __shared__ __align__(8) uint64_t empty[4][kPfRing];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* wring = smem;                          // [4][kPfRing] weight tiles
  unsigned char* xring = smem + 4 * kPfRing * kTcWTile;  // [4][kPfRing] token tiles
  float* tbuf = reinterpret_cast<float*>(xring + 4 * kPfRing * kPfXTile);  // T [64][132]
  float* total = tbuf + kPfToks * kPfSumStride;        // running total [64][132]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = warp >> 2, w = warp & 3;  // the warp's chain (group) and column slice
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kPfToks;
  const int n0 = blockIdx.y * kTcCols;
  // The block's expert and (STACK) its operands.
  const int ex = STACK ? (int)blockIdx.z : 0;
  if (STACK) {
    x += (size_t)ex * M * K;
    if (TAIL) {
      src_tail += (size_t)ex * S;
      if (tail_mult != nullptr) tail_mult += (size_t)ex * S;
    }
    if (xs != nullptr) xs += (size_t)ex * M;
    ws += (size_t)ex * N;
    out += (size_t)ex * M * N;
  }
  const int kv = TAIL ? Kb + S : K;  // rows of the contraction (virtual with TAIL)

  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < 4 * kPfRing; ++j) {
      mbar_init(&full[j / kPfRing][j % kPfRing], 1);
      mbar_init(&empty[j / kPfRing][j % kPfRing], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Group c's ring: the stage under the issuing cursor into slot `slot`
  // (lane 0 of the group's warp 0): the weight tile (rows kz0 + 32s ..,
  // or real row K + (r - Kb) for a tail stage) and, for a base stage, the
  // token tile; the TMA zero-fills past the tensors' rows, N and M.
  const bool issuer = w == 0 && lane == 0;
  PfChainCursor ahead;
  ahead.start(c, nsplit, k_chunk, kv);
  auto issue = [&](int slot) {
    const int k0 = ahead.kz0 + ahead.s * kTcStageK;
    const bool tail = TAIL && k0 >= Kb;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive_expect_tx(&full[c][slot], kTcWTile + (tail ? 0 : kPfXTile));
    tma_load_3d(wring + (c * kPfRing + slot) * kTcWTile, &wmap, n0,
                tail ? K + (k0 - Kb) : k0, ex, &full[c][slot]);
    if (!tail)
      tma_load_3d(xring + (c * kPfRing + slot) * kPfXTile, &xmap, k0, m0, ex, &full[c][slot]);
  };
  if (issuer)
    for (int j = 0; j < kPfRing - 1 && ahead.ok; ++j) {
      issue(j);
      ahead.next(c, nsplit, k_chunk, kv);
    }
  __syncwarp();

  // The thread's weight bytes of row 16h + 4t + rr of a stage lie at
  // abase[rr] + 2048h; its B fragment of token group q at bbase[h] + 512q.
  const int cw = 2 * w + (g >> 2);  // the 16-byte chunk of its columns
  int abase[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = 4 * t + rr;
    abase[rr] = r * kTcCols + ((cw ^ (r & 7)) << 4) + 4 * (g & 3);
  }
  const int p = (g & 1) | ((g & 2) << 1) | ((g & 4) >> 1);  // token row of MMA column g
  int bbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) bbase[h] = pf_xoff(p, 32 * h + 8 * t);
  const int pe = ((t & 1) << 2) | (t & 2);    // p(2t): token row of MMA column 2t

  float acc[2][8][4];
  int i = 0;  // the group's stages so far
#pragma unroll 1
  for (int z = 0; z < nsplit; ++z) {
    int kz0, kz1;
    const int nst = pf_split(z, k_chunk, kv, kz0, kz1);
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rb][q][e] = 0.f;
#pragma unroll 1
    for (int s = c; s < nst; s += 4, ++i) {
      const int slot = i % kPfRing;
      const int k0 = kz0 + s * kTcStageK;
      unsigned char* xt = xring + (c * kPfRing + slot) * kPfXTile;
      if (TAIL && k0 >= Kb) {
        // A tail stage: once the group has released the slot's previous
        // stage, its 128 threads gather the token tile into the slot, each
        // tail entries jj, jj + 1 (jj = 2 (thread % 16)) of 8 tokens, as
        // tail_fragments rounds them; then the group meets on its barrier.
        if (i >= kPfRing) mbar_wait(&empty[c][slot], ((i / kPfRing) - 1) & 1);
        const int gt = 32 * w + lane, jj = 2 * (gt & 15);
        const int j = k0 - Kb + jj, jend = kz1 - Kb;
        int src[2];
        float mult[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool ok = j + u < jend;
          src[u] = ok ? __ldg(src_tail + j + u) : -1;
          mult[u] = ok && tail_mult != nullptr ? __ldg(tail_mult + j + u) : 1.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int tok = (gt >> 4) + 8 * u, m = m0 + tok;
          uint32_t e[2] = {0u, 0u};
          if (m < M) {
            const __nv_bfloat16* xr = x + (size_t)m * K;
#pragma unroll
            for (int v = 0; v < 2; ++v)
              if (src[v] >= 0)
                e[v] = __bfloat16_as_ushort(
                    __float2bfloat16_rn(__fmul_rn(__bfloat162float(xr[src[v]]), mult[v])));
          }
          *reinterpret_cast<uint32_t*>(xt + pf_xoff(tok, 2 * jj)) = e[0] | (e[1] << 16);
        }
        pf_group_sync(c);
      }
      mbar_wait(&full[c][slot], (i / kPfRing) & 1);
      const unsigned char* wt = wring + (c * kPfRing + slot) * kTcWTile;
#pragma unroll
      for (int h = 0; h < kTcStageK / 16; ++h) {
        uint32_t raw[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          raw[rr] =
              *reinterpret_cast<const uint32_t*>(wt + 2048 * h + abase[rr]) ^ 0x80808080u;
        // Row block rb: columns 4g + 2rb (MMA row g) and 4g + 2rb + 1 (row
        // g + 8); k slots 2t, 2t+1 rows 4t, 4t+1, slots 2t+8, 2t+9 rows
        // 4t+2, 4t+3, as tc_step places them.
        uint32_t a[2][4];
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          a[rb][0] = bf16_pair(raw[0], raw[1], 2 * rb);
          a[rb][1] = bf16_pair(raw[0], raw[1], 2 * rb + 1);
          a[rb][2] = bf16_pair(raw[2], raw[3], 2 * rb);
          a[rb][3] = bf16_pair(raw[2], raw[3], 2 * rb + 1);
        }
        // Rows past the split's end need no mask: split ends are whole
        // stages, except at K (whose token columns the TMA zero-fills: the
        // decode tile's masked zeros, bit for bit) and past S in the tail
        // (gathered as zeros).
        uint32_t b[8][2];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint2 v = *reinterpret_cast<const uint2*>(xt + bbase[h] + 512 * q);
          b[q][0] = v.x;
          b[q][1] = v.y;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          mma_16816(acc[0][q], a[0][0], a[0][1], a[0][2], a[0][3], b[q][0], b[q][1]);
          mma_16816(acc[1][q], a[1][0], a[1][1], a[1][2], a[1][3], b[q][0], b[q][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c][slot]);
      // Refill the slot of stage i - 1 with the group's stage i + kPfRing - 1.
      if (issuer && ahead.ok) {
        const int rs = (i + kPfRing - 1) % kPfRing;
        if (i > 0) mbar_wait(&empty[c][rs], ((i - 1) / kPfRing) & 1);
        issue(rs);
        ahead.next(c, nsplit, k_chunk, kv);
      }
      __syncwarp();  // converged again before the next stage's MMAs
    }
    // The four chain sums of split z meet in T in order c = 0..3, and the
    // split's total joins the running total (group 3's elements, z order).
    if (c == 0 && z != 0) pf_bar_sync(4);  // group 3 has read T of split z - 1
    if (c != 0) pf_bar_sync(c);             // group c - 1 has added its sum
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 32 * w + 4 * g + 2 * rb, tok = 8 * q + pe;
        float2* t0 = reinterpret_cast<float2*>(tbuf + tok * kPfSumStride + col);
        float2* t1 = reinterpret_cast<float2*>(tbuf + (tok + 1) * kPfSumStride + col);
        float2 v0 = make_float2(acc[rb][q][0], acc[rb][q][2]);
        float2 v1 = make_float2(acc[rb][q][1], acc[rb][q][3]);
        if (c != 0) {
          const float2 o0 = *t0, o1 = *t1;
          v0 = make_float2(__fadd_rn(o0.x, v0.x), __fadd_rn(o0.y, v0.y));
          v1 = make_float2(__fadd_rn(o1.x, v1.x), __fadd_rn(o1.y, v1.y));
        }
        if (c != 3) {
          *t0 = v0;
          *t1 = v1;
        } else {
          float2* r0 = reinterpret_cast<float2*>(total + tok * kPfSumStride + col);
          float2* r1 = reinterpret_cast<float2*>(total + (tok + 1) * kPfSumStride + col);
          if (z != 0) {
            const float2 o0 = *r0, o1 = *r1;
            v0 = make_float2(__fadd_rn(o0.x, v0.x), __fadd_rn(o0.y, v0.y));
            v1 = make_float2(__fadd_rn(o1.x, v1.x), __fadd_rn(o1.y, v1.y));
          }
          *r0 = v0;
          *r1 = v1;
        }
      }
    if (c != 3) pf_bar_arrive(c + 1);
    else if (z + 1 < nsplit) pf_bar_arrive(4);
  }
  __syncthreads();  // every element's total in shared memory

  const int mrows = min(kPfToks, M - m0), ncols = min(kTcCols, N - n0);
  for (int e = tid; e < mrows * kTcCols; e += kPfThreads) {
    const int r = e / kTcCols, col = e % kTcCols;
    if (col < ncols)
      store_out(out, (size_t)(m0 + r) * N + n0 + col,
                __fmul_rn(total[r * kPfSumStride + col], out_scale(xs, ws, m0 + r, n0 + col)));
  }
}

// The prefill tile's launcher, with wo_tc_launch's operands (E experts) and
// its contract (k_chunk % 32 == 0 with k_chunk * nsplit >= K, or Kb + S
// with TAIL), less the workspace and counters it needs no more. N % 16 == 0
// and K % 8 == 0 (the TMA's), else cudaErrorInvalidValue. Returns
// cudaGetLastError() (0 = ok).
template <bool TAIL>
int wo_tc_prefill_launch(const void* x, int E, int M, int K, int S, const int* src_tail,
                         const float* tail_mult, const int8_t* w8, const float* xs,
                         const float* ws, int N, int k_chunk, int nsplit, void* out,
                         int out_bf16, void* stream) {
  // The largest dynamic shared memory set for this instantiation, per
  // STACK, output type and device.
  static std::atomic<int> smem_set[4][kMaxDevices];
  if (N % 16 != 0 || K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int Kb = (K + kTcStageK - 1) / kTcStageK * kTcStageK;
  CUtensorMap wmap{}, xmap{};
  if (!(stack_map(&wmap, w8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, E, K + S, N, kTcCols, kTcStageK,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
        stack_map(&xmap, xb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, E, M, K, kTcStageK, kPfToks,
                  CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kPfToks - 1) / kPfToks, (N + kTcCols - 1) / kTcCols, E);
  cudaError_t err;
  auto run = [&](auto kern, std::atomic<int>* set, auto* o) {
    err = ensure_dynamic_smem(kern, set, kPfSmem);
    if (err != cudaSuccess) return;
    kern<<<grid, kPfThreads, kPfSmem, st>>>(wmap, xmap, xb, M, K, S, Kb, src_tail, tail_mult, N,
                                         k_chunk, nsplit, xs, ws, o);
  };
  if (out_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (E > 1) run(wo_tc_prefill_kernel<TAIL, true, __nv_bfloat16>, smem_set[3], o);
    else run(wo_tc_prefill_kernel<TAIL, false, __nv_bfloat16>, smem_set[1], o);
  } else {
    auto* o = static_cast<float*>(out);
    if (E > 1) run(wo_tc_prefill_kernel<TAIL, true, float>, smem_set[2], o);
    else run(wo_tc_prefill_kernel<TAIL, false, float>, smem_set[0], o);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' dispatch (E experts, E = 1 for a 2-D call): tile 0 is
// the decode tile (wo_tc_launch, its token groups chosen from M), 1 the
// prefill tile (the wrapper's tc_plan;
// part and counters unused). Any other tile is cudaErrorInvalidValue.
template <bool TAIL>
int wo_tc_tile_launch(const void* x, int E, int M, int K, int S, const int* src_tail,
                      const float* tail_mult, const int8_t* w8, const float* xs, const float* ws,
                      int N, int k_chunk, int nsplit, int tile, float* part, int* counters,
                      void* out, int out_bf16, void* stream) {
  if (tile == 0)
    return wo_tc_launch<TAIL>(x, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N, k_chunk, nsplit,
                              part, counters, out, out_bf16, stream);
  if (tile != 1) return static_cast<int>(cudaErrorInvalidValue);
  return wo_tc_prefill_launch<TAIL>(x, E, M, K, S, src_tail, tail_mult, w8, xs, ws, N, k_chunk,
                                    nsplit, out, out_bf16, stream);
}

}  // namespace
}  // namespace rtq
