// Blocked quantized matmul (weight-only int8 and W8A8) for Hopper (sm_90a).
//
// Replaces repro/kernels/quant_matmul.py::_kernel (the Pallas TPU kernel
// behind quant_matmul_kernel / quant_matmul, and the S == 0 fallback of
// ocs_quant_matmul): y = (x @ w8) * (x_scale[m] * w_scale[n]) with
//   * x bf16: weight-only on bf16 tensor cores (wo_tc_gemm_kernel below).
//     Every linear layer of a clip-only tree (ocs_ratio = 0, the paper's
//     baseline) served in "dequant" mode;
//   * x f32 (no serving caller; its products are not exact in bf16):
//     weight-only on the CUDA cores, qmatmul_common.cuh's wo_gemm_kernel,
//     which ocs_matmul.cu (B4) shares;
//   * x int8: int8 x int8 -> int32 (B1's __dp4a GEMM, bitwise).
//
// Why tensor cores keep the contract. Every int8 weight converts exactly to
// bf16, and a bf16 x bf16 product is exact in f32, so
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 sums the same exact products
// the plain version sums, in f32; only the order (and the tensor core's
// internal alignment) differs, within the summation-order bound chip_smoke
// holds it to. Then * (x_scale * w_scale) as before.
//
// What bounds it on this card: at decode (M = 8) the int8 weight bytes over
// HBM (2.6 ms of a glm4-9b step at 3.35 TB/s); at prefill (M = 256) the
// products, which the bf16 tensor cores now take off the f32 CUDA cores.
//
// Design of wo_tc_gemm_kernel. A block of 4 warps owns 128 output columns
// (one warp's width) and 8*G tokens (G groups of 8, the MMA's n) and a
// range of K (split K over blockIdx.z, from (K, N) alone: the wrapper's
// tc_split_plan). Weights are operand A -- 16 columns of N per MMA "row"
// block -- and tokens operand B. The warps take the block's 32-row stages
// of K in turn (warp w: stages w, w+4, ...); each warp streams its stages
// through a ring of kTcStages slots in shared memory with the TMA: per
// stage one 2-D box of the weights (32 rows x 128 columns, 128-byte
// swizzled) and one of the tokens (8G rows x 32 bf16), both counted on the
// slot's mbarrier, which the warp waits on before it reads the slot; the
// TMA zero-fills what lies past K, N or M. (Copies of 16 bytes a thread
// with cp.async streamed the same tiles markedly slower on the H100:
// PERF.md §6.) A thread reads the 16 columns 16g..16g+15 (g =
// lane / 4) of K rows 4t..4t+3 (t = lane % 4) of each 16-row step: with
// the MMA's k slots {2t, 2t+1, 2t+8, 2t+9}
// mapped to K rows 4t..4t+3 and MMA j's rows g and g+8 mapped to columns
// 16g+2j and 16g+2j+1, the A fragment of MMA j is 8 of those bytes,
// converted exactly in registers (the byte XOR 0x80 under the f32 pattern
// of 2^23, minus 2^23 + 128; the bf16 is the f32's high half), and the B
// fragment is 4 consecutive bf16 of a token's row. Each warp sums its
// stages in order with the MMA's f32 accumulators; the 4 warps meet in
// shared memory in order w = 0..3; with one split the block applies the
// epilogue itself; with several, each block writes its partial [z, m, n]
// and the last block of a tile to finish (an atomic count, reset by that
// block) adds the partials in order z = 0..nsplit-1 and applies the
// epilogue: one launch a call, no float atomics. A row's bits thus follow
// from (K, N) alone, not from M, G or the row chunk it ran in. Shapes the
// TMA cannot take (N % 16 != 0 or K % 8 != 0: no serving shape) read the
// same pieces straight from global memory.
//
// The int8 path reads x in place when K % 16 == 0 and otherwise copies it
// once into a zero-padded [M, Kp] buffer.

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)

#include "qmatmul_common.cuh"

namespace {

using rtq::out_scale;
using rtq::store_out;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcCols = 128;                   // columns a block (a warp's width)
constexpr int kTcStageK = 32;                  // rows of K a ring stage (a row a lane)
constexpr int kTcStages = 3;                   // ring slots a warp
constexpr int kTcWTile = kTcStageK * kTcCols;  // a stage's weight tile (4 KB)
constexpr int kTcRedStride = kTcCols + 4;      // padded row of the warps' sums

// Largest dynamic shared memory set per instantiation (G 1/2/4 x TMA x
// output type) and device.
std::atomic<int> g_tc_smem_set[12][rtq::kMaxDevices];

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A 2-D tensor tile global -> shared through the TMA, counted on mbarrier
// `bar`; (c0, c1) = (inner, outer) element coordinates of the box.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

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
// (columns 16g..16g+15) of K row 4t + rr of the step; bf[q] the B fragment
// of token group q. MMA j covers columns 16g+2j (A row g) and 16g+2j+1 (A
// row g+8), its k slots {2t, 2t+1, 2t+8, 2t+9} K rows 4t..4t+3.
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

template <int G, bool TMA, typename TO>
__global__ void __launch_bounds__(kTcThreads) wo_tc_gemm_kernel(
    const __grid_constant__ CUtensorMap wmap,  // w [K, N] int8, boxes 128 x 32 (TMA)
    const __grid_constant__ CUtensorMap xmap,  // x [M, K] bf16, boxes 32 x 8G (TMA)
    const __nv_bfloat16* __restrict__ x,  // [M, K]; K % 8 == 0 when TMA
    int M, int K,
    const int8_t* __restrict__ w,         // [K, N], N % 4 == 0; N % 16 == 0 when TMA
    int N, int k_chunk, int nsplit,
    const float* __restrict__ xs,         // [M] or null (= 1)
    const float* __restrict__ ws,         // [N]
    float* __restrict__ part,             // [nsplit, M, N] when nsplit > 1
    int* __restrict__ counters,           // [gridDim.x * gridDim.y], zero at rest
    TO* __restrict__ out) {               // [M, N]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kTcWarps][kTcStages];
  __shared__ int s_last;
  // 1024-byte aligned start (the 128-byte swizzle's unit).
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 8 * G;
  const int n0 = blockIdx.y * kTcCols;
  const int kz0 = blockIdx.z * k_chunk;
  const int kz1 = min(K, kz0 + k_chunk);
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
    // Stage s into slot `slot`: lane 0 arms the slot's mbarrier with the two
    // boxes' bytes and asks the TMA for the weight tile (K rows kz0 + 32s
    // .., the block's 128 columns) and the token tile (the block's 8G
    // tokens, the same 32 K rows). Elements past K, N or M come as zeros;
    // K rows past kz1 (the next split's) are masked out of the B fragments.
    auto issue = [&](int s, int slot) {
      __syncwarp();  // every lane done with the slot's last contents
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                         smem_addr(bar + slot)),
                     "r"(kTcWTile + tc_xtile_bytes(G))
                     : "memory");
        const int k0 = kz0 + s * kTcStageK;
        tma_load_2d(wring + slot * kTcWTile, &wmap, n0, k0, bar + slot);
        tma_load_2d(xring + slot * tc_xtile_bytes(G), &xmap, k0, m0, bar + slot);
      }
    };
#pragma unroll
    for (int i = 0; i < kTcStages - 1; ++i)
      if (i < mine) issue(warp + kTcWarps * i, i);
    for (int i = 0; i < mine; ++i) {
      const int slot = i % kTcStages;
      mbar_wait(bar + slot, (i / kTcStages) & 1);
      const int s = warp + kTcWarps * i;
      const unsigned char* wsrc = wring + slot * kTcWTile;
      const unsigned char* xsrc = xring + slot * tc_xtile_bytes(G);
#pragma unroll
      for (int h = 0; h < kTcStageK / 16; ++h) {
        uint4 raw[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = 16 * h + 4 * t + rr;
          raw[rr] = *reinterpret_cast<const uint4*>(wsrc + r * kTcCols + ((g ^ (r & 7)) << 4));
        }
        const bool k_ok = kz0 + s * kTcStageK + 16 * h + 4 * t < kz1;
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
      if (i + kTcStages - 1 < mine)
        issue(warp + kTcWarps * (i + kTcStages - 1), (i + kTcStages - 1) % kTcStages);
    }
    __syncthreads();  // every warp done with its rings: reuse them for the sums
  } else {
    // N % 16 != 0 or K % 8 != 0 (no serving shape): each thread reads its
    // pieces straight from global memory, 4 bytes and one bf16 at a time.
    const int col = n0 + 16 * g;
    for (int i = 0; i < mine; ++i) {
      const int s = warp + kTcWarps * i;
#pragma unroll
      for (int h = 0; h < kTcStageK / 16; ++h) {
        const int k = kz0 + s * kTcStageK + 16 * h + 4 * t;
        uint4 raw[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          uint32_t* r32 = &raw[rr].x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            r32[e] = k + rr < kz1 && col + 4 * e < N
                         ? __ldg(reinterpret_cast<const unsigned int*>(
                               w + (size_t)(k + rr) * N + col + 4 * e))
                         : 0u;
        }
        uint32_t bf[G][2];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int m = m0 + 8 * q + g;
          uint32_t e[4] = {0u, 0u, 0u, 0u};
          if (m < M) {
            const unsigned short* xp =
                reinterpret_cast<const unsigned short*>(x + (size_t)m * K + k);
#pragma unroll
            for (int u = 0; u < 4; ++u) e[u] = k + u < kz1 ? xp[u] : 0u;
          }
          bf[q][0] = e[0] | (e[1] << 16);
          bf[q][1] = e[2] | (e[3] << 16);
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
      part[((size_t)blockIdx.z * M + m0 + tok) * N + n] = a;
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

// cuTensorMapEncodeTiled, reached through the runtime's entry-point
// lookup (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major [rows, cols] matrix of `elem`-byte elements as a TMA tensor
// map with boxes of box_cols x box_rows. Returns false if it cannot.
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                uint64_t rows, uint64_t cols, uint32_t box_cols, uint32_t box_rows,
                CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int G, bool TMA>
int launch_tc(const __nv_bfloat16* x, int M, int K, const int8_t* w8, const float* xs,
              const float* ws, int N, int k_chunk, int nsplit, float* part, int* counters,
              void* out, int out_bf16, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(G, TMA);
  const dim3 grid((M + 8 * G - 1) / (8 * G), (N + kTcCols - 1) / kTcCols, nsplit);
  const int slot = ((G == 1 ? 0 : G == 2 ? 1 : 2) * 2 + (TMA ? 1 : 0)) * 2 + (out_bf16 ? 1 : 0);
  CUtensorMap wmap{}, xmap{};
  if (TMA && !(tensor_map(&wmap, w8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kTcCols,
                          kTcStageK, CU_TENSOR_MAP_SWIZZLE_128B) &&
               tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kTcStageK,
                          8 * G, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (out_bf16) {
    auto kern = wo_tc_gemm_kernel<G, TMA, __nv_bfloat16>;
    err = rtq::ensure_dynamic_smem(kern, g_tc_smem_set[slot], smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kTcThreads, smem, st>>>(wmap, xmap, x, M, K, w8, N, k_chunk, nsplit, xs, ws,
                                         part, counters, static_cast<__nv_bfloat16*>(out));
  } else {
    auto kern = wo_tc_gemm_kernel<G, TMA, float>;
    err = rtq::ensure_dynamic_smem(kern, g_tc_smem_set[slot], smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kTcThreads, smem, st>>>(wmap, xmap, x, M, K, w8, N, k_chunk, nsplit, xs, ws,
                                         part, counters, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_tc_g(const __nv_bfloat16* x, int M, int K, const int8_t* w8, const float* xs,
                const float* ws, int N, int k_chunk, int nsplit, float* part, int* counters,
                void* out, int out_bf16, cudaStream_t st) {
  if (N % 16 == 0 && K % 8 == 0)
    return launch_tc<G, true>(x, M, K, w8, xs, ws, N, k_chunk, nsplit, part, counters, out,
                              out_bf16, st);
  return launch_tc<G, false>(x, M, K, w8, xs, ws, N, k_chunk, nsplit, part, counters, out,
                             out_bf16, st);
}

}  // namespace

// Weight-only, bf16 x, on the tensor cores. xs [M] f32 or null (= 1), ws
// [N] f32; k_chunk % 32 == 0 with k_chunk * nsplit >= K; part [nsplit, M,
// N] f32 scratch (unused when nsplit == 1); counters: one int per (token
// tile, column tile) of the launch, zero at rest (the kernel leaves them
// zero). Tokens a block: 8 for M <= 8, 16 for M <= 16, else 32 (the bits do
// not depend on it). Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_tc_launch(
    const void* x, int M, int K, const int8_t* w8, const float* xs, const float* ws, int N,
    int k_chunk, int nsplit, float* part, int* counters, void* out, int out_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (M <= 8)
    return launch_tc_g<1>(xb, M, K, w8, xs, ws, N, k_chunk, nsplit, part, counters, out,
                          out_bf16, st);
  if (M <= 16)
    return launch_tc_g<2>(xb, M, K, w8, xs, ws, N, k_chunk, nsplit, part, counters, out,
                          out_bf16, st);
  return launch_tc_g<4>(xb, M, K, w8, xs, ws, N, k_chunk, nsplit, part, counters, out,
                        out_bf16, st);
}

// Weight-only on the CUDA cores (qmatmul_common.cuh's wo_gemm_kernel, B4's
// kernel with S = 0): the f32-x path (bf16 x takes the tensor cores).
// x_bf16 must be 0 (the argument keeps B4's calling convention). xs [M]
// f32 or null (= 1), ws [N] f32; part [nsplit, M, N] f32 scratch with
// k_chunk * nsplit >= K. Returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for bf16 x.
extern "C" int quant_matmul_wo_launch(
    const void* x, int x_bf16, int M, int K, const int8_t* w8, const float* xs,
    const float* ws, int N, int k_chunk, int nsplit, float* part, void* out,
    int out_bf16, void* stream) {
  if (x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return rtq::wo_matmul_path<float>(static_cast<const float*>(x), M, K, 0, nullptr, nullptr,
                                    w8, xs, ws, N, k_chunk, nsplit, part, out, out_bf16,
                                    static_cast<cudaStream_t>(stream));
}

// int8. q: [M, Kp] int8 scratch (Kp = K rounded up to 16), or null when
// K % 16 == 0 (x is read in place, Kp = K); acc [M, N] int32 scratch; xs
// [M] or null (= 1). Returns cudaGetLastError() (0 = ok).
extern "C" int quant_matmul_int8_launch(
    const int8_t* x, int M, int K, const int8_t* w8, const float* xs, const float* ws,
    int N, int8_t* q, int Kp, int* acc, void* out, int out_bf16, void* stream) {
  return rtq::int8_matmul_path(x, M, K, 0, nullptr, nullptr, w8, xs, ws, N, q, Kp, acc,
                               out, out_bf16, static_cast<cudaStream_t>(stream));
}
