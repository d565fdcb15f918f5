// Fused append + paged flash-decode attention over the KV page pool, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::_paged_attn_kernel (the Pallas
// TPU kernel behind paged_attention_kernel / paged_attention) for float32
// and int8 pools: each program (lane b, KV head g) writes the lane's new
// K/V rows into table[b, lin // ps], slot lin % ps (lin clamped to
// [0, T*ps-1]; int8 rows quantized with quant_rows' reciprocal form at
// qmax 127, one f32 scale per row), then runs online-softmax attention for
// its Q*rep query rows over the first min(T, (pos+Q-1)//ps + 1) pages of
// its block-table row.
//
// What bounds it on this card: the bytes of the pages the lanes attend
// (KV rows at int8 or f32, plus scales); the flops are few.
//
// Design. One block per (b, g), 256 threads, all tiles in shared memory:
// the pre-scaled query rows [QR, hd], one dequantized K page [ps, hd+1]
// (padded row: the score loop reads K across rows without bank conflicts),
// one V page [ps, hd], the scores [QR, ps] and the f32 accumulator
// [QR, hd]. The block appends its own rows first and __syncthreads() makes
// them visible to its page loads (pages past the prompt are never shared
// between lanes, so no other block writes what this block reads). Trash
// page 0 is never read: its tile is select-zeroed, so a poisoned (NaN)
// trash page cannot reach an output, and a fully masked row (an inactive
// lane whose table is all trash) comes out as exact zeros. The pool is
// updated in place. With 16 blocks for 8 lanes x 2 KV heads the card is
// mostly idle at decode batch 8: splitting the page walk over more blocks
// is later work.
//
// Numerics: the append is bitwise quant_rows (scale = max(amax, 1e-30) *
// float32(1/qmax); q = clamp(floor(x * (1/scale) + 0.5)) with the multiply
// and add kept apart by the _rn intrinsics); attention is f32 after
// dequant with expf, so outputs match the plain version to float
// tolerance (summation order, exp implementation).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1

__device__ __forceinline__ float load_in(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Block-wide max of one value per thread (all threads get the result).
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Write one token's row (hd values of head g) into the pool slot.
template <bool INT8>
__device__ void append_row(const __nv_bfloat16* __restrict__ src, void* pool, float* pool_scale,
                           size_t row_off, size_t scale_off, int hd, float qmax,
                           float inv_qmax, float* red) {
  if (INT8) {
    float amax = 0.f;
    for (int d = threadIdx.x; d < hd; d += kThreads) amax = fmaxf(amax, fabsf(load_in(src, d)));
    amax = block_max(amax, red);
    const float sc = __fmul_rn(fmaxf(amax, 1e-30f), inv_qmax);
    const float rcp = __fdiv_rn(1.0f, sc);
    int8_t* dst = static_cast<int8_t*>(pool) + row_off;
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      float q = floorf(__fadd_rn(__fmul_rn(load_in(src, d), rcp), 0.5f));
      q = fminf(fmaxf(q, -qmax), qmax);
      dst[d] = static_cast<int8_t>(static_cast<int>(q));
    }
    if (threadIdx.x == 0) pool_scale[scale_off] = sc;
  } else {
    float* dst = static_cast<float*>(pool) + row_off;
    for (int d = threadIdx.x; d < hd; d += kThreads) dst[d] = load_in(src, d);
  }
}

template <bool INT8>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, Q, H, hd]
    const __nv_bfloat16* __restrict__ k_new,  // [B, Q, KV, hd]
    const __nv_bfloat16* __restrict__ v_new,
    void* k_pool, void* v_pool,    // [P, KV, ps, hd] f32 or int8
    float* k_scale, float* v_scale,  // [P, KV, ps] (int8 pools)
    const int* __restrict__ table,   // [B, T]
    const int* __restrict__ pos,     // [B]
    float* __restrict__ out,         // [B, Q, H, hd]
    int Q, int H, int KV, int hd, int ps, int T, float q_scale, float qmax,
    float inv_qmax) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / KV;
  const int QR = Q * rep;
  const int kstride = hd + 1;
  float* q_s = smem;                    // [QR, hd]
  float* k_s = q_s + QR * hd;           // [ps, hd+1]
  float* v_s = k_s + ps * kstride;      // [ps, hd]
  float* s_s = v_s + ps * hd;           // [QR, ps]
  float* acc = s_s + QR * ps;           // [QR, hd]
  float* m_s = acc + QR * hd;           // [QR]
  float* l_s = m_s + QR;                // [QR]
  float* a_s = l_s + QR;                // [QR]
  const int pos_b = pos[b];

  // ---- fused append of this (lane, head)'s Q rows.
  for (int j = 0; j < Q; ++j) {
    int lin = pos_b + j;
    lin = lin < 0 ? 0 : (lin > T * ps - 1 ? T * ps - 1 : lin);
    const int pid = table[(size_t)b * T + lin / ps];
    const int slot = lin % ps;
    const size_t src_off = (((size_t)b * Q + j) * KV + g) * hd;
    const size_t scale_off = ((size_t)pid * KV + g) * ps + slot;
    const size_t row_off = scale_off * hd;
    append_row<INT8>(k_new + src_off, k_pool, k_scale, row_off, scale_off, hd,
                         qmax, inv_qmax, red);
    append_row<INT8>(v_new + src_off, v_pool, v_scale, row_off, scale_off, hd,
                         qmax, inv_qmax, red);
  }

  // ---- query rows (row r = query r / rep, head g*rep + r % rep), scaled.
  for (int i = threadIdx.x; i < QR * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int j = r / rep, h = g * rep + r % rep;
    q_s[i] = __fmul_rn(load_in(q, (((size_t)b * Q + j) * H + h) * hd + d), q_scale);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < QR; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();  // appended rows and q visible to the whole block

  int n_active = (pos_b + Q - 1) / ps + 1;
  if (n_active > T) n_active = T;
  for (int ti = 0; ti < n_active; ++ti) {
    const int pid = table[(size_t)b * T + ti];
    const bool readable = pid != 0;
    const size_t page = ((size_t)pid * KV + g) * ps;
    for (int i = threadIdx.x; i < ps * hd; i += kThreads) {
      const int s = i / hd, d = i % hd;
      float kf = 0.f, vf = 0.f;
      if (readable) {
        if (INT8) {
          const int8_t* kp = static_cast<const int8_t*>(k_pool);
          const int8_t* vp = static_cast<const int8_t*>(v_pool);
          kf = __fmul_rn(static_cast<float>(kp[page * hd + i]), k_scale[page + s]);
          vf = __fmul_rn(static_cast<float>(vp[page * hd + i]), v_scale[page + s]);
        } else {
          kf = static_cast<const float*>(k_pool)[page * hd + i];
          vf = static_cast<const float*>(v_pool)[page * hd + i];
        }
      }
      k_s[s * kstride + d] = kf;
      v_s[i] = vf;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < QR * ps; i += kThreads) {
      const int r = i / ps, s = i % ps;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q_s[r * hd + d], k_s[s * kstride + d], dot);
      const int gpos = ti * ps + s;
      const bool vis = readable && gpos <= pos_b + r / rep;
      s_s[i] = dot + (vis ? 0.f : kNegInf);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < QR; r += kThreads) {
      float mx = kNegInf;
      for (int s = 0; s < ps; ++s) mx = fmaxf(mx, s_s[r * ps + s]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int s = 0; s < ps; ++s) {
        const float p = expf(s_s[r * ps + s] - m_new);
        s_s[r * ps + s] = p;
        psum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[r] = l_s[r] * alpha + psum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < QR * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float pv = 0.f;
      for (int s = 0; s < ps; ++s) pv = fmaf(s_s[r * ps + s], v_s[s * hd + d], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < QR * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int j = r / rep, h = g * rep + r % rep;
    out[(((size_t)b * Q + j) * H + h) * hd + d] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

template <bool INT8>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale, const int* table,
           const int* pos, float* out, int B, int Q, int H, int KV, int hd, int ps,
           int T, float q_scale, float qmax, float inv_qmax, cudaStream_t st) {
  const int QR = Q * (H / KV);
  const size_t smem =
      sizeof(float) * ((size_t)QR * hd + (size_t)ps * (hd + 1) + (size_t)ps * hd +
                       (size_t)QR * ps + (size_t)QR * hd + 3 * (size_t)QR);
  auto kern = paged_attention_kernel<INT8>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, KV);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), k_pool, v_pool, k_scale, v_scale, table, pos, out,
      Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k_new/v_new are bfloat16 (the model's activations); pool_int8: int8
// pool with f32 row scales (1) or float32 pool (0, scales unused).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    float* k_scale, float* v_scale, int pool_int8, const int* table, const int* pos,
    float* out, int B, int Q, int H, int KV, int hd, int ps, int T, float q_scale,
    float qmax, float inv_qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_int8)
    return launch<true>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                        out, B, Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax, st);
  return launch<false>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                       out, B, Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax, st);
}
