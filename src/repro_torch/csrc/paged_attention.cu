// Fused append + paged flash-decode attention over the KV page pool, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::_paged_attn_kernel (the Pallas
// TPU kernel behind paged_attention_kernel / paged_attention) for float32,
// int8 and packed int4 pools: each program (lane b, KV head g) writes the
// lane's new K/V rows into table[b, lin // ps], slot lin % ps (lin clamped
// to [0, T*ps-1]; int8 rows quantized with quant_rows' reciprocal form at
// qmax 127, int4 rows at qmax 7 and packed split-half, two channels a
// byte, one f32 scale per row), then runs online-softmax attention for its
// Q*rep query rows over the first min(T, (pos+Q-1)//ps + 1) pages of its
// block-table row.
//
// What bounds it on this card: the bytes of the pages the lanes attend
// (KV rows at int4, int8 or f32, plus scales); the flops are few.
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
// lane whose table is all trash) comes out as exact zeros (int4 pools
// also zero a row whose running max never left NEG_INF, as the
// reference's _int4_finish does). int4 page bytes are unpacked in
// registers: byte d of a row holds channel d in its low nibble and
// channel d + hd/2 in its high nibble, sign-extended by int32 arithmetic
// shifts, then times the row's scale. The pool is
// updated in place. With 16 blocks for 8 lanes x 2 KV heads the card is
// mostly idle at decode batch 8: splitting the page walk over more blocks
// is later work.
//
// Numerics: the append is bitwise quant_rows (scale = max(amax, 1e-30) *
// float32(1/qmax); q = clamp(floor(x * (1/scale) + 0.5)) with the multiply
// and add kept apart by the _rn intrinsics); attention is f32 after
// dequant with expf, so outputs match the plain version to float
// tolerance (summation order, exp implementation).

#include "qmatmul_common.cuh"

namespace {

using rtq::load_f32;
using rtq::quant_rcp;
using rtq::row_absmax_scale;

constexpr int kThreads = rtq::kQuantThreads;  // row_absmax_scale's block size
constexpr float kNegInf = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1

// Pool kinds (the wrapper's _KIND_CODE).
constexpr int kFloat = 0;
constexpr int kInt8 = 1;
constexpr int kInt4 = 2;

// Nibble `hi` of a packed int4 byte, sign-extended.
__device__ __forceinline__ float nibble_f32(uint8_t byte, bool hi) {
  const uint32_t v = byte;
  return static_cast<float>(static_cast<int>(v << (hi ? 24 : 28)) >> 28);
}

// Write one token's row (hd values of head g) into the pool slot
// (row_off counts the pool's elements: bytes for int8 and int4 pools).
template <int KIND>
__device__ void append_row(const __nv_bfloat16* __restrict__ src, void* pool, float* pool_scale,
                           size_t row_off, size_t scale_off, int hd, float qmax,
                           float inv_qmax, float* red) {
  if (KIND != kFloat) {
    // The whole row's abs-max first: every value uses the row's one scale.
    const float sc = row_absmax_scale(src, hd, inv_qmax, red);
    const float rcp = __fdiv_rn(1.0f, sc);
    if (KIND == kInt8) {
      int8_t* dst = static_cast<int8_t*>(pool) + row_off;
      for (int d = threadIdx.x; d < hd; d += kThreads)
        dst[d] = quant_rcp(load_f32(src, d), rcp, qmax);
    } else {
      const int half = hd / 2;
      uint8_t* dst = static_cast<uint8_t*>(pool) + row_off;
      for (int d = threadIdx.x; d < half; d += kThreads) {
        const int lo = quant_rcp(load_f32(src, d), rcp, qmax);
        const int hi = quant_rcp(load_f32(src, d + half), rcp, qmax);
        dst[d] = static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
      }
    }
    if (threadIdx.x == 0) pool_scale[scale_off] = sc;
  } else {
    float* dst = static_cast<float*>(pool) + row_off;
    for (int d = threadIdx.x; d < hd; d += kThreads) dst[d] = load_f32(src, d);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // [B, Q, H, hd]
    const __nv_bfloat16* __restrict__ k_new,  // [B, Q, KV, hd]
    const __nv_bfloat16* __restrict__ v_new,
    void* k_pool, void* v_pool,    // [P, KV, ps, hd] f32 or int8; [P, KV, ps, hd/2] int4
    float* k_scale, float* v_scale,  // [P, KV, ps] (int8 and int4 pools)
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
  const int hdp = KIND == kInt4 ? hd / 2 : hd;  // pool elements per row
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
    const size_t row_off = scale_off * hdp;
    append_row<KIND>(k_new + src_off, k_pool, k_scale, row_off, scale_off, hd,
                     qmax, inv_qmax, red);
    append_row<KIND>(v_new + src_off, v_pool, v_scale, row_off, scale_off, hd,
                     qmax, inv_qmax, red);
  }

  // ---- query rows (row r = query r / rep, head g*rep + r % rep), scaled.
  for (int i = threadIdx.x; i < QR * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int j = r / rep, h = g * rep + r % rep;
    q_s[i] = __fmul_rn(load_f32(q, (((size_t)b * Q + j) * H + h) * hd + d), q_scale);
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
        if (KIND == kInt8) {
          const int8_t* kp = static_cast<const int8_t*>(k_pool);
          const int8_t* vp = static_cast<const int8_t*>(v_pool);
          kf = __fmul_rn(static_cast<float>(kp[page * hd + i]), k_scale[page + s]);
          vf = __fmul_rn(static_cast<float>(vp[page * hd + i]), v_scale[page + s]);
        } else if (KIND == kInt4) {
          const uint8_t* kp = static_cast<const uint8_t*>(k_pool);
          const uint8_t* vp = static_cast<const uint8_t*>(v_pool);
          const bool hi = d >= hdp;
          const size_t byte = (page + s) * hdp + (hi ? d - hdp : d);
          kf = __fmul_rn(nibble_f32(kp[byte], hi), k_scale[page + s]);
          vf = __fmul_rn(nibble_f32(vp[byte], hi), v_scale[page + s]);
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
    float o = acc[i] / fmaxf(l_s[r], 1e-30f);
    if (KIND == kInt4 && !(m_s[r] > 0.5f * kNegInf)) o = 0.f;
    out[(((size_t)b * Q + j) * H + h) * hd + d] = o;
  }
}

template <int KIND>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale, const int* table,
           const int* pos, float* out, int B, int Q, int H, int KV, int hd, int ps,
           int T, float q_scale, float qmax, float inv_qmax, cudaStream_t st) {
  const int QR = Q * (H / KV);
  const size_t smem =
      sizeof(float) * ((size_t)QR * hd + (size_t)ps * (hd + 1) + (size_t)ps * hd +
                       (size_t)QR * ps + (size_t)QR * hd + 3 * (size_t)QR);
  auto kern = paged_attention_kernel<KIND>;
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

// q/k_new/v_new are bfloat16 (the model's activations); kind: 0 = float32
// pool (scales unused), 1 = int8 pool, 2 = packed int4 pool (uint8, hd/2
// bytes a row), both with f32 row scales. Returns cudaGetLastError() (0 = ok;
// cudaErrorInvalidValue for an unknown kind).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    float* k_scale, float* v_scale, int kind, const int* table, const int* pos,
    float* out, int B, int Q, int H, int KV, int hd, int ps, int T, float q_scale,
    float qmax, float inv_qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kFloat:
      return launch<kFloat>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                            out, B, Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax, st);
    case kInt8:
      return launch<kInt8>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, B, Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax, st);
    case kInt4:
      return launch<kInt4>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, B, Q, H, KV, hd, ps, T, q_scale, qmax, inv_qmax, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
