// Fused append + paged flash-decode attention over the KV page pool, for
// Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::_paged_attn_kernel (the Pallas
// TPU kernel behind paged_attention_kernel / paged_attention) for float32,
// int8 and packed int4 pools and any number Q of query tokens per lane (Q =
// 1 at decode, Q = k + 1 in a speculative verify): the lane's Q new K/V
// rows go into table[b, lin // ps], slot lin % ps (lin clamped to
// [0, T*ps-1]; int8 rows quantized with quant_rows' reciprocal form at qmax
// 127, int4 rows at qmax 7 and packed split-half, two channels a byte, one
// f32 scale per row), then query j of the lane attends online-softmax over
// positions <= pos + j of its block-table row.
//
// What bounds it on this card: the bytes of the pages the lanes attend
// (KV rows at int4, int8 or f32, plus scales); the flops are few.
//
// Design. Two launches on one stream: the append (one block per lane, KV
// head and token), then the attention, which reads the appended rows (every
// tile reads rows that other tiles' tokens write, so the append cannot live
// inside the attention blocks once a call has several tiles; one path for
// every Q keeps Q = 1 and Q > 1 alike). The Q*rep query rows of a (lane b,
// KV head g) pair (row r is query r / rep, head g*rep + r % rep) are cut
// into tiles of R rows, R a multiple of rep that the wrapper sizes so a
// tile's q, scores and accumulator fit shared memory (one query token a
// tile at glm4-9b's rep 16). One block of 256 threads per (b, g, tile) -- a
// third grid dimension over row tiles rather than a loop inside the block,
// so a verify of Q tokens has Q times the 16 blocks a decode step has --
// holds in shared memory the tile's pre-scaled query rows [R, hd], one
// dequantized K page [ps, hd+1] (padded row: the score loop reads K across
// rows without bank conflicts), one V page [ps, hd], the scores [R, ps] and
// the f32 accumulator [R, hd], and walks the pages up to its last row's
// position. Trash page 0 is never read: its
// tile is select-zeroed, so a poisoned (NaN) trash page cannot reach an
// output, and a fully masked row (an inactive lane whose table is all
// trash) comes out as exact zeros (int4 pools also zero a row whose running
// max never left NEG_INF, as the reference's _int4_finish does). int4 page
// bytes are unpacked in registers: byte d of a row holds channel d in its
// low nibble and channel d + hd/2 in its high nibble, sign-extended by
// int32 arithmetic shifts, then times the row's scale. The pool is updated
// in place.
//
// A row's result does not depend on Q or on its tile: its arithmetic (the
// dot products, the page-by-page max, sum and accumulator updates, each in
// one thread in a fixed order) is that of the Q = 1 call at its position,
// and a page past the row's own position is fully masked, so that exp(NEG_INF
// - m) = 0 and alpha = 1 leave its max, sum and accumulator bitwise
// unchanged. A verify of Q tokens thus gives each token's row bitwise the
// output of Q sequential decode calls.
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

// Append token j's K and V rows of (lane b, KV head g) into the pool.
template <int KIND>
__device__ void append_token(const __nv_bfloat16* __restrict__ k_new,
                             const __nv_bfloat16* __restrict__ v_new, void* k_pool,
                             void* v_pool, float* k_scale, float* v_scale,
                             const int* __restrict__ table, int pos_b, int b, int g, int j,
                             int Q, int KV, int hd, int ps, int T, float qmax, float inv_qmax,
                             float* red) {
  const int hdp = KIND == kInt4 ? hd / 2 : hd;  // pool elements per row
  int lin = pos_b + j;
  lin = lin < 0 ? 0 : (lin > T * ps - 1 ? T * ps - 1 : lin);
  const int pid = table[(size_t)b * T + lin / ps];
  const int slot = lin % ps;
  const size_t src_off = (((size_t)b * Q + j) * KV + g) * hd;
  const size_t scale_off = ((size_t)pid * KV + g) * ps + slot;
  const size_t row_off = scale_off * hdp;
  append_row<KIND>(k_new + src_off, k_pool, k_scale, row_off, scale_off, hd, qmax,
                   inv_qmax, red);
  append_row<KIND>(v_new + src_off, v_pool, v_scale, row_off, scale_off, hd, qmax,
                   inv_qmax, red);
}

// The append: one block per (lane, KV head, token).
template <int KIND>
__global__ void __launch_bounds__(kThreads) append_kernel(
    const __nv_bfloat16* __restrict__ k_new, const __nv_bfloat16* __restrict__ v_new,
    void* k_pool, void* v_pool, float* k_scale, float* v_scale,
    const int* __restrict__ table, const int* __restrict__ pos, int Q, int KV, int hd,
    int ps, int T, float qmax, float inv_qmax) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  append_token<KIND>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos[b], b,
                     blockIdx.y, blockIdx.z, Q, KV, hd, ps, T, qmax, inv_qmax, red);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Q, H, hd]
    const void* k_pool, const void* v_pool,  // [P, KV, ps, hd] f32 or int8; [P, KV, ps, hd/2] int4
    const float* k_scale, const float* v_scale,  // [P, KV, ps] (int8 and int4 pools)
    const int* __restrict__ table,   // [B, T]
    const int* __restrict__ pos,     // [B]
    float* __restrict__ out,         // [B, Q, H, hd]
    int Q, int H, int KV, int hd, int ps, int T, int R, float q_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / KV;
  const int r0 = blockIdx.z * R;             // this tile's first row
  const int nr = min(R, Q * rep - r0);       // its rows
  const int kstride = hd + 1;
  const int hdp = KIND == kInt4 ? hd / 2 : hd;  // pool elements per row
  float* q_s = smem;                    // [R, hd]
  float* k_s = q_s + R * hd;            // [ps, hd+1]
  float* v_s = k_s + ps * kstride;      // [ps, hd]
  float* s_s = v_s + ps * hd;           // [R, ps]
  float* acc = s_s + R * ps;            // [R, hd]
  float* m_s = acc + R * hd;            // [R]
  float* l_s = m_s + R;                 // [R]
  float* a_s = l_s + R;                 // [R]
  const int pos_b = pos[b];

  // ---- the tile's query rows (row r0 + i = query (r0 + i) / rep), scaled.
  for (int i = threadIdx.x; i < nr * hd; i += kThreads) {
    const int r = r0 + i / hd, d = i % hd;
    const int j = r / rep, h = g * rep + r % rep;
    q_s[i] = __fmul_rn(load_f32(q, (((size_t)b * Q + j) * H + h) * hd + d), q_scale);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();  // q visible to the whole block

  // Pages up to the tile's last query position.
  int n_active = (pos_b + (r0 + nr - 1) / rep) / ps + 1;
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
    for (int i = threadIdx.x; i < nr * ps; i += kThreads) {
      const int rl = i / ps, s = i % ps;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q_s[rl * hd + d], k_s[s * kstride + d], dot);
      const int gpos = ti * ps + s;
      const bool vis = readable && gpos <= pos_b + (r0 + rl) / rep;
      s_s[i] = dot + (vis ? 0.f : kNegInf);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += kThreads) {
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
    for (int i = threadIdx.x; i < nr * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float pv = 0.f;
      for (int s = 0; s < ps; ++s) pv = fmaf(s_s[r * ps + s], v_s[s * hd + d], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nr * hd; i += kThreads) {
    const int rl = i / hd, d = i % hd;
    const int r = r0 + rl;
    const int j = r / rep, h = g * rep + r % rep;
    float o = acc[i] / fmaxf(l_s[rl], 1e-30f);
    if (KIND == kInt4 && !(m_s[rl] > 0.5f * kNegInf)) o = 0.f;
    out[(((size_t)b * Q + j) * H + h) * hd + d] = o;
  }
}

template <int KIND>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale, const int* table,
           const int* pos, float* out, int B, int Q, int H, int KV, int hd, int ps,
           int T, int R, float q_scale, float qmax, float inv_qmax, cudaStream_t st) {
  const int QR = Q * (H / KV);
  const int tiles = (QR + R - 1) / R;
  const __nv_bfloat16* kn = static_cast<const __nv_bfloat16*>(k_new);
  const __nv_bfloat16* vn = static_cast<const __nv_bfloat16*>(v_new);
  append_kernel<KIND><<<dim3(B, KV, Q), kThreads, 0, st>>>(
      kn, vn, k_pool, v_pool, k_scale, v_scale, table, pos, Q, KV, hd, ps, T, qmax,
      inv_qmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      sizeof(float) * ((size_t)R * hd + (size_t)ps * (hd + 1) + (size_t)ps * hd +
                       (size_t)R * ps + (size_t)R * hd + 3 * (size_t)R);
  auto kern = paged_attention_kernel<KIND>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(B, KV, tiles), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, k_scale, v_scale, table, pos, out,
      Q, H, KV, hd, ps, T, R, q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k_new/v_new are bfloat16 (the model's activations); kind: 0 = float32
// pool (scales unused), 1 = int8 pool, 2 = packed int4 pool (uint8, hd/2
// bytes a row), both with f32 row scales; R: query rows per tile, a
// multiple of H / KV. Returns cudaGetLastError() (0 = ok;
// cudaErrorInvalidValue for an unknown kind).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    float* k_scale, float* v_scale, int kind, const int* table, const int* pos,
    float* out, int B, int Q, int H, int KV, int hd, int ps, int T, int R, float q_scale,
    float qmax, float inv_qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kFloat:
      return launch<kFloat>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                            out, B, Q, H, KV, hd, ps, T, R, q_scale, qmax, inv_qmax, st);
    case kInt8:
      return launch<kInt8>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, B, Q, H, KV, hd, ps, T, R, q_scale, qmax, inv_qmax, st);
    case kInt4:
      return launch<kInt4>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, B, Q, H, KV, hd, ps, T, R, q_scale, qmax, inv_qmax, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
