// Append + split-KV ("flash-decoding") paged attention over the KV page
// pool, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::_paged_attn_kernel (the Pallas
// TPU kernel behind paged_attention_kernel / paged_attention) for float32,
// int8 and packed int4 pools and any number Q of query tokens per lane (Q =
// 1 at decode, Q = k + 1 in a speculative verify): the lane's Q new K/V
// rows go into table[b, lin // ps], slot lin % ps (lin clamped to
// [0, T*ps-1]; int8 rows quantized with quant_rows' reciprocal form at qmax
// 127, int4 rows at qmax 7 and packed split-half, two channels a byte, one
// f32 scale per row), then query j of the lane attends over positions <=
// pos + j of its block-table row.
//
// What bounds it on this card: at decode neither bytes (0.7-2.8 MB of pages
// a call, < 1 us at 3.35 TB/s) nor flops (~20 MFLOP) -- latency: how many
// SMs a call keeps busy and how long the longest lane's walk is. So the
// design spreads each lane's page walk over many blocks and keeps every
// block short. Products stay f32 on the CUDA cores: the outputs are held to
// 2e-5 against the f32 plain version, which bf16 or TF32 tensor-core
// products would not meet, and the flops are not what bounds a call.
//
// Design: three launches on one stream.
//   1. append_kernel: one block per (lane, KV head, token) writes the new
//      K/V rows into their pages (its own launch: every attention block
//      reads rows that other tokens append).
//   2. chunk_attention_kernel: the block table is cut into chunks of C pages
//      (the wrapper's constant, from ps and hd alone); one block of 256
//      threads per (chunk, KV head, lane x row tile). The grid's chunk count
//      comes from the table width T, never from pos (a device tensor). The
//      Q*rep query rows of a (lane b, KV head g) pair (row r is query r /
//      rep, head g*rep + r % rep) are cut into tiles of R rows. A block
//      whose chunk lies wholly past its tile's last position writes the
//      empty partial (m = NEG_INF, l = 0) and exits. Otherwise it issues
//      cp.async copies of every page of its chunk at once, one commit
//      group per page (K/V page rows of f32 straight into the padded f32
//      tiles; int8 and int4 rows and their scales into a byte staging
//      area), 16 bytes a piece, narrower only where a page of 1 or 2 rows
//      leaves its scales (and an int4 page of one row with hd % 32 == 16
//      its row) off 16-byte alignment: 4-byte scale pieces, 8-byte row
//      pieces. So later pages are in flight while earlier ones are worked
//      on; page by page it waits for the page's group, dequantizes it in
//      registers (int8: 4 bytes a word; int4: 4 bytes = 8 channels, low
//      nibble channel d, high nibble d + hd/2, sign-extended by int32
//      arithmetic shifts, times the row's scale) and computes its scores,
//      a thread one position for 4 rows (lanes on neighbouring positions,
//      each row's q a broadcast read). Then one warp per query row runs the
//      chunk's softmax (max and sum by warp shuffles), and each thread
//      accumulates 4 rows x 4 channels of P.V. The block
//      writes each row's partial (m, l, acc[hd]) to an f32 workspace.
//      Trash page 0 (and a page past the tile's last position) is never
//      read: its tile is select-zeroed and its positions masked, so a
//      poisoned (NaN) trash page cannot reach an output.
//   3. merge_kernel: one warp per output row combines the row's chunks in
//      ascending chunk order: M = max of the chunk maxima, then l and acc
//      rescaled by expf(m_c - M) and summed; out = acc / max(l, 1e-30). A
//      chunk in which the row saw no position (m_c at NEG_INF: an empty
//      partial, or a chunk its tile needed and it did not) is skipped, so
//      its acc is never read; a row that saw nothing at all (a retired
//      lane's all-trash table) comes out as exact zeros, in every pool kind
//      (int4 pools thus zero a row whose max never left NEG_INF, as the
//      reference's _int4_finish does).
//
// A row's result does not depend on Q, on its tile, or on how many of a
// chunk's pages its tile loaded: its arithmetic in a chunk (the dot
// products, the chunk's max, exp, sum and P.V, each in a fixed order) is the
// same for every row, positions past the row's own are masked (exp(NEG_INF
// - m) = 0, and adding 0 leaves its sums bitwise unchanged), and the merge
// reads only chunks the row saw. A verify of Q tokens thus gives each
// token's row bitwise the output of Q sequential decode calls.
//
// Numerics: the append is bitwise quant_rows (scale = max(amax, 1e-30) *
// float32(1/qmax); q = clamp(floor(x * (1/scale) + 0.5)) with the multiply
// and add kept apart by the _rn intrinsics); attention is f32 after
// dequant with expf, so outputs match the plain version to float
// tolerance (summation order, exp implementation).

#include "qmatmul_common.cuh"

namespace {

using rtq::cp_async16;
using rtq::cp_async_narrow;
using rtq::cp_async_commit;
using rtq::cp_async_wait_dyn;
using rtq::load_f32;
using rtq::quant_rcp;
using rtq::row_absmax_scale;

constexpr int kThreads = rtq::kQuantThreads;  // row_absmax_scale's block size
constexpr int kMergeThreads = 128;            // 4 warps: 4 output rows a block
constexpr float kNegInf = -1e30f;  // finite: exp(NEG_INF - NEG_INF) == 1

// Pool kinds (the wrapper's _KIND_CODE).
constexpr int kFloat = 0;
constexpr int kInt8 = 1;
constexpr int kInt4 = 2;

// cudaFuncSetAttribute bookkeeping: the largest dynamic shared memory set so
// far for each attention kernel (pool kind x short pages), per device.
std::atomic<int> g_smem_set[6][rtq::kMaxDevices];

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

// Shared memory of a chunk block, in bytes from the start (every region
// 16-byte aligned): q rows [rp, hd] f32 (rp = R rounded up to 4), K [npos,
// kst] f32 (kst = hd padded so a quarter-warp's 16-byte reads of 8
// neighbouring positions hit 8 distinct bank groups), V [npos, hd] f32,
// scores [rp, npos] f32, then for int8 / int4 pools the raw K and V bytes
// and their scales, then C page ids. The wrapper's _smem_bytes mirrors it.
struct ChunkLayout {
  int rp, npos, kst, off_k, off_v, off_p, off_rk, off_rv, off_sk, off_sv, off_pid, bytes;
};

__host__ __device__ inline ChunkLayout chunk_layout(int kind, int R, int C, int ps, int hd) {
  ChunkLayout L;
  L.rp = (R + 3) / 4 * 4;
  L.npos = C * ps;
  L.kst = hd + 4 * ((9 - (hd / 4) % 8) % 8);
  const int hdp = kind == kInt4 ? hd / 2 : hd;
  const int raw = kind == kFloat ? 0 : L.npos * hdp;
  const int sc = kind == kFloat ? 0 : L.npos * 4;
  int off = L.rp * hd * 4;
  L.off_k = off;
  off += L.npos * L.kst * 4;
  L.off_v = off;
  off += L.npos * hd * 4;
  L.off_p = off;
  off += L.rp * L.npos * 4;
  L.off_rk = off;
  off += raw;
  L.off_rv = off;
  off += raw;
  L.off_sk = off;
  off += sc;
  L.off_sv = off;
  off += sc;
  L.off_pid = off;
  off += (C * 4 + 15) / 16 * 16;
  L.bytes = off;
  return L;
}

// Dequantize page li of the chunk (int8 or int4) from the staging area into
// the f32 K and V tiles, or zero it when it was not loaded.
template <int KIND>
__device__ void prepare_page(const ChunkLayout& L, unsigned char* smem, int li, bool loaded,
                             int ps, int hd) {
  float* k_s = reinterpret_cast<float*>(smem + L.off_k);
  float* v_s = reinterpret_cast<float*>(smem + L.off_v);
  const int row0 = li * ps;
  if (!loaded) {
    for (int i = threadIdx.x; i < ps * hd; i += kThreads) {
      const int s = i / hd, d = i - s * hd;
      k_s[(row0 + s) * L.kst + d] = 0.f;
      v_s[(row0 + s) * hd + d] = 0.f;
    }
    return;
  }
  if (KIND == kFloat) return;  // copied in place
  const float* sk = reinterpret_cast<const float*>(smem + L.off_sk) + row0;
  const float* sv = reinterpret_cast<const float*>(smem + L.off_sv) + row0;
  if (KIND == kInt8) {
    const uint32_t* rk = reinterpret_cast<const uint32_t*>(smem + L.off_rk) + row0 * hd / 4;
    const uint32_t* rv = reinterpret_cast<const uint32_t*>(smem + L.off_rv) + row0 * hd / 4;
    const int words = ps * hd / 4;
    for (int w = threadIdx.x; w < words; w += kThreads) {
      const int s = (4 * w) / hd, d = 4 * w - s * hd;
      const uint32_t kw = rk[w], vw = rv[w];
      const float ks = sk[s], vs = sv[s];
      float4 kf, vf;
      kf.x = __fmul_rn(rtq::byte_f32(kw, 0), ks);
      kf.y = __fmul_rn(rtq::byte_f32(kw, 1), ks);
      kf.z = __fmul_rn(rtq::byte_f32(kw, 2), ks);
      kf.w = __fmul_rn(rtq::byte_f32(kw, 3), ks);
      vf.x = __fmul_rn(rtq::byte_f32(vw, 0), vs);
      vf.y = __fmul_rn(rtq::byte_f32(vw, 1), vs);
      vf.z = __fmul_rn(rtq::byte_f32(vw, 2), vs);
      vf.w = __fmul_rn(rtq::byte_f32(vw, 3), vs);
      *reinterpret_cast<float4*>(k_s + (row0 + s) * L.kst + d) = kf;
      *reinterpret_cast<float4*>(v_s + (row0 + s) * hd + d) = vf;
    }
  } else {
    const int hdp = hd / 2;
    const uint32_t* rk = reinterpret_cast<const uint32_t*>(smem + L.off_rk) + row0 * hdp / 4;
    const uint32_t* rv = reinterpret_cast<const uint32_t*>(smem + L.off_rv) + row0 * hdp / 4;
    const int words = ps * hdp / 4;
    for (int w = threadIdx.x; w < words; w += kThreads) {
      const int s = (4 * w) / hdp, d = 4 * w - s * hdp;  // channels d..d+3 and d+hdp..
      const uint32_t kw = rk[w], vw = rv[w];
      const float ks = sk[s], vs = sv[s];
      float4 klo, khi, vlo, vhi;
      float* kl = &klo.x;
      float* kh = &khi.x;
      float* vl = &vlo.x;
      float* vh = &vhi.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t kb = static_cast<uint8_t>(kw >> (8 * e));
        const uint8_t vb = static_cast<uint8_t>(vw >> (8 * e));
        kl[e] = __fmul_rn(nibble_f32(kb, false), ks);
        kh[e] = __fmul_rn(nibble_f32(kb, true), ks);
        vl[e] = __fmul_rn(nibble_f32(vb, false), vs);
        vh[e] = __fmul_rn(nibble_f32(vb, true), vs);
      }
      *reinterpret_cast<float4*>(k_s + (row0 + s) * L.kst + d) = klo;
      *reinterpret_cast<float4*>(k_s + (row0 + s) * L.kst + d + hdp) = khi;
      *reinterpret_cast<float4*>(v_s + (row0 + s) * hd + d) = vlo;
      *reinterpret_cast<float4*>(v_s + (row0 + s) * hd + d + hdp) = vhi;
    }
  }
}

// SHORT: pages of fewer than 4 rows (ps % 4 != 0) in an int8 or int4 pool,
// whose scales (and some int4 rows) need copies narrower than 16 bytes; a
// separate instantiation, so pages of 4 rows and more run the code they
// ran before short pages were served.
template <int KIND, bool SHORT>
__global__ void __launch_bounds__(kThreads) chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Q, H, hd]
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,  // [P, KV, ps, hd(/2)]
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,  // [P, KV, ps]
    const int* __restrict__ table,  // [B, T]
    const int* __restrict__ pos,    // [B]
    float* __restrict__ part_acc,   // [B*Q*H, nc, hd]
    float2* __restrict__ part_ml,   // [B*Q*H, nc]
    int Q, int H, int KV, int hd, int ps, int T, int R, int C, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChunkLayout L = chunk_layout(KIND, R, C, ps, hd);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + L.off_k);
  float* v_s = reinterpret_cast<float*>(smem + L.off_v);
  float* p_s = reinterpret_cast<float*>(smem + L.off_p);
  int* pid_s = reinterpret_cast<int*>(smem + L.off_pid);
  const int tid = threadIdx.x;
  const int rep = H / KV;
  const int QR = Q * rep;
  const int tiles = (QR + R - 1) / R;
  const int c = blockIdx.x, nc = gridDim.x, g = blockIdx.y;
  const int b = blockIdx.z / tiles;
  const int r0 = (blockIdx.z - b * tiles) * R;  // this tile's first row
  const int nr = min(R, QR - r0);               // its rows
  const int pos_b = pos[b];
  const int last = pos_b + (r0 + nr - 1) / rep;  // the tile's last position
  const int npos = L.npos;
  const int p0 = c * npos;                       // the chunk's first position
  // Output row of tile row r: query (r0 + r) / rep, head g*rep + (r0 + r) % rep.
  auto out_row = [&](int r) {
    const int rr = r0 + r;
    return ((size_t)b * Q + rr / rep) * H + g * rep + rr % rep;
  };

  if (p0 > last) {  // the empty partial: no row of the tile reaches this chunk
    for (int r = tid; r < nr; r += kThreads)
      part_ml[out_row(r) * nc + c] = make_float2(kNegInf, 0.f);
    return;
  }
  int n_act = last / ps + 1;  // pages up to the tile's last position
  if (n_act > T) n_act = T;
  if (tid < C) {
    const int ti = c * C + tid;
    pid_s[tid] = ti < n_act ? table[(size_t)b * T + ti] : 0;  // 0: not read
  }
  __syncthreads();

  // Every page of the chunk in flight at once, one commit group a page.
  const int hdp = KIND == kInt4 ? hd / 2 : hd;
  for (int li = 0; li < C; ++li) {
    const int pid = pid_s[li];
    if (pid != 0) {
      const size_t page = ((size_t)pid * KV + g) * ps;  // first pool row of the page
      if (KIND == kFloat) {
        const float* kp = static_cast<const float*>(k_pool) + page * hd;
        const float* vp = static_cast<const float*>(v_pool) + page * hd;
        const int per_row = hd / 4;
        for (int e = tid; e < ps * per_row; e += kThreads) {
          const int s = e / per_row, f = e - s * per_row;
          cp_async16(k_s + (li * ps + s) * L.kst + 4 * f, kp + (size_t)s * hd + 4 * f);
          cp_async16(v_s + (li * ps + s) * hd + 4 * f, vp + (size_t)s * hd + 4 * f);
        }
      } else {
        const uint8_t* kp = static_cast<const uint8_t*>(k_pool) + page * hdp;
        const uint8_t* vp = static_cast<const uint8_t*>(v_pool) + page * hdp;
        unsigned char* rk = smem + L.off_rk + li * ps * hdp;
        unsigned char* rv = smem + L.off_rv + li * ps * hdp;
        // A page's rows are ps * hdp contiguous bytes at a multiple of
        // that size, a multiple of 8 (hd % 16 == 0): 16-byte pieces, or 8
        // where short pages leave them off 16-byte alignment (an int4 page
        // of one row with hd % 32 == 16).
        if (SHORT && ps * hdp % 16 != 0) {
          for (int e = tid; e < ps * hdp / 8; e += kThreads) {
            cp_async_narrow<8>(rk + 8 * e, kp + 8 * e);
            cp_async_narrow<8>(rv + 8 * e, vp + 8 * e);
          }
        } else {
          for (int e = tid; e < ps * hdp / 16; e += kThreads) {
            cp_async16(rk + 16 * e, kp + 16 * e);
            cp_async16(rv + 16 * e, vp + 16 * e);
          }
        }
        // The page's ps f32 row scales: 4 a piece, or one a piece in short
        // pages (1 or 2 rows: only 4-byte aligned).
        float* sk = reinterpret_cast<float*>(smem + L.off_sk) + li * ps;
        float* sv = reinterpret_cast<float*>(smem + L.off_sv) + li * ps;
        if (SHORT) {
          for (int e = tid; e < ps; e += kThreads) {
            cp_async_narrow<4>(sk + e, k_scale + page + e);
            cp_async_narrow<4>(sv + e, v_scale + page + e);
          }
        } else {
          for (int e = tid; e < ps / 4; e += kThreads) {
            cp_async16(sk + 4 * e, k_scale + page + 4 * e);
            cp_async16(sv + 4 * e, v_scale + page + 4 * e);
          }
        }
      }
    }
    cp_async_commit();
  }

  // The tile's query rows, pre-scaled; rows past nr zero.
  for (int i = tid; i < L.rp * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float v = 0.f;
    if (r < nr) {
      const int rr = r0 + r;
      v = __fmul_rn(load_f32(q, (((size_t)b * Q + rr / rep) * H + g * rep + rr % rep) * hd + d),
                    q_scale);
    }
    q_s[i] = v;
  }

  // Page by page: wait for its bytes, dequantize, score it. A thread scores
  // one position for 4 rows, each dot product summed in d order from 0 (the
  // order of a one-thread f32 dot, which keeps the scores' rounding close
  // to the plain version's GEMM: a score error is amplified by |v| in the
  // output).
  const int hd4 = hd / 4;
  const int kst4 = L.kst / 4;
  const int items = (L.rp / 4) * ps;  // (4 rows, position)
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const float4* k4 = reinterpret_cast<const float4*>(k_s);
  for (int li = 0; li < C; ++li) {
    cp_async_wait_dyn(C - 1 - li);
    __syncthreads();  // page li's bytes (every thread's copies) and q visible
    const bool loaded = pid_s[li] != 0;
    if (KIND != kFloat || !loaded) {
      prepare_page<KIND>(L, smem, li, loaded, ps, hd);
      __syncthreads();
    }
    for (int item = tid; item < items; item += kThreads) {
      const int jj = item % ps, rg = item / ps;
      const int jl = li * ps + jj;  // position in the chunk
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int f = 0; f < hd4; ++f) {
        const float4 kv = k4[jl * kst4 + f];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = q4[(4 * rg + i) * hd4 + f];
          acc[i] = fmaf(qv.x, kv.x, acc[i]);
          acc[i] = fmaf(qv.y, kv.y, acc[i]);
          acc[i] = fmaf(qv.z, kv.z, acc[i]);
          acc[i] = fmaf(qv.w, kv.w, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        const bool vis = loaded && p0 + jl <= pos_b + (r0 + r) / rep;
        p_s[r * npos + jl] = acc[i] + (vis ? 0.f : kNegInf);
      }
    }
  }
  __syncthreads();

  // The chunk's softmax, one warp per row: max, exp, sum.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < nr; r += kThreads / 32) {
    float* pr = p_s + r * npos;
    float mx = kNegInf;
    for (int j = lane; j < npos; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < npos; j += 32) {
      const float p = expf(pr[j] - mx);
      pr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) part_ml[out_row(r) * nc + c] = make_float2(mx, sum);
  }
  __syncthreads();

  // P.V: 4 rows x 4 channels a thread, positions in order.
  const float4* v4 = reinterpret_cast<const float4*>(v_s);
  const float4* p4 = reinterpret_cast<const float4*>(p_s);
  const int npos4 = npos / 4;
  for (int item = tid; item < (L.rp / 4) * hd4; item += kThreads) {
    const int f = item % hd4, rg = item / hd4;
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j4 = 0; j4 < npos4; ++j4) {
      float4 pw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pw[i] = p4[(4 * rg + i) * npos4 + j4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 vv = v4[(4 * j4 + e) * hd4 + f];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pw[i].x : e == 1 ? pw[i].y : e == 2 ? pw[i].z : pw[i].w;
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * rg + i;
      if (r < nr)
        reinterpret_cast<float4*>(part_acc + (out_row(r) * nc + c) * hd)[f] = acc[i];
    }
  }
}

// One warp per output row: the row's chunks merged in ascending order.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    float* __restrict__ out, int rows, int nc, int hd) {
  const int row = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float2* ml = part_ml + (size_t)row * nc;
  float m = kNegInf;
  for (int c = 0; c < nc; ++c) {
    const float mc = ml[c].x;
    if (mc > 0.5f * kNegInf) m = fmaxf(m, mc);
  }
  const bool seen = m > 0.5f * kNegInf;
  float l = 0.f;
  if (seen) {
    for (int c = 0; c < nc; ++c) {
      const float2 v = ml[c];
      if (v.x > 0.5f * kNegInf) l = fmaf(v.y, expf(v.x - m), l);
    }
  }
  const float den = fmaxf(l, 1e-30f);
  const int hd4 = hd / 4;
  const float4* acc4 = reinterpret_cast<const float4*>(part_acc) + (size_t)row * nc * hd4;
  float4* o4 = reinterpret_cast<float4*>(out) + (size_t)row * hd4;
  for (int f = lane; f < hd4; f += 32) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (seen) {
      for (int c = 0; c < nc; ++c) {
        const float2 v = ml[c];
        if (!(v.x > 0.5f * kNegInf)) continue;
        const float w = expf(v.x - m);
        const float4 pa = acc4[(size_t)c * hd4 + f];
        a.x = fmaf(pa.x, w, a.x);
        a.y = fmaf(pa.y, w, a.y);
        a.z = fmaf(pa.z, w, a.z);
        a.w = fmaf(pa.w, w, a.w);
      }
    }
    o4[f] = make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
}

template <int KIND>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale, const int* table,
           const int* pos, float* out, float* part, int B, int Q, int H, int KV, int hd,
           int ps, int T, int R, int C, float q_scale, float qmax, float inv_qmax,
           cudaStream_t st) {
  const __nv_bfloat16* kn = static_cast<const __nv_bfloat16*>(k_new);
  const __nv_bfloat16* vn = static_cast<const __nv_bfloat16*>(v_new);
  append_kernel<KIND><<<dim3(B, KV, Q), kThreads, 0, st>>>(
      kn, vn, k_pool, v_pool, k_scale, v_scale, table, pos, Q, KV, hd, ps, T, qmax,
      inv_qmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChunkLayout L = chunk_layout(KIND, R, C, ps, hd);
  const int nc = (T + C - 1) / C;
  const int QR = Q * (H / KV);
  const int tiles = (QR + R - 1) / R;
  const int rows = B * Q * H;
  float* part_acc = part;
  float2* part_ml = reinterpret_cast<float2*>(part + (size_t)rows * nc * hd);
  const bool short_pages = KIND != kFloat && ps % 4 != 0;
  auto kern =
      short_pages ? chunk_attention_kernel<KIND, true> : chunk_attention_kernel<KIND, false>;
  err = rtq::ensure_dynamic_smem(kern, g_smem_set[2 * KIND + short_pages], L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(nc, KV, B * tiles), kThreads, L.bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, k_scale, v_scale, table, pos,
      part_acc, part_ml, Q, H, KV, hd, ps, T, R, C, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = kMergeThreads / 32;
  merge_kernel<<<(rows + warps_per_block - 1) / warps_per_block, kMergeThreads, 0, st>>>(
      part_acc, part_ml, out, rows, nc, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k_new/v_new are bfloat16 (the model's activations); kind: 0 = float32
// pool (scales unused), 1 = int8 pool, 2 = packed int4 pool (uint8, hd/2
// bytes a row), both with f32 row scales; R: query rows per tile, a
// multiple of H / KV; C: pages a chunk; part: f32 workspace of B*Q*H*nc*
// (hd + 2) floats, nc = ceil(T / C) (the partial accumulators, then (m, l)
// pairs). hd % 16 == 0 (copies of 8 or 16 bytes of page rows); ps any
// power of two, with C * ps % 4 == 0 (the scores' rows are read 4 positions
// at a time). Returns cudaGetLastError() (0 = ok; cudaErrorInvalidValue for an unknown
// kind).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    float* k_scale, float* v_scale, int kind, const int* table, const int* pos,
    float* out, float* part, int B, int Q, int H, int KV, int hd, int ps, int T, int R,
    int C, float q_scale, float qmax, float inv_qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kFloat:
      return launch<kFloat>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                            out, part, B, Q, H, KV, hd, ps, T, R, C, q_scale, qmax, inv_qmax,
                            st);
    case kInt8:
      return launch<kInt8>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, part, B, Q, H, KV, hd, ps, T, R, C, q_scale, qmax, inv_qmax,
                           st);
    case kInt4:
      return launch<kInt4>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, table, pos,
                           out, part, B, Q, H, KV, hd, ps, T, R, C, q_scale, qmax, inv_qmax,
                           st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
