// Swin window attention of one (window, head), shared by K1 / K5
// (swin_block.cu, the whole block) and K4 / K6 (window_attn.cu, attention
// only), so that the kernels compute and round a logit, a softmax and P V
// alike: the bf16 kernels all run attention_unit, which is templated on the
// key-tile count, N, the head dim, the staging's addressing and where the
// relative bias lives; the fp32 kernels run attention_fma, with the same
// logit (logit_b).
//
// The caller stages the window's qkv rows in shared memory: for K1 / K5 in
// planes of 8 columns, q of head h at columns h*hd, k at C + h*hd, v at
// 2C + h*hd (PlanesQKV); for K4 / K6 as three row-major regions of the head
// group's q, k and v columns with one row stride (RowsQKV); for the fp32
// kernels row-major (row i at base + i * ldq; attention_fma).  The output of
// query i overwrites q_i (columns h*hd ..), which no other query block reads.
//
// Shift masks (WindowMask): with the cyclically rolled window grid of the
// module path, only the last window row / column straddles the wrap-around;
// a token's region is 2 bits (shift_region) and pairs in different regions
// get -100, the value of the reference's shifted_window_mask.  With the
// padded grid of the window-ordered block (K5, shift_mode "pad"), a key
// outside the unpadded image gets -100 for every query, as the reference's
// key-validity mask (nunif_tpu/ops/swin_attention.py:_block_compute).  Both
// are region labels compared in `logit`: a pad-mode query is in region 0 and
// a key in region 1 when it lies outside.  Every valid query keeps its own
// key, so no softmax row of a valid query is empty.
#pragma once

#include "common.cuh"

namespace nunif {

// bf16 attention covers 16 Tiles keys: 1 tile (N = 16), 3 (N <= 48:
// window 6, K1, K5, K4 / K6) or 4 (N <= 64: windows 7 and 8, K4 / K6 only)
constexpr int kMaxAttnTiles = 4;
constexpr int kMaxHeadDim = 64;

// Region label of token t in window (last_r, last_c) of the rolled grid:
// only the last window row / column straddles the wrap-around.
__device__ __forceinline__ int shift_region(int t, int ws, int cut, bool last_r, bool last_c) {
  return ((last_r && t / ws >= cut) ? 1 : 0) + ((last_c && t % ws >= cut) ? 2 : 0);
}

// The -100 mask of one window.
struct WindowMask {
  int ws;
  bool pad;              // pad mode: key validity; else the roll regions
  bool active;           // false: no pair of this window is masked
  int cut;               // roll: ws - shift
  bool last_r, last_c;   // roll: the window straddles the wrap-around
  int row0, col0;        // pad: image coordinates of token 0
  int h_valid, w_valid;  // pad: the unpadded extent

  __device__ __forceinline__ int key_region(int t) const {
    if (!active) return 0;
    if (!pad) return shift_region(t, ws, cut, last_r, last_c);
    const int row = row0 + t / ws, col = col0 + t % ws;
    return (row >= 0 && row < h_valid && col >= 0 && col < w_valid) ? 0 : 1;
  }
  __device__ __forceinline__ int query_region(int t) const {
    return (active && !pad) ? shift_region(t, ws, cut, last_r, last_c) : 0;
  }
};

// Window (wr, wc) of the cyclically rolled grid of n_wh x n_ww windows.
__device__ __forceinline__ WindowMask roll_mask(int ws, int shift, int wr, int wc, int n_wh,
                                                int n_ww) {
  WindowMask m{};
  m.ws = ws;
  m.cut = ws - shift;
  m.last_r = shift > 0 && wr == n_wh - 1;
  m.last_c = shift > 0 && wc == n_ww - 1;
  m.active = m.last_r || m.last_c;
  return m;
}

// Window (wr, wc) of the grid of an image padded by `shift` top-left and
// ws - shift bottom-right: key t is valid iff wr ws - shift + t / ws lies in
// [0, (n_wh - 1) ws) and wc ws - shift + t % ws in [0, (n_ww - 1) ws).
__device__ __forceinline__ WindowMask pad_mask(int ws, int shift, int wr, int wc, int n_wh,
                                               int n_ww) {
  WindowMask m{};
  m.ws = ws;
  m.pad = true;
  m.row0 = wr * ws - shift;
  m.col0 = wc * ws - shift;
  m.h_valid = (n_wh - 1) * ws;
  m.w_valid = (n_ww - 1) * ws;
  m.active = shift > 0 && (m.row0 < 0 || m.row0 + ws > m.h_valid || m.col0 < 0 ||
                           m.col0 + ws > m.w_valid);
  return m;
}

// The one definition of a logit, for every attention path: raw dot
// product s of a query in region rq with a key in region rk, scaled, plus
// the relative bias b, -100 across regions.
__device__ __forceinline__ float logit_b(float s, float scale, float b, int rq, int rk) {
  return s * scale + b - (rk != rq ? 100.f : 0.f);
}

// the same with the bias read from the query's relative-bias row
__device__ __forceinline__ float logit(float s, float scale, const float* rb_row, int key, int rq,
                                       int rk) {
  return logit_b(s, scale, __ldg(rb_row + key), rq, rk);
}

// Logits of query i against keys j < N from raw dot products s[j]; returns
// the row max.
__device__ __forceinline__ float logits_row(float* s, int i, int N, float scale, const float* rb,
                                            WindowMask mask) {
  const int reg_i = mask.query_region(i);
  const float* rbi = rb + (size_t)i * N;
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = 0; j < N; ++j) {
    s[j] = logit(s[j], scale, rbi, j, reg_i, mask.key_region(j));
    m = fmaxf(m, s[j]);
  }
  return m;
}

// The softmax's exponentials of the two query rows a lane holds in an
// mma.sync score fragment s (keys 8 jn + 2t + e: [jn][e] row g, [jn][2 + e]
// row g + 8): exp(s - row max) where ok(jn, key), else 0; the lane's part
// of each row's sum goes to sum0 / sum1 (the quad adds them).
template <int Tiles, typename Ok>
__device__ __forceinline__ void softmax_exp(float (&s)[2 * Tiles][4], float m0, float m1, int t,
                                            Ok ok, float& sum0, float& sum1) {
#pragma unroll
  for (int jn = 0; jn < 2 * Tiles; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = ok(jn, jn * 8 + 2 * t + e);
      s[jn][e] = in ? __expf(s[jn][e] - m0) : 0.f;
      s[jn][2 + e] = in ? __expf(s[jn][2 + e] - m1) : 0.f;
      sum0 += s[jn][e];
      sum1 += s[jn][2 + e];
    }
  }
}

// Normalised probabilities (times inv0 / inv1, the rows' 1 / sum), rounded
// to bf16, as A fragments of P V: two adjacent 8-key accumulator tiles are
// one 16-key A tile.
template <int Tiles>
__device__ __forceinline__ void probs_a(const float (&s)[2 * Tiles][4], float inv0, float inv1,
                                        uint32_t (&pa)[Tiles][4]) {
#pragma unroll
  for (int kc = 0; kc < Tiles; ++kc) {
    pa[kc][0] = pack_bf16x2(s[2 * kc][0] * inv0, s[2 * kc][1] * inv0);
    pa[kc][1] = pack_bf16x2(s[2 * kc][2] * inv1, s[2 * kc][3] * inv1);
    pa[kc][2] = pack_bf16x2(s[2 * kc + 1][0] * inv0, s[2 * kc + 1][1] * inv0);
    pa[kc][3] = pack_bf16x2(s[2 * kc + 1][2] * inv1, s[2 * kc + 1][3] * inv1);
  }
}

// K1 / K5 staging: columns 8 p .. 8 p + 7 of every row form plane p,
// `plane` elements long, 16 bytes a row (wgmma's unswizzled K-major layout,
// so any 8 consecutive rows of a plane are one 128-byte core matrix); base
// is the window's first row of plane 0.
struct Planes {
  __nv_bfloat16* base;
  int plane;
  __device__ __forceinline__ __nv_bfloat16* at(int row, int col) const {
    return base + (size_t)(col >> 3) * plane + row * 8 + (col & 7);
  }
};

// Where attention_unit finds q, k and v: element (row, col) of a head
// group's q, k or v columns, col in 0 .. group * hd.
// K1 / K5: all heads, in planes; k and v C and 2C columns after q.
struct PlanesQKV {
  Planes a;
  int C;
  __device__ __forceinline__ __nv_bfloat16* q(int row, int col) const { return a.at(row, col); }
  __device__ __forceinline__ __nv_bfloat16* k(int row, int col) const {
    return a.at(row, C + col);
  }
  __device__ __forceinline__ __nv_bfloat16* v(int row, int col) const {
    return a.at(row, 2 * C + col);
  }
};

// K4 / K6: three row-major regions with one row stride `ld` (elements).
struct RowsQKV {
  __nv_bfloat16 *qb, *kb, *vb;
  int ld;
  __device__ __forceinline__ __nv_bfloat16* q(int row, int col) const {
    return qb + row * ld + col;
  }
  __device__ __forceinline__ __nv_bfloat16* k(int row, int col) const {
    return kb + row * ld + col;
  }
  __device__ __forceinline__ __nv_bfloat16* v(int row, int col) const {
    return vb + row * ld + col;
  }
};

// Where attention_unit finds the relative bias, and how it loads a unit's
// values: fill(bias, h, q0, q1, N, t) sets bias[jn][e] (row q0) and
// bias[jn][2 + e] (row q1) to the bias of key 8 jn + 2t + e of head h,
// rows past N read as row 0.  With N a constant (NFix), a key group past N
// for every lane is not read (0).
// K1 / K5 and K4 / K6 when the group's bias does not fit beside the ring:
// (heads, N, N) fp32 in device memory, through the read-only path.  A key
// group that straddles N clamps its keys to N - 1.
struct LdgBias {
  const float* rb;
  template <int Tiles, int NFix>
  __device__ __forceinline__ void fill(float (&bias)[2 * Tiles][4], int h, int q0, int q1, int N,
                                       int t) const {
    const float* rbh = rb + (size_t)h * N * N + 2 * t;
    const float* b0 = rbh + (size_t)(q0 < N ? q0 : 0) * N;
    const float* b1 = rbh + (size_t)(q1 < N ? q1 : 0) * N;
#pragma unroll
    for (int jn = 0; jn < 2 * Tiles; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int off = jn * 8 + e;  // key - 2t
        if (NFix == 0 || jn * 8 + 6 + e >= NFix)
          off = jn * 8 + 2 * t + e < N ? off : N - 1 - 2 * t;
        const bool read = NFix == 0 || jn * 8 + e < NFix;
        bias[jn][e] = read ? __ldg(b0 + off) : 0.f;
        bias[jn][2 + e] = read ? __ldg(b1 + off) : 0.f;
      }
    }
  }
};

// K4 / K6: the head group's bias in shared memory, (group, N, ld) fp32
// with ld >= 8 ceil(N / 8) and ld = 8 mod 16 (bias_row_stride), so that a
// lane's two keys are one 8-byte load and the 16 lanes of a half-warp (4
// rows x 4 key pairs) hit 16 different bank pairs.  Keys N .. ld - 1 of a
// row are finite padding.
struct SmemBias {
  const float* rb;
  int ld;
  template <int Tiles, int NFix>
  __device__ __forceinline__ void fill(float (&bias)[2 * Tiles][4], int h, int q0, int q1, int N,
                                       int t) const {
    const float* rbh = rb + h * N * ld;
    const float* b0 = rbh + (q0 < N ? q0 : 0) * ld;
    const float* b1 = rbh + (q1 < N ? q1 : 0) * ld;
#pragma unroll
    for (int jn = 0; jn < 2 * Tiles; ++jn) {
      // with N a constant, keys 8 jn .. 8 jn + 7 < ld; else stay in the row
      const int key = NFix > 0 || jn * 8 + 2 * t < ld ? jn * 8 + 2 * t : 0;
      const bool read = NFix == 0 || jn * 8 < NFix;
      const float2 v0 = read ? *reinterpret_cast<const float2*>(b0 + key) : make_float2(0.f, 0.f);
      const float2 v1 = read ? *reinterpret_cast<const float2*>(b1 + key) : make_float2(0.f, 0.f);
      bias[jn][0] = v0.x;
      bias[jn][1] = v0.y;
      bias[jn][2] = v1.x;
      bias[jn][3] = v1.y;
    }
  }
};

// Row stride (floats) of SmemBias for N keys: the least ld >= N with ld =
// 8 mod 16.
__host__ __device__ __forceinline__ int bias_row_stride(int N) { return (N + 7) / 16 * 16 + 8; }

// mask.key_region(t) and mask.query_region(t) without a division or a
// branch: t / ws as (t * inv_ws) >> 16 with inv_ws = ceil(2^16 / ws), exact
// for t < 2^16 / ws.
__device__ __forceinline__ int key_region_mul(const WindowMask& m, int t, uint32_t inv_ws) {
  const int r = (int)(((uint32_t)t * inv_ws) >> 16), c = t - r * m.ws;
  const int row = m.row0 + r, col = m.col0 + c;
  const int roll = (m.last_r && r >= m.cut ? 1 : 0) + (m.last_c && c >= m.cut ? 2 : 0);
  const int pad = row >= 0 && row < m.h_valid && col >= 0 && col < m.w_valid ? 0 : 1;
  return m.active ? (m.pad ? pad : roll) : 0;
}

__device__ __forceinline__ int query_region_mul(const WindowMask& m, int t, uint32_t inv_ws) {
  return m.pad ? 0 : key_region_mul(m, t, inv_ws);
}

// bf16 attention of queries 16 mi .. 16 mi + 15 of head h (of the staged
// head group) on tensor cores: S = Q K^T and P V on mma.sync m16n8k16 with
// the scores and softmax in registers (logit_b, softmax_exp and probs_a).
// Tiles 16-key tiles, always all of them (N <= 16 Tiles): keys past N are
// dropped, rows up to 16 Tiles - 1 of q, k and v are read and must lie
// inside the buffer, and v's rows past N must be finite (their
// probabilities are 0, but 0 x NaN is NaN); outputs of rows past N are
// not stored.  Head dim 16 KT.  NFix: N as a constant, or 0 to take n.
// On 8-12 warps an SM its cost is the instructions a unit issues, so the
// loops have no runtime bounds, the region labels take a multiply where
// WindowMask divides, the row max a select, and the bias values are loaded
// up front, all in flight at once.  A window without a mask (most of them)
// skips the region labels on a branch the whole warp takes.  Stage:
// PlanesQKV or RowsQKV; Bias: LdgBias or SmemBias; inv_ws as for
// key_region_mul; store false: compute but write nothing.
template <int KT, int Tiles, int NFix, typename Stage, typename Bias>
__device__ __forceinline__ void attention_unit(const Stage& a, const Bias& rb, int h, int mi,
                                               const WindowMask& mask, bool store, int n,
                                               float scale, uint32_t inv_ws) {
  constexpr int hd = 16 * KT;
  const int N = NFix > 0 ? NFix : n;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = mi * 16 + g, q1 = q0 + 8;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qa[kk], a.q(mi * 16 + lane % 16, h * hd + kk * 16 + (lane / 16) * 8));
  // bias [jn][e], [jn][2 + e]: rows q0, q1, key 8 jn + 2t + e
  float bias[2 * Tiles][4], s[2 * Tiles][4];
  rb.template fill<Tiles, NFix>(bias, h, q0, q1, N, t);
#pragma unroll
  for (int jn = 0; jn < 2 * Tiles; ++jn)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[jn][c] = 0.f;
  // S = Q K^T: 8-key tiles, lane holds keys 8 jn + 2t + {0, 1} of query
  // rows g and g + 8
#pragma unroll
  for (int jk = 0; jk < Tiles; ++jk)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      const int key = jk * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, a.k(key, h * hd + kk * 16 + ((lane >> 3) & 1) * 8));
      mma_16816(s[2 * jk], qa[kk], b[0], b[1]);
      mma_16816(s[2 * jk + 1], qa[kk], b[2], b[3]);
    }
  // logits, softmax over keys < N; the four lanes of a row share it
  const float ninf = __int_as_float(0xff800000);
  float m0 = ninf, m1 = ninf;
  auto logits = [&](auto masked_tag) {
    constexpr bool masked = decltype(masked_tag)::value;
    const int r0 = masked ? query_region_mul(mask, q0, inv_ws) : 0;
    const int r1 = masked ? query_region_mul(mask, q1, inv_ws) : 0;
#pragma unroll
    for (int jn = 0; jn < 2 * Tiles; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = jn * 8 + 2 * t + e;
        const int rk = masked ? key_region_mul(mask, key, inv_ws) : 0;
        s[jn][e] = logit_b(s[jn][e], scale, bias[jn][e], r0, rk);
        s[jn][2 + e] = logit_b(s[jn][2 + e], scale, bias[jn][2 + e], r1, rk);
        m0 = key < N ? fmaxf(m0, s[jn][e]) : m0;
        m1 = key < N ? fmaxf(m1, s[jn][2 + e]) : m1;
      }
    }
  };
  if (mask.active)
    logits(std::true_type{});
  else
    logits(std::false_type{});
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float sum0 = 0.f, sum1 = 0.f;
  softmax_exp<Tiles>(s, m0, m1, t, [&](int, int key) { return key < N; }, sum0, sum1);
  // 1 / sum correctly rounded, as 1.f / sum is
  const float inv0 = __frcp_rn(quad_sum(sum0)), inv1 = __frcp_rn(quad_sum(sum1));
  uint32_t pa[Tiles][4];
  probs_a<Tiles>(s, inv0, inv1, pa);
  float o[2 * KT][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KT; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
#pragma unroll
  for (int kc = 0; kc < Tiles; ++kc)
#pragma unroll
    for (int nd = 0; nd < KT; ++nd) {
      uint32_t b[4];
      const int key = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldmatrix_x4_trans(b, a.v(key, h * hd + nd * 16 + (lane >> 4) * 8));
      mma_16816(o[2 * nd], pa[kc], b[0], b[1]);
      mma_16816(o[2 * nd + 1], pa[kc], b[2], b[3]);
    }
#pragma unroll
  for (int nd = 0; nd < 2 * KT; ++nd) {
    const int col = h * hd + nd * 8 + 2 * t;
    if (store && q0 < N) store2(a.q(q0, col), o[nd][0], o[nd][1]);
    if (store && q1 < N) store2(a.q(q1, col), o[nd][2], o[nd][3]);
  }
}

// Attention of every query of one (window, head) on CUDA cores, one query
// at a time: lanes over keys, then over dims (hd <= 64).  pr: this warp's
// row of N floats in shared memory.  Reads rows < N only.
template <typename T>
__device__ __forceinline__ void attention_fma(T* base, int ldq, int C, int h, int hd, int N,
                                              float scale, const float* rb,
                                              WindowMask mask, float* pr) {
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < N; ++i) {
    const T* qi = base + (size_t)i * ldq + h * hd;
    for (int j = lane; j < N; j += 32) {
      const T* kj = base + (size_t)j * ldq + C + h * hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(to_f(qi[d]), to_f(kj[d]), s);
      pr[j] = s;
    }
    __syncwarp();
    float m = 0.f;
    if (lane == 0) m = logits_row(pr, i, N, scale, rb, mask);
    m = __shfl_sync(0xffffffffu, m, 0);
    __syncwarp();
    float sloc = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sloc += e;
    }
    const float inv = 1.f / warp_sum(sloc);
    for (int j = lane; j < N; j += 32) pr[j] = round_t<T>(pr[j] * inv);
    __syncwarp();
    float o0 = 0.f, o1 = 0.f;
    const T* vb = base + 2 * C + h * hd;
    for (int j = 0; j < N; ++j) {
      const float pj = pr[j];
      const T* vj = vb + (size_t)j * ldq;
      if (lane < hd) o0 = fmaf(pj, to_f(vj[lane]), o0);
      if (lane + 32 < hd) o1 = fmaf(pj, to_f(vj[lane + 32]), o1);
    }
    __syncwarp();
    T* oi = base + (size_t)i * ldq + h * hd;
    if (lane < hd) oi[lane] = from_f<T>(o0);
    if (lane + 32 < hd) oi[lane + 32] = from_f<T>(o1);
    __syncwarp();
  }
}

}  // namespace nunif
