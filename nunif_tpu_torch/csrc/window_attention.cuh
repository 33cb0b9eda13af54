// Swin window attention of one (window, head), shared by K1 / K5
// (swin_block.cu, the whole block) and K4 / K6 (window_attn.cu, attention
// only), so that the kernels compute and round a logit, a softmax and P V
// alike: attention_bf16 (K4 / K6) and attention_unit (K1 / K5) share the
// logit (logit_b), the exponentials (softmax_exp) and the rounded
// probabilities (probs_a); each keeps its own loads and its mma.sync loops.
//
// The caller stages the window's qkv rows in shared memory, q of head h at
// columns h*hd, k at C + h*hd, v at 2C + h*hd: row-major for K4 / K6 (row i
// at base + i * ldq; attention_bf16, attention_fma), in planes of 8
// columns for K1 / K5 (Planes; attention_unit).  The output of query i
// overwrites q_i (columns h*hd ..), which no other query block reads.
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

// bf16 attention covers 16 Tiles keys: 3 tiles (N <= 48: window 6, K1, K5,
// K4 / K6) or 4 (N <= 64: windows 7 and 8, K4 / K6 only)
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

// bf16 attention of queries 16 mi .. 16 mi + 15 of one (window, head) on
// tensor cores, N <= 16 Tiles.  base: the window's first qkv row.  Rows past
// N (next window or zeroed padding, up to row 16 * ceil(N / 16) - 1) are read
// but their scores are dropped and their outputs are not stored.  Tiles
// sizes the score registers (8 fp32 a lane a tile), so the smallest count
// that covers N is instantiated.
template <int Tiles>
__device__ __forceinline__ void attention_bf16(__nv_bfloat16* base, int ldq, int C, int h, int hd,
                                               int N, int mi, float scale, const float* rb,
                                               WindowMask mask) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (N + 15) / 16, kt = hd / 16;
  const __nv_bfloat16* kbase = base + C + h * hd;
  const __nv_bfloat16* vbase = base + 2 * C + h * hd;
  uint32_t qa[kMaxHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxHeadDim / 16; ++kk)
    if (kk < kt)
      ldmatrix_x4(qa[kk], base + (size_t)(mi * 16 + lane % 16) * ldq + h * hd + kk * 16 +
                              (lane / 16) * 8);
  // S = Q K^T: 8-key tiles, lane holds keys 8 jn + 2t + {0, 1} of query
  // rows g and g + 8
  float s[2 * Tiles][4] = {};
#pragma unroll
  for (int jk = 0; jk < Tiles; ++jk) {
    if (jk < nt) {
#pragma unroll
      for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
        if (kk < kt) {
          uint32_t b[4];
          const int key = jk * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, kbase + (size_t)key * ldq + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_16816(s[2 * jk], qa[kk], b[0], b[1]);
          mma_16816(s[2 * jk + 1], qa[kk], b[2], b[3]);
        }
      }
    }
  }
  // logits, softmax over keys < N; the four lanes of a row share it
  const int q0 = mi * 16 + g, q1 = q0 + 8;
  const int r0 = mask.query_region(q0);
  const int r1 = mask.query_region(q1);
  const float* rb0 = rb + (size_t)(q0 < N ? q0 : 0) * N;
  const float* rb1 = rb + (size_t)(q1 < N ? q1 : 0) * N;
  const float ninf = __int_as_float(0xff800000);
  float m0 = ninf, m1 = ninf;
#pragma unroll
  for (int jn = 0; jn < 2 * Tiles; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = jn * 8 + 2 * t + e;
      if (jn < 2 * nt && key < N) {
        const int rk = mask.key_region(key);
        s[jn][e] = logit(s[jn][e], scale, rb0, key, r0, rk);
        s[jn][2 + e] = logit(s[jn][2 + e], scale, rb1, key, r1, rk);
        m0 = fmaxf(m0, s[jn][e]);
        m1 = fmaxf(m1, s[jn][2 + e]);
      }
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float sum0 = 0.f, sum1 = 0.f;
  softmax_exp<Tiles>(s, m0, m1, t, [&](int jn, int key) { return jn < 2 * nt && key < N; },
                     sum0, sum1);
  const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  uint32_t pa[Tiles][4];
  probs_a<Tiles>(s, inv0, inv1, pa);
  float o[kMaxHeadDim / 8][4] = {};
#pragma unroll
  for (int kc = 0; kc < Tiles; ++kc) {
    if (kc < nt) {
#pragma unroll
      for (int nd = 0; nd < kMaxHeadDim / 16; ++nd) {
        if (nd < kt) {
          uint32_t b[4];
          const int key = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(b, vbase + (size_t)key * ldq + nd * 16 + (lane >> 4) * 8);
          mma_16816(o[2 * nd], pa[kc], b[0], b[1]);
          mma_16816(o[2 * nd + 1], pa[kc], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int nd = 0; nd < kMaxHeadDim / 8; ++nd) {
    if (nd < 2 * kt) {
      const int col = h * hd + nd * 8 + 2 * t;
      if (q0 < N) store2(base + (size_t)q0 * ldq + col, o[nd][0], o[nd][1]);
      if (q1 < N) store2(base + (size_t)q1 * ldq + col, o[nd][2], o[nd][3]);
    }
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

// attention_bf16's arithmetic, in its order (logit_b, softmax_exp and
// probs_a are the two bodies' common steps), for queries 16 mi .. 16 mi +
// 15 of head h of the window staged at `a` (Planes), head dim 16 KT, N <=
// 48: three 16-key tiles, always all three (keys past N are dropped as
// there; rows up to 47 of a window are read and must be finite and inside
// the buffer).  K1 / K5 run attention on 8 warps an SM, so its cost is the
// instructions a unit issues: the loops have no runtime bounds, the region
// labels take a multiply where WindowMask divides, the row max a select
// where attention_bf16 branches, and the bias values are loaded up front,
// all in flight at once (the kernel leaves ~28 KB of L1 beside its shared
// memory, so they mostly come from L2).  A window without a mask (most of
// them) skips the region labels on a branch the whole warp takes.  NFix:
// N as a constant (36, the window 6 of every K1 / K5 path), or 0 to take
// n.  rb: (heads, N, N); inv_ws as for key_region_mul; store false: compute
// but write nothing.
template <int KT, int NFix>
__device__ __forceinline__ void attention_unit(Planes a, int h, int mi, const WindowMask& mask,
                                               bool store, int C, int n, float scale,
                                               const float* rb, uint32_t inv_ws) {
  constexpr int Tiles = 3, hd = 16 * KT;
  const int N = NFix > 0 ? NFix : n;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = mi * 16 + g, q1 = q0 + 8;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qa[kk], a.at(mi * 16 + lane % 16, h * hd + kk * 16 + (lane / 16) * 8));
  // bias [jn][e], [jn][2 + e]: rows q0, q1, key 8 jn + 2t + e.  With N a
  // constant, a key group below N for every lane loads at a constant offset
  // from the lane's base, one that straddles N clamps its keys to N - 1,
  // and one past N for every lane is never read.
  float bias[2 * Tiles][4], s[2 * Tiles][4];
  {
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
#pragma unroll
      for (int c = 0; c < 4; ++c) s[jn][c] = 0.f;
    }
  }
  // S = Q K^T: 8-key tiles, lane holds keys 8 jn + 2t + {0, 1} of query
  // rows g and g + 8
#pragma unroll
  for (int jk = 0; jk < Tiles; ++jk)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t b[4];
      const int key = jk * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, a.at(key, C + h * hd + kk * 16 + ((lane >> 3) & 1) * 8));
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
      ldmatrix_x4_trans(b, a.at(key, 2 * C + h * hd + nd * 16 + (lane >> 4) * 8));
      mma_16816(o[2 * nd], pa[kc], b[0], b[1]);
      mma_16816(o[2 * nd + 1], pa[kc], b[2], b[3]);
    }
#pragma unroll
  for (int nd = 0; nd < 2 * KT; ++nd) {
    const int col = h * hd + nd * 8 + 2 * t;
    if (store && q0 < N) store2(a.at(q0, col), o[nd][0], o[nd][1]);
    if (store && q1 < N) store2(a.at(q1, col), o[nd][2], o[nd][3]);
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
