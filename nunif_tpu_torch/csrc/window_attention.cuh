// Swin window attention of one (window, head), shared by K1 (swin_block.cu,
// the whole block) and K4 (window_attn.cu, attention only), so that both
// kernels compute and round a logit, a softmax and P V alike.
//
// The caller stages the window's qkv rows in shared memory: row i of the
// window at base + i * ldq, q of head h at columns h*hd, k at C + h*hd, v at
// 2C + h*hd.  The output of query i overwrites q_i (columns h*hd ..), which
// no other query block reads.
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

// The one definition of a logit, for both attention paths: raw dot product
// s of a query in region rq with key `key` in region rk, scaled, plus the
// query's relative-bias row, -100 across regions.
__device__ __forceinline__ float logit(float s, float scale, const float* rb_row, int key, int rq,
                                       int rk) {
  return s * scale + __ldg(rb_row + key) - (rk != rq ? 100.f : 0.f);
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
#pragma unroll
  for (int jn = 0; jn < 2 * Tiles; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = jn * 8 + 2 * t + e;
      const bool ok = jn < 2 * nt && key < N;
      s[jn][e] = ok ? __expf(s[jn][e] - m0) : 0.f;
      s[jn][2 + e] = ok ? __expf(s[jn][2 + e] - m1) : 0.f;
      sum0 += s[jn][e];
      sum1 += s[jn][2 + e];
    }
  }
  const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  // normalised probabilities, rounded to bf16, as A fragments of P V: two
  // adjacent 8-key accumulator tiles are one 16-key A tile
  uint32_t pa[Tiles][4];
#pragma unroll
  for (int kc = 0; kc < Tiles; ++kc) {
    pa[kc][0] = pack_bf16x2(s[2 * kc][0] * inv0, s[2 * kc][1] * inv0);
    pa[kc][1] = pack_bf16x2(s[2 * kc][2] * inv1, s[2 * kc][3] * inv1);
    pa[kc][2] = pack_bf16x2(s[2 * kc + 1][0] * inv0, s[2 * kc + 1][1] * inv0);
    pa[kc][3] = pack_bf16x2(s[2 * kc + 1][2] * inv1, s[2 * kc + 1][3] * inv1);
  }
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
