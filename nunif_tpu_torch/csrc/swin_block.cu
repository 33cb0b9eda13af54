// K1: one whole Swin-V1 block (norm "none") on an NHWC image, fused.
//
// Replaces nunif_tpu/ops/swin_attention.py:fused_swin_block_image (Pallas,
// kernel _kernel_block_img, body _block_compute).  Per window of ws x ws
// tokens:
//   qkv = x Wqkv + b;  per head softmax(q k^T * scale + relbias [-100 across
//   shift regions]) v;  y1 = attn Wproj + b + x;
//   out = gelu_erf(y1 Wfc1 + b) Wfc2 + b + y1
// with an optional `skip` added to x on the first read.
//
// Shift: the window grid is the cyclically rolled one of the module path
// (nunif_tpu/modules/attention.py:333-348).  Rolled row R reads image row
// (R + shift) % H, so neither a roll copy nor the TPU caller's pad/crop
// copies exist; the -100 region mask matches shifted_window_mask.  Every
// query keeps its own key, so no softmax row is empty.
//
// bf16 rounding points follow _block_compute: qkv after the bias, the
// normalised probabilities before PV, the attention output, y1, h1 after
// GELU, and the output.  All sums are fp32.  The softmax subtracts the row
// max (exact for any logit range) and GELU uses erff.
//
// What bounds it on the H100: per token the block does 16 C^2 + 4 N C
// multiply-adds against 2 C bytes in and out, so at C = 96 it sits far above
// the bf16 ridge; only on-chip work matters, and it is latency-bound
// (measured: doubling the resident warps from 8 to 16 cut the kernel by a
// third).  Design: one block of 16 warps owns up to 4 windows (4 x 36 = 144
// token rows = 9 MMA tiles, no padding at C = 96) and keeps x, qkv, the
// attention output, y1 and h1 in shared memory (qkv's buffer is reused for
// attention output and h1, y1 overwrites x), so activations touch device
// memory once in and once out.  Everything bf16 runs on tensor cores with
// mma.sync m16n8k16 (fp32 accumulation) and register-resident results:
// - GEMMs: a warp owns a 16-wide column panel over up to 5 row tiles; A
//   comes from shared memory by ldmatrix; weights (148 KB at C = 96,
//   590 KB at C = 192, L2-resident) arrive pre-arranged in fragment order
//   (ops/_build.py:mma_weight_layout), one 8-byte load per lane
//   per fragment, the next one in flight while the current one is used;
//   epilogues read the accumulators directly.
// - Attention: one warp per (window, head) and 16-query block; S = Q K^T
//   stays in registers (N = 36 padded to 48 keys), the softmax reduces
//   across the four lanes that share a row, and the probabilities feed
//   P V as A fragments without leaving registers.
// The fp32 variant keeps the data flow with FMA loops everywhere.
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 144;     // token rows per block (9 MMA tiles)
constexpr int kWarpMTiles = 5;    // MMA row tiles one warp accumulates
constexpr int kAttnTiles = 3;     // bf16 attention: N <= 48 tokens a window
constexpr int kMaxHeadDim = 64;

struct SwinArgs {
  const void* x;
  const void* skip;
  const void* wqkv;
  const float* bqkv;
  const void* wproj;
  const float* bproj;
  const void* wfc1;
  const float* bfc1;
  const void* wfc2;
  const float* bfc2;
  const float* relbias;  // (heads, N, N)
  void* out;
  int B, H, W, C, heads, hidden, ws, shift;
  float scale;
  int n_wh, n_ww, n_windows;
  int wpb;       // windows per block
  int rows_pad;  // wpb * N rounded up to 16
  int ldx, ldq;  // shared-memory row strides, in elements
};

struct SmemLayout {
  size_t x_off, q_off, prob_off, tok_off, total;
  int q_rows;  // rows of the qkv buffer
};

// Shared memory: x / y1 (rows_pad x ldx), qkv / attention output / h1
// (q_rows x ldq), the fp32 path's per-warp probability row, and the token
// offsets.
template <typename T>
__host__ __device__ SmemLayout smem_layout(int wpb, int rows_pad, int ldx, int ldq, int N) {
  SmemLayout L;
  L.q_rows = rows_pad;
  size_t probs = 0;
  if constexpr (IsBF16<T>::value) {
    // the last window's 16-row attention tiles reach past its rows
    const int reach = (wpb - 1) * N + (N + 15) / 16 * 16;
    if (reach > L.q_rows) L.q_rows = reach;
  } else {
    probs = (size_t)kWarps * N * sizeof(float);
  }
  size_t o = 0;
  L.x_off = o;
  o = align_up(o + (size_t)rows_pad * ldx * sizeof(T), 128);
  L.q_off = o;
  o = align_up(o + (size_t)L.q_rows * ldq * sizeof(T), 128);
  L.prob_off = o;
  o = align_up(o + probs, 128);
  L.tok_off = o;
  o = align_up(o + (size_t)rows_pad * sizeof(long long), 128);
  L.total = o;
  return L;
}

// epi(r, c, v_c, v_c+1) with v = sum_k A[r, k] W[k, :] + bias for every
// r < rows_pad and even c < n_out.  A is in shared memory (row stride lda);
// bias is fp32 (n_out,) in device memory.  W is (K, n_out) row-major for
// fp32; for bf16 it is in mma fragment order: for k-step ks and 8-column
// tile j, lane 4g + t holds W[16 ks + 2t + {0, 1, 8, 9}][8 j + g].
template <typename T, typename Epi>
__device__ __forceinline__ void block_gemm(const T* A, int lda, const void* __restrict__ Wg,
                                           const float* __restrict__ bias, int K, int n_out,
                                           int rows_pad, Epi epi) {
  if constexpr (IsBF16<T>::value) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int mt = rows_pad / 16, ksteps = K / 16, n8 = n_out / 8;
    // work item = (16-wide column panel, run of <= kWarpMTiles row tiles);
    // each weight fragment feeds every row tile of its run
    const int splits = (mt + kWarpMTiles - 1) / kWarpMTiles;
    const int mper = (mt + splits - 1) / splits;
    const int items = (n_out / 16) * splits;
    const uint2* wf = static_cast<const uint2*>(Wg);
    const T* a_lane = A + (size_t)(lane % 16) * lda + (lane / 16) * 8;
    for (int it = warp; it < items; it += kWarps) {
      const int n = it / splits, m0 = (it % splits) * mper;
      const int mcount = mt - m0 < mper ? mt - m0 : mper;
      const uint2* wn = wf + (size_t)(2 * n) * 32 + lane;
      float acc[kWarpMTiles][2][4] = {};
      uint2 b0 = __ldg(wn), b1 = __ldg(wn + 32);
      for (int k = 0; k < ksteps; ++k) {
        uint2 c0 = b0, c1 = b1;
        if (k + 1 < ksteps) {  // next fragment in flight while this one is used
          c0 = __ldg(wn + (size_t)(k + 1) * n8 * 32);
          c1 = __ldg(wn + (size_t)(k + 1) * n8 * 32 + 32);
        }
#pragma unroll
        for (int m = 0; m < kWarpMTiles; ++m) {
          if (m < mcount) {
            uint32_t a[4];
            ldmatrix_x4(a, a_lane + (size_t)(m0 + m) * 16 * lda + k * 16);
            mma_16816(acc[m][0], a, b0.x, b0.y);
            mma_16816(acc[m][1], a, b1.x, b1.y);
          }
        }
        b0 = c0;
        b1 = c1;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n * 16 + j * 8 + 2 * t;
        const float bias0 = __ldg(bias + c), bias1 = __ldg(bias + c + 1);
#pragma unroll
        for (int m = 0; m < kWarpMTiles; ++m) {
          if (m < mcount) {
            const int r = (m0 + m) * 16 + g;
            epi(r, c, acc[m][j][0] + bias0, acc[m][j][1] + bias1);
            epi(r + 8, c, acc[m][j][2] + bias0, acc[m][j][3] + bias1);
          }
        }
      }
    }
  } else {
    const T* W = static_cast<const T*>(Wg);
    const int half = n_out / 2;
    for (int e = threadIdx.x; e < rows_pad * half; e += kThreads) {
      const int r = e / half, c = 2 * (e % half);
      const T* a = A + (size_t)r * lda;
      float acc0 = 0.f, acc1 = 0.f;
      for (int k = 0; k < K; ++k) {
        const float av = to_f(a[k]);
        acc0 = fmaf(av, to_f(W[(size_t)k * n_out + c]), acc0);
        acc1 = fmaf(av, to_f(W[(size_t)k * n_out + c + 1]), acc1);
      }
      epi(r, c, acc0 + bias[c], acc1 + bias[c + 1]);
    }
  }
}

// Region label of token t in window (last_r, last_c) of the rolled grid:
// only the last window row / column straddles the wrap-around.
__device__ __forceinline__ int shift_region(int t, int ws, int cut, bool last_r, bool last_c) {
  return ((last_r && t / ws >= cut) ? 1 : 0) + ((last_c && t % ws >= cut) ? 2 : 0);
}

// The one definition of a logit, for both attention paths: raw dot product
// s of a query in region rq with key `key` in region rk, scaled, plus the
// query's relative-bias row, -100 across shift regions.
__device__ __forceinline__ float logit(float s, float scale, const float* rb_row, int key, int rq,
                                       int rk) {
  return s * scale + __ldg(rb_row + key) - (rk != rq ? 100.f : 0.f);
}

// Logits of query i against keys j < N from raw dot products s[j]; returns
// the row max.
__device__ __forceinline__ float logits_row(float* s, int i, int N, float scale, const float* rb,
                                            int ws, int cut, bool last_r, bool last_c) {
  const int reg_i = shift_region(i, ws, cut, last_r, last_c);
  const float* rbi = rb + (size_t)i * N;
  float m = __int_as_float(0xff800000);  // -inf
  for (int j = 0; j < N; ++j) {
    s[j] = logit(s[j], scale, rbi, j, reg_i, shift_region(j, ws, cut, last_r, last_c));
    m = fmaxf(m, s[j]);
  }
  return m;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bf16 attention of queries 16 mi .. 16 mi + 15 of one (window, head) on
// tensor cores.  base: the window's first qkv row; q / k / v at columns
// h*hd, C + h*hd, 2C + h*hd.  Rows past N (next window or zeroed padding)
// are read but their scores are dropped and their outputs are not stored.
// The output of query i overwrites q_i, which no other query block reads.
__device__ __forceinline__ void attention_bf16(__nv_bfloat16* base, int ldq, int C, int h, int hd,
                                               int N, int mi, float scale, const float* rb,
                                               int ws, int cut, bool last_r, bool last_c) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (N + 15) / 16, kt = hd / 16;
  const bool masked = last_r || last_c;  // only edge windows straddle the wrap
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
  float s[2 * kAttnTiles][4] = {};
#pragma unroll
  for (int jk = 0; jk < kAttnTiles; ++jk) {
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
  const int r0 = masked ? shift_region(q0, ws, cut, last_r, last_c) : 0;
  const int r1 = masked ? shift_region(q1, ws, cut, last_r, last_c) : 0;
  const float* rb0 = rb + (size_t)(q0 < N ? q0 : 0) * N;
  const float* rb1 = rb + (size_t)(q1 < N ? q1 : 0) * N;
  const float ninf = __int_as_float(0xff800000);
  float m0 = ninf, m1 = ninf;
#pragma unroll
  for (int jn = 0; jn < 2 * kAttnTiles; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = jn * 8 + 2 * t + e;
      if (jn < 2 * nt && key < N) {
        const int rk = masked ? shift_region(key, ws, cut, last_r, last_c) : 0;
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
  for (int jn = 0; jn < 2 * kAttnTiles; ++jn) {
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
  uint32_t pa[kAttnTiles][4];
#pragma unroll
  for (int kc = 0; kc < kAttnTiles; ++kc) {
    pa[kc][0] = pack_bf16x2(s[2 * kc][0] * inv0, s[2 * kc][1] * inv0);
    pa[kc][1] = pack_bf16x2(s[2 * kc][2] * inv1, s[2 * kc][3] * inv1);
    pa[kc][2] = pack_bf16x2(s[2 * kc + 1][0] * inv0, s[2 * kc + 1][1] * inv0);
    pa[kc][3] = pack_bf16x2(s[2 * kc + 1][2] * inv1, s[2 * kc + 1][3] * inv1);
  }
  float o[kMaxHeadDim / 8][4] = {};
#pragma unroll
  for (int kc = 0; kc < kAttnTiles; ++kc) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) swin_block_kernel(SwinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.ws * p.ws;
  const SmemLayout L = smem_layout<T>(p.wpb, p.rows_pad, p.ldx, p.ldq, N);
  T* X = reinterpret_cast<T*>(smem + L.x_off);
  T* Q = reinterpret_cast<T*>(smem + L.q_off);
  long long* tok = reinterpret_cast<long long*>(smem + L.tok_off);

  const T* x = static_cast<const T*>(p.x);
  const T* skip = static_cast<const T*>(p.skip);
  T* out = static_cast<T*>(p.out);
  const int C = p.C;
  const int hd = C / p.heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int win0 = blockIdx.x * p.wpb;
  const int per_img = p.n_wh * p.n_ww;

  // 1. element offset of every token's pixel (-1: padding row or window
  //    past the end)
  for (int r = tid; r < p.rows_pad; r += kThreads) {
    long long off = -1;
    const int w = win0 + r / N;
    if (r < p.wpb * N && w < p.n_windows) {
      const int b = w / per_img, rem = w % per_img;
      const int wr = rem / p.n_ww, wc = rem % p.n_ww;
      const int t = r % N;
      const int row = (wr * p.ws + t / p.ws + p.shift) % p.H;
      const int col = (wc * p.ws + t % p.ws + p.shift) % p.W;
      off = (((long long)b * p.H + row) * p.W + col) * C;
    }
    tok[r] = off;
  }
  // qkv rows past rows_pad are only read by padded attention tiles; keep
  // them finite
  for (int e = tid; e < (L.q_rows - p.rows_pad) * p.ldq; e += kThreads)
    Q[(size_t)p.rows_pad * p.ldq + e] = from_f<T>(0.f);
  __syncthreads();

  // 2. gather the windows' tokens (+ skip, rounded as one add in T)
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = C / VEC;
  for (int e = tid; e < p.rows_pad * nvec; e += kThreads) {
    const int r = e / nvec, v = e % nvec;
    const long long off = tok[r];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) {
      val = *reinterpret_cast<const uint4*>(x + off + v * VEC);
      if (skip != nullptr) {
        const uint4 sv = *reinterpret_cast<const uint4*>(skip + off + v * VEC);
        T* a = reinterpret_cast<T*>(&val);
        const T* s = reinterpret_cast<const T*>(&sv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[i] = from_f<T>(to_f(a[i]) + to_f(s[i]));
      }
    }
    *reinterpret_cast<uint4*>(X + (size_t)r * p.ldx + v * VEC) = val;
  }
  __syncthreads();

  // 3. qkv projection
  block_gemm<T>(X, p.ldx, p.wqkv, p.bqkv, C, 3 * C, p.rows_pad,
                [&](int r, int c, float v0, float v1) { store2(Q + (size_t)r * p.ldq + c, v0, v1); });
  __syncthreads();

  // 4. window attention: bf16, one warp per (window, head, 16-query
  //    block); fp32, one warp per (window, head)
  const int cut = p.ws - p.shift;
  const int qblocks = IsBF16<T>::value ? (N + 15) / 16 : 1;
  for (int u = warp; u < p.wpb * p.heads * qblocks; u += kWarps) {
    const int pair = u / qblocks, mi = u % qblocks;
    const int wl = pair / p.heads, h = pair % p.heads;
    const int w = win0 + wl;
    if (w >= p.n_windows) continue;
    const int rem = w % per_img;
    const bool last_r = p.shift > 0 && rem / p.n_ww == p.n_wh - 1;
    const bool last_c = p.shift > 0 && rem % p.n_ww == p.n_ww - 1;
    T* base = Q + (size_t)wl * N * p.ldq;
    const float* rb = p.relbias + (size_t)h * N * N;
    if constexpr (IsBF16<T>::value) {
      attention_bf16(base, p.ldq, C, h, hd, N, mi, p.scale, rb, p.ws, cut, last_r, last_c);
    } else {
      // CUDA cores, one query at a time: lanes over keys, then over dims;
      // the output of query i overwrites q_i, which only this warp reads
      float* pr = reinterpret_cast<float*>(smem + L.prob_off) + warp * N;
      for (int i = 0; i < N; ++i) {
        const T* qi = base + (size_t)i * p.ldq + h * hd;
        for (int j = lane; j < N; j += 32) {
          const T* kj = base + (size_t)j * p.ldq + C + h * hd;
          float s = 0.f;
          for (int d = 0; d < hd; ++d) s = fmaf(to_f(qi[d]), to_f(kj[d]), s);
          pr[j] = s;
        }
        __syncwarp();
        float m = 0.f;
        if (lane == 0) m = logits_row(pr, i, N, p.scale, rb, p.ws, cut, last_r, last_c);
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
          const T* vj = vb + (size_t)j * p.ldq;
          if (lane < hd) o0 = fmaf(pj, to_f(vj[lane]), o0);
          if (lane + 32 < hd) o1 = fmaf(pj, to_f(vj[lane + 32]), o1);
        }
        __syncwarp();
        T* oi = base + (size_t)i * p.ldq + h * hd;
        if (lane < hd) oi[lane] = from_f<T>(o0);
        if (lane + 32 < hd) oi[lane + 32] = from_f<T>(o1);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 5. out projection + residual 1; y1 overwrites x in place
  block_gemm<T>(Q, p.ldq, p.wproj, p.bproj, C, C, p.rows_pad,
                [&](int r, int c, float v0, float v1) {
                  T* xr = X + (size_t)r * p.ldx + c;
                  const float2 res = load2(xr);
                  store2(xr, v0 + res.x, v1 + res.y);
                });
  __syncthreads();

  // 6. fc1 + exact GELU into the qkv buffer
  block_gemm<T>(X, p.ldx, p.wfc1, p.bfc1, C, p.hidden, p.rows_pad,
                [&](int r, int c, float v0, float v1) {
                  store2(Q + (size_t)r * p.ldq + c,
                         0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f)),
                         0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f)));
                });
  __syncthreads();

  // 7. fc2 + residual 2, scattered back to the image
  block_gemm<T>(Q, p.ldq, p.wfc2, p.bfc2, p.hidden, C, p.rows_pad,
                [&](int r, int c, float v0, float v1) {
                  const long long off = tok[r];
                  if (off >= 0) {
                    const float2 res = load2(X + (size_t)r * p.ldx + c);
                    store2(out + off + c, v0 + res.x, v1 + res.y);
                  }
                });
}

template <typename T>
cudaError_t launch_swin_block(SwinArgs p, cudaStream_t stream) {
  const int N = p.ws * p.ws;
  p.ldx = p.C + 8;
  p.ldq = (3 * p.C > p.hidden ? 3 * p.C : p.hidden) + 8;
  if (IsBF16<T>::value && (N > kAttnTiles * 16 || (p.C / p.heads) % 16 ||
                           p.C / p.heads > kMaxHeadDim))
    return cudaErrorInvalidValue;
  const int candidates[3] = {4, 2, 1};
  size_t smem = 0;
  p.wpb = 0;
  for (int i = 0; i < 3; ++i) {
    const int wpb = candidates[i];
    if (wpb * N > kMaxRows) continue;
    const int rows_pad = (int)align_up((size_t)wpb * N, 16);
    const size_t s = smem_layout<T>(wpb, rows_pad, p.ldx, p.ldq, N).total;
    if (s <= kMaxSmem) {
      p.wpb = wpb;
      p.rows_pad = rows_pad;
      smem = s;
      break;
    }
  }
  if (p.wpb == 0) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(swin_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.n_windows + p.wpb - 1) / p.wpb;
  swin_block_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_swin_block_image(int dtype, const void* x, const void* skip,
                                      const void* wqkv, const void* bqkv, const void* wproj,
                                      const void* bproj, const void* wfc1, const void* bfc1,
                                      const void* wfc2, const void* bfc2, const void* relbias,
                                      void* out, int B, int H, int W, int C, int heads,
                                      int hidden, int ws, int shift, float scale, void* stream) {
  using namespace nunif;
  SwinArgs p{};
  p.x = x;
  p.skip = skip;
  p.wqkv = wqkv;
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = wproj;
  p.bproj = static_cast<const float*>(bproj);
  p.wfc1 = wfc1;
  p.bfc1 = static_cast<const float*>(bfc1);
  p.wfc2 = wfc2;
  p.bfc2 = static_cast<const float*>(bfc2);
  p.relbias = static_cast<const float*>(relbias);
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.heads = heads;
  p.hidden = hidden;
  p.ws = ws;
  p.shift = shift;
  p.scale = scale;
  p.n_wh = H / ws;
  p.n_ww = W / ws;
  p.n_windows = B * p.n_wh * p.n_ww;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDtypeBF16 ? launch_swin_block<__nv_bfloat16>(p, s)
                    : dtype == kDtypeF32 ? launch_swin_block<float>(p, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
}
