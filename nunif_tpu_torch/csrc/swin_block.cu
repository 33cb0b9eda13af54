// K1: one whole Swin-V1 block (norm "none") on an NHWC image, fused.
// K5: the same block on window-ordered tokens (nw, N, C).
//
// K1 replaces nunif_tpu/ops/swin_attention.py:fused_swin_block_image
// (Pallas, kernel _kernel_block_img, body _block_compute); K5 replaces
// fused_swin_block (kernel _kernel_block, the same body), which the JAX
// block module calls under NUNIF_TPU_SWIN_IMG=0.  Per window of ws x ws
// tokens:
//   qkv = x Wqkv + b;  per head softmax(q k^T * scale + relbias [-100 across
//   shift regions]) v;  y1 = attn Wproj + b + x;
//   out = gelu_erf(y1 Wfc1 + b) Wfc2 + b + y1
// with an optional `skip` added to x on the first read (K1 only; K5's
// caller adds it).
//
// K5 differs from K1 only in the token table: token t of window w is row
// (w N + t) of x, and the window's grid position (w mod n_wh n_ww) selects
// the mask: "roll" for the rolled grid, "pad" for a grid padded by shift /
// ws - shift whose keys outside the unpadded image get -100
// (window_attention.cuh).  The TPU kernel pads the window count to a
// multiple of its block with garbage windows; here the last block just
// holds fewer windows.
//
// Shift (K1): the window grid is the cyclically rolled one of the module path
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
#include "window_attention.cuh"

namespace nunif {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 144;     // token rows per block (9 MMA tiles)
constexpr int kWarpMTiles = 5;    // MMA row tiles one warp accumulates
constexpr int kAttnTiles = 3;     // 16-key attention tiles: windows of N <= 48

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
  int windowed;  // K5: x and out are (nw, N, C) window-ordered tokens
  int pad_mode;  // K5: shift_mode "pad" (else the roll regions)
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
__device__ __forceinline__ void dense_gemm(const T* A, int lda, const void* __restrict__ Wg,
                                           const float* __restrict__ bias, int K, int n_out,
                                           int rows_pad, Epi epi) {
  if constexpr (IsBF16<T>::value) {
    block_gemm<T, kWarps, kWarpMTiles>(A, lda * (int)sizeof(T), Wg, bias, K, n_out, rows_pad, epi);
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
  const int tid = threadIdx.x, warp = tid / 32;
  const int win0 = blockIdx.x * p.wpb;
  const int per_img = p.n_wh * p.n_ww;

  // 1. element offset of every token (-1: padding row or window past the
  //    end): its pixel (K1) or its row (K5)
  for (int r = tid; r < p.rows_pad; r += kThreads) {
    long long off = -1;
    const int w = win0 + r / N, t = r % N;
    if (r < p.wpb * N && w < p.n_windows) {
      if (p.windowed) {
        off = ((long long)w * N + t) * C;
      } else {
        const int b = w / per_img, rem = w % per_img;
        const int wr = rem / p.n_ww, wc = rem % p.n_ww;
        const int row = (wr * p.ws + t / p.ws + p.shift) % p.H;
        const int col = (wc * p.ws + t % p.ws + p.shift) % p.W;
        off = (((long long)b * p.H + row) * p.W + col) * C;
      }
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
  dense_gemm<T>(X, p.ldx, p.wqkv, p.bqkv, C, 3 * C, p.rows_pad,
                [&](int r, int c, float v0, float v1) { store2(Q + (size_t)r * p.ldq + c, v0, v1); });
  __syncthreads();

  // 4. window attention: bf16, one warp per (window, head, 16-query
  //    block); fp32, one warp per (window, head)
  const int qblocks = IsBF16<T>::value ? (N + 15) / 16 : 1;
  for (int u = warp; u < p.wpb * p.heads * qblocks; u += kWarps) {
    const int pair = u / qblocks, mi = u % qblocks;
    const int wl = pair / p.heads, h = pair % p.heads;
    const int w = win0 + wl;
    if (w >= p.n_windows) continue;
    const int rem = w % per_img;
    const WindowMask mask =
        p.pad_mode ? pad_mask(p.ws, p.shift, rem / p.n_ww, rem % p.n_ww, p.n_wh, p.n_ww)
                   : roll_mask(p.ws, p.shift, rem / p.n_ww, rem % p.n_ww, p.n_wh, p.n_ww);
    T* base = Q + (size_t)wl * N * p.ldq;
    const float* rb = p.relbias + (size_t)h * N * N;
    if constexpr (IsBF16<T>::value) {
      attention_bf16<kAttnTiles>(base, p.ldq, C, h, hd, N, mi, p.scale, rb, mask);
    } else {
      // the output of query i overwrites q_i, which only this warp reads
      float* pr = reinterpret_cast<float*>(smem + L.prob_off) + warp * N;
      attention_fma(base, p.ldq, C, h, hd, N, p.scale, rb, mask, pr);
    }
  }
  __syncthreads();

  // 5. out projection + residual 1; y1 overwrites x in place
  dense_gemm<T>(Q, p.ldq, p.wproj, p.bproj, C, C, p.rows_pad,
                [&](int r, int c, float v0, float v1) {
                  T* xr = X + (size_t)r * p.ldx + c;
                  const float2 res = load2(xr);
                  store2(xr, v0 + res.x, v1 + res.y);
                });
  __syncthreads();

  // 6. fc1 + exact GELU into the qkv buffer
  dense_gemm<T>(X, p.ldx, p.wfc1, p.bfc1, C, p.hidden, p.rows_pad,
                [&](int r, int c, float v0, float v1) {
                  store2(Q + (size_t)r * p.ldq + c,
                         0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f)),
                         0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f)));
                });
  __syncthreads();

  // 7. fc2 + residual 2, scattered back to the image (K1) or the token rows
  //    (K5)
  dense_gemm<T>(Q, p.ldq, p.wfc2, p.bfc2, p.hidden, C, p.rows_pad,
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

SwinArgs swin_args(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const void* wfc1, const void* bfc1, const void* wfc2,
                   const void* bfc2, const void* relbias, void* out, int C, int heads,
                   int hidden, int ws, int shift, float scale) {
  SwinArgs p{};
  p.x = x;
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
  p.C = C;
  p.heads = heads;
  p.hidden = hidden;
  p.ws = ws;
  p.shift = shift;
  p.scale = scale;
  return p;
}

int launch_swin(int dtype, const SwinArgs& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDtypeBF16 ? launch_swin_block<__nv_bfloat16>(p, s)
                    : dtype == kDtypeF32 ? launch_swin_block<float>(p, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
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
  SwinArgs p = swin_args(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, relbias, out, C,
                         heads, hidden, ws, shift, scale);
  p.skip = skip;
  p.B = B;
  p.H = H;
  p.W = W;
  p.n_wh = H / ws;
  p.n_ww = W / ws;
  p.n_windows = B * p.n_wh * p.n_ww;
  return launch_swin(dtype, p, stream);
}

// K5: x and out are (nw, N, C), nw a multiple of n_wh * n_ww; pad_mode
// selects shift_mode "pad" (else "roll").
extern "C" int nunif_swin_block_windows(int dtype, const void* x, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* wfc1, const void* bfc1, const void* wfc2,
                                        const void* bfc2, const void* relbias, void* out, int nw,
                                        int C, int heads, int hidden, int ws, int shift,
                                        int pad_mode, int n_wh, int n_ww, float scale,
                                        void* stream) {
  using namespace nunif;
  if (n_wh < 1 || n_ww < 1 || nw < 1 || nw % (n_wh * n_ww) || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  SwinArgs p = swin_args(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, relbias, out, C,
                         heads, hidden, ws, shift, scale);
  p.windowed = 1;
  p.pad_mode = pad_mode != 0;
  p.B = nw / (n_wh * n_ww);
  p.H = n_wh * ws;
  p.W = n_ww * ws;
  p.n_wh = n_wh;
  p.n_ww = n_ww;
  p.n_windows = nw;
  return launch_swin(dtype, p, stream);
}
