// K4: (shifted-)window attention on projected qkv, with relative position
// bias and the roll wrap mask.
// K6: the same attention on qkv and out in image layout.
//
// Replaces nunif_tpu/ops/swin_attention.py:fused_window_attention (Pallas,
// kernel _kernel), which ShiftedWindowAttention calls for every Swin block
// with a LayerNorm (nunif_tpu/modules/attention.py:133-146).  qkv is
// (nw, N, 3C) with the window order (batch, window row, window column) of
// the rolled image, already projected; per head h
//   out[w, i, h] = softmax_j(q_i . k_j * scale + bias[h, i, j]
//                             [-100 across wrap regions]) v_j
// with fp32 scores and softmax, the normalised probabilities rounded to the
// compute type before P V, fp32 accumulation and one rounding of the output.
// The mask is computed from the window's grid position, never stored
// (window_attention.cuh).  The TPU kernel's window packing (128 // N
// windows per MXU pass, block-diagonal -inf) is a trick for the 128-wide
// MXU and has no counterpart here.
//
// What bounds it on the H100: per token it reads 3C and writes C values and
// does 4 N C multiply-adds (Q K^T and P V), 144 flops a byte at N = 36 in
// bf16, below the ridge of ~295: memory-bound.  One 540p frame of
// swin_unet_4xl moves ~7.4 GB through it (~2.2 ms at 3.35 TB/s).  Design: a
// block of 8 warps owns one window and a group of heads whose q, k and v
// columns are at most 192 wide each (all 12 heads at C = 192, 6 at C = 384),
// so a block stages ~41 KB (bf16) and four blocks fit an SM; cp.async copies
// the rows in 16-byte pieces, all in flight at once, and the padding rows of
// the last 16-row MMA tile are zero-filled.  The attention itself is K1's
// (window_attention.cuh): one warp per (head, 16-query block), Q K^T and
// P V on mma.sync m16n8k16 with the scores and softmax in registers.  The
// output overwrites q in shared memory and leaves in 16-byte stores.
// The fp32 variant keeps the data flow with FMA loops (attention_fma).
// Windows of up to 64 tokens (window 8; imagenet swin_t's window 7 gives
// N = 49, head dim 32): the bf16 attention is instantiated with 3 key tiles
// for N <= 48 and 4 for 48 < N <= 64, so window 6 keeps its registers.
//
// K6 replaces nunif_tpu/ops/swin_attention.py:fused_window_attention_image
// (Pallas, kernel _kernel_img): qkv (B, H, W, 3C), already rolled, in;
// out (B, H, W, C).  Token t of window (b, wr, wc) is pixel (b, wr ws +
// t / ws, wc ws + t % ws): the block stages its window's six 6-pixel row
// segments with the same cp.async copies and stores the output at the same
// pixels, so no window partition or reverse touches device memory.  The
// roll mask comes from (wr, wc).  The TPU kernel's sublane transposes,
// 128 // N window packing and W chunking have no counterpart here.
#include "common.cuh"
#include "window_attention.cuh"

namespace nunif {
namespace {

constexpr int kWaThreads = 256;
constexpr int kWaWarps = kWaThreads / 32;
constexpr int kMaxGroupCols = 192;  // columns of q (and of k, v) a block stages

struct WinArgs {
  const void* qkv;
  const float* relbias;  // (heads, N, N)
  void* out;
  int nw, N, C, heads, hd, ws, shift, n_wh, n_ww;
  int image;  // K6: qkv and out in image layout (B, n_wh ws, n_ww ws, .)
  float scale;
  int group;  // heads per block
  int rows;   // staged rows: N, rounded up to 16 for bf16 (MMA tiles)
  int ld;     // shared-memory row stride in elements: 3 * group * hd + pad
};

template <typename T>
__host__ __device__ size_t wa_smem_bytes(const WinArgs& p) {
  const size_t rows = (size_t)p.rows * p.ld * sizeof(T);
  const size_t probs = IsBF16<T>::value ? 0 : (size_t)kWaWarps * p.N * sizeof(float);
  return align_up(rows, 128) + probs;
}

// Row of token t of window w in a tensor of `width` values a token.
__device__ __forceinline__ long long token_offset(const WinArgs& p, int w, int t, int width) {
  if (!p.image) return ((long long)w * p.N + t) * width;
  const int per_img = p.n_wh * p.n_ww, rem = w % per_img;
  const int row = rem / p.n_ww * p.ws + t / p.ws, col = rem % p.n_ww * p.ws + t % p.ws;
  return (((long long)(w / per_img) * p.n_wh * p.ws + row) * p.n_ww * p.ws + col) * width;
}

// Tiles: the bf16 attention's 16-key tiles (N <= 16 Tiles); unused for fp32.
template <typename T, int Tiles>
__global__ void __launch_bounds__(kWaThreads) window_attn_kernel(WinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  const int groups = p.heads / p.group;
  const int w = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int N = p.N, C = p.C, cg = p.group * p.hd;
  const int warp = threadIdx.x / 32;

  // 1. stage q, k and v of this head group: shared row r holds q at
  //    columns 0 .. cg, k at cg .., v at 2 cg ..; rows N .. rows-1 are zero
  constexpr int VEC = 16 / sizeof(T);
  const int vseg = cg / VEC;
  const T* src = static_cast<const T*>(p.qkv) + grp * cg;
  for (int e = threadIdx.x; e < p.rows * 3 * vseg; e += kWaThreads) {
    const int r = e / (3 * vseg), rem = e % (3 * vseg);
    const int seg = rem / vseg, v = rem % vseg;
    const bool ok = r < N;
    cp_async16(S + (size_t)r * p.ld + seg * cg + v * VEC,
               ok ? src + token_offset(p, w, r, 3 * C) + seg * C + v * VEC : src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. attention of every head of the group
  const int rem = w % (p.n_wh * p.n_ww);
  const WindowMask mask = roll_mask(p.ws, p.shift, rem / p.n_ww, rem % p.n_ww, p.n_wh, p.n_ww);
  const float* rb = p.relbias + (size_t)grp * p.group * N * N;
  if constexpr (IsBF16<T>::value) {
    const int qblocks = (N + 15) / 16;
    for (int u = warp; u < p.group * qblocks; u += kWaWarps) {
      const int h = u / qblocks, mi = u % qblocks;
      attention_bf16<Tiles>(S, p.ld, cg, h, p.hd, N, mi, p.scale, rb + (size_t)h * N * N,
                            mask);
    }
  } else {
    float* pr = reinterpret_cast<float*>(smem + align_up((size_t)p.rows * p.ld * sizeof(T), 128)) +
                warp * N;
    for (int h = warp; h < p.group; h += kWaWarps)
      attention_fma(S, p.ld, cg, h, p.hd, N, p.scale, rb + (size_t)h * N * N, mask, pr);
  }
  __syncthreads();

  // 3. the output (in q's columns) to token r's row of out, columns
  //    grp * cg ..
  T* out = static_cast<T*>(p.out) + grp * cg;
  for (int e = threadIdx.x; e < N * vseg; e += kWaThreads) {
    const int r = e / vseg, v = e % vseg;
    *reinterpret_cast<uint4*>(out + token_offset(p, w, r, C) + v * VEC) =
        *reinterpret_cast<const uint4*>(S + (size_t)r * p.ld + v * VEC);
  }
}

template <typename T>
cudaError_t launch_window_attn(WinArgs p, cudaStream_t stream) {
  const int vec = 16 / (int)sizeof(T);
  if (p.N < 1 || p.N > kMaxAttnTiles * 16 || p.heads < 1 || p.C % p.heads || p.hd % 16 ||
      p.hd > kMaxHeadDim || p.shift < 0 || p.shift >= p.ws || p.n_wh < 1 || p.n_ww < 1 ||
      p.nw % (p.n_wh * p.n_ww))
    return cudaErrorInvalidValue;
  // the largest divisor of heads whose columns fit kMaxGroupCols
  p.group = 1;
  for (int g = p.heads; g >= 1; --g) {
    if (p.heads % g == 0 && g * p.hd <= kMaxGroupCols) {
      p.group = g;
      break;
    }
  }
  if ((p.group * p.hd) % vec) return cudaErrorInvalidValue;
  p.rows = IsBF16<T>::value ? (p.N + 15) / 16 * 16 : p.N;
  p.ld = 3 * p.group * p.hd + vec;  // +16 bytes: conflict-free ldmatrix rows
  const size_t smem = wa_smem_bytes<T>(p);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  auto kernel = window_attn_kernel<T, 3>;
  if constexpr (IsBF16<T>::value) {
    if (p.N > 48) kernel = window_attn_kernel<T, 4>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.nw * (p.heads / p.group);
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

WinArgs win_args(const void* qkv, const void* relbias, void* out, int nw, int N, int C,
                 int heads, int ws, int shift, int n_wh, int n_ww, float scale) {
  WinArgs p{};
  p.qkv = qkv;
  p.relbias = static_cast<const float*>(relbias);
  p.out = out;
  p.nw = nw;
  p.N = N;
  p.C = C;
  p.heads = heads;
  p.hd = heads > 0 ? C / heads : 0;
  p.ws = ws;
  p.shift = shift;
  p.n_wh = n_wh;
  p.n_ww = n_ww;
  p.scale = scale;
  return p;
}

int launch_win(int dtype, const WinArgs& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDtypeBF16 ? launch_window_attn<__nv_bfloat16>(p, s)
                    : dtype == kDtypeF32 ? launch_window_attn<float>(p, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_window_attn(int dtype, const void* qkv, const void* relbias, void* out, int nw,
                                 int N, int C, int heads, int ws, int shift, int n_wh, int n_ww,
                                 float scale, void* stream) {
  using namespace nunif;
  return launch_win(dtype, win_args(qkv, relbias, out, nw, N, C, heads, ws, shift, n_wh, n_ww,
                                    scale), stream);
}

// K6: qkv (B, H, W, 3C) and out (B, H, W, C), H and W multiples of ws.
extern "C" int nunif_window_attn_image(int dtype, const void* qkv, const void* relbias, void* out,
                                       int B, int H, int W, int C, int heads, int ws, int shift,
                                       float scale, void* stream) {
  using namespace nunif;
  if (ws < 1 || B < 1 || H % ws || W % ws) return (int)cudaErrorInvalidValue;
  WinArgs p = win_args(qkv, relbias, out, B * (H / ws) * (W / ws), ws * ws, C, heads, ws, shift,
                       H / ws, W / ws, scale);
  p.image = 1;
  return launch_win(dtype, p, stream);
}
