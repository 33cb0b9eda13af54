// K3: horizontal bilinear backward warp with border padding, NHWC.
//
// Replaces nunif_tpu/modules/grid_sample.py:_warp_x_bounded_pallas (Pallas,
// body _warp_x_kernel).  out[b, y, x, c] for gx = clip(x + delta[b, y, x],
// 0, W - 1), x0 = floor(gx), t = gx - x0:
//   (1 - t) * in[b, y, x0, c] + t * in[b, y, min(x0 + 1, W - 1), c]
// bf16 input, fp32 arithmetic and output.
//
// The TPU kernel sums 2S + 1 hat-weighted shifted copies of an edge-padded
// strip (S = max_shift + 1) because the TPU has no fast gather; every term
// but the two taps around gx has weight 0, so a direct two-tap gather gives
// the same values.  It multiplies and adds with the twin's roundings (no
// fused multiply-add), taking the x0 tap first as the offset sum does.
//
// What bounds it on the H100: memory.  Per pixel it reads 2 C bytes of x and
// 4 bytes of delta and writes 4 C bytes; at the main path's (16, 1080, 1920,
// 3) that is ~0.73 GB, a floor of ~0.22 ms at 3.35 TB/s.  Design: one thread
// per output pixel, so delta reads and output writes are coalesced across a
// warp; the two taps lie within max_shift + 1 pixels of the thread's own
// column, so neighbouring threads read the same cache lines of x from L1.
// No gx tensor and no padded copy of x is ever written.
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kWarpThreads = 256;

template <int C>
__global__ void __launch_bounds__(kWarpThreads)
    warp_x_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ delta,
                  float* __restrict__ out, int W, long long n_pix) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= n_pix) return;
  const int col = (int)(i % W);
  const long long row = i - col;  // pixel index of column 0 of this row
  float gx = __fadd_rn((float)col, __ldg(delta + i));
  gx = fminf(fmaxf(gx, 0.f), (float)(W - 1));
  const float x0f = floorf(gx);
  const float t = __fsub_rn(gx, x0f);
  const float w0 = __fsub_rn(1.f, t);
  const int x0 = (int)x0f;
  const int x1 = x0 + 1 < W ? x0 + 1 : W - 1;
  const __nv_bfloat16* p0 = x + (row + x0) * C;
  const __nv_bfloat16* p1 = x + (row + x1) * C;
  float* o = out + i * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    o[c] = __fadd_rn(__fmul_rn(__bfloat162float(p0[c]), w0),
                     __fmul_rn(__bfloat162float(p1[c]), t));
}

template <int C>
cudaError_t launch_warp(const void* x, const void* delta, void* out, int W, long long n_pix,
                        cudaStream_t stream) {
  const long long blocks = (n_pix + kWarpThreads - 1) / kWarpThreads;
  warp_x_kernel<C><<<(unsigned)blocks, kWarpThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(delta),
      static_cast<float*>(out), W, n_pix);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_warp_x_bounded(const void* x, const void* delta, void* out, int B, int H,
                                    int W, int C, void* stream) {
  using namespace nunif;
  const long long n_pix = (long long)B * H * W;
  if (n_pix <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch_warp<1>(x, delta, out, W, n_pix, s);
    case 2: return (int)launch_warp<2>(x, delta, out, W, n_pix, s);
    case 3: return (int)launch_warp<3>(x, delta, out, W, n_pix, s);
    case 4: return (int)launch_warp<4>(x, delta, out, W, n_pix, s);
    case 5: return (int)launch_warp<5>(x, delta, out, W, n_pix, s);
    case 6: return (int)launch_warp<6>(x, delta, out, W, n_pix, s);
    case 7: return (int)launch_warp<7>(x, delta, out, W, n_pix, s);
    case 8: return (int)launch_warp<8>(x, delta, out, W, n_pix, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
