// T1: Hopper probe of the image strip <-> window relayout inside a kernel.
//
// Replaces tools/microbench_strip.py:strip_call (Pallas kernels
// _pass_kernel and _relayout_kernel).  Both kernels compute out = T(x *
// scale) on a bf16 NHWC image; the grid is the TPU tool's, one block for
// each (rh x cw)-window block of the image.
// - pass: the block streams its pixels through registers in 16-byte vectors.
// - relayout: the block walks its window rows in segments of up to 8
//   windows; a segment's 6 pixel rows are loaded in image order into shared
//   memory, moved into window order (window, token, channel) in a second
//   buffer where the scale is applied, moved back into image order and
//   stored: the TPU kernel's reshape / transpose round trip, done in shared
//   memory in 16-byte pieces.
// What bounds both on the H100: bytes (each element read and written once;
// 2 x 407 MB at 1104 x 1920 x 96).  The question the probe answers is
// whether the two shared-memory passes cost anything beside the copy.  A
// (rh x cw)-window block of the TPU tool (up to 46 x 8 windows, 2.5 MB)
// does not fit in shared memory; only its segments do (2 x 55 KB at C 96).
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kStripThreads = 256;
constexpr int kSegWindows = 8;
constexpr int kVec = 8;  // bf16 a 16-byte piece

struct StripArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  int H, W, C, ws, rh, cw, seg;
  float scale;
};

__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}

__global__ void __launch_bounds__(kStripThreads) strip_pass_kernel(StripArgs p) {
  const int rows = p.rh * p.ws, pieces = p.cw * p.ws * p.C / kVec;
  const int y0 = blockIdx.y * rows, x0 = blockIdx.x * p.cw * p.ws;
  for (int e = threadIdx.x; e < rows * pieces; e += kStripThreads) {
    const int r = e / pieces, v = e % pieces;
    const size_t off = ((size_t)(y0 + r) * p.W + x0) * p.C + (size_t)v * kVec;
    *reinterpret_cast<uint4*>(p.out + off) =
        scale8(*reinterpret_cast<const uint4*>(p.x + off), p.scale);
  }
}

__global__ void __launch_bounds__(kStripThreads) strip_relayout_kernel(StripArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ws = p.ws, N = ws * ws, cv = p.C / kVec;  // 16-byte pieces a pixel
  const int seg_px = p.seg * ws;                      // pixels a segment row
  uint4* A = reinterpret_cast<uint4*>(smem);          // image order [ws][seg_px][cv]
  uint4* B = A + (size_t)ws * seg_px * cv;            // window order [seg][N][cv]
  const int n = ws * seg_px * cv;
  const int y_blk = blockIdx.y * p.rh * ws, x_blk = blockIdx.x * p.cw * ws;
  for (int wr = 0; wr < p.rh; ++wr) {
    for (int s0 = 0; s0 < p.cw; s0 += p.seg) {
      const int y0 = y_blk + wr * ws, x0 = x_blk + s0 * ws;
      for (int e = threadIdx.x; e < n; e += kStripThreads) {  // image order in
        const int i = e / (seg_px * cv), rem = e % (seg_px * cv);
        A[e] = *reinterpret_cast<const uint4*>(p.x + ((size_t)(y0 + i) * p.W + x0) * p.C +
                                               (size_t)rem * kVec);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += kStripThreads) {  // to window order
        const int w = e / (N * cv), t = e / cv % N, c = e % cv;
        B[e] = scale8(A[((size_t)(t / ws) * seg_px + w * ws + t % ws) * cv + c], p.scale);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += kStripThreads) {  // back to image order
        const int i = e / (seg_px * cv), j = e / cv % seg_px, c = e % cv;
        A[e] = B[((size_t)(j / ws) * N + i * ws + j % ws) * cv + c];
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += kStripThreads) {  // image order out
        const int i = e / (seg_px * cv), rem = e % (seg_px * cv);
        *reinterpret_cast<uint4*>(p.out + ((size_t)(y0 + i) * p.W + x0) * p.C +
                                  (size_t)rem * kVec) = A[e];
      }
      __syncthreads();
    }
  }
}

}  // namespace
}  // namespace nunif

// x, out: (1, H, W, C) bf16, H a multiple of rh ws, W of cw ws, C of 8.
// relayout 0: the pass kernel; 1: the relayout round trip.
extern "C" int nunif_strip(int relayout, const void* x, void* out, int H, int W, int C, int ws,
                           int rh, int cw, float scale, void* stream) {
  using namespace nunif;
  if (ws < 1 || rh < 1 || cw < 1 || C % kVec || H % (rh * ws) || W % (cw * ws))
    return (int)cudaErrorInvalidValue;
  StripArgs p{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
              H, W, C, ws, rh, cw, 0, scale};
  p.seg = cw < kSegWindows ? cw : kSegWindows;
  while (cw % p.seg) --p.seg;
  const dim3 grid(W / (cw * ws), H / (rh * ws));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!relayout) {
    strip_pass_kernel<<<grid, kStripThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)ws * p.seg * ws * C * sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(strip_relayout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  strip_relayout_kernel<<<grid, kStripThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}
