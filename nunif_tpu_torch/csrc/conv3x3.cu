// K2: 3x3 VALID conv + bias + optional leaky-ReLU + crop on an NHWC image,
// as an implicit GEMM.
//
// Replaces nunif_tpu/ops/conv3x3.py:stem_conv3x3 (Pallas, kernel _kernel).
// out[b, y, x, :] = act(sum_{di,dj,ci} in[b, y+crop+di, x+crop+dj, ci]
//                       * w[(di*3+dj)*Cin + ci, :] + bias)
// with w the (3, 3, Cin, Cout) kernel viewed as a (9 Cin, Cout) matrix.
//
// What bounds it on the H100: on swin_unet_2x's main path (patch_conv1,
// (1, 1118, 1934, 48) -> (1, 1104, 1920, 96) bf16) it reads ~207 MB, writes
// ~407 MB and does ~175 GFLOP: ~0.18 ms of HBM traffic against ~0.18 ms of
// dense bf16 tensor-core time, so it sits near the ridge and both sides
// count.  Design: a block owns a 2 x 64 output tile, loads its 4 x 66 input
// halo (all Cin channels) into shared memory once, and forms the 9 Cin
// im2col columns there: the A tile of a (tap, 16-channel) k-step is a
// 16-pixel run of one halo row (pixel stride Cin), which ldmatrix reads
// straight out of the halo, so no column tensor ever exists.  Weight
// fragments arrive pre-arranged (one 8-byte load per lane, L2-resident) and
// feed mma.sync m16n8k16 with fp32 accumulation; bias, leaky-ReLU, rounding
// and the crop act on the accumulators in registers.  Ragged edges are
// masked here (halo loads zero-fill past H / W, stores stop at Ho / Wo), so
// the TPU strip constraint (H - 2 - 2 crop) % 8 == 0 does not apply.  The
// fp32 variant runs the same tiling on CUDA cores with FMA, never rounding
// to bf16 or TF32.
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kConvThreads = 128;
constexpr int kTileRows = 2;
constexpr int kTileCols = 64;
constexpr int kHaloRows = kTileRows + 2;
constexpr int kHaloCols = kTileCols + 2;
constexpr int kNChunk = 4;  // 8-wide output-channel tiles per accumulator pass
static_assert(kConvThreads == kTileRows * kTileCols, "fp32 path: one thread per pixel");
static_assert(kConvThreads / 32 == kTileRows * (kTileCols / 32), "bf16 path: 32 px per warp");

struct ConvArgs {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  int B, H, W, Cin, Cout, Ho, Wo, crop, has_slope;
  float slope;
};

__host__ __device__ inline size_t halo_bytes(int cin, size_t elem) {
  return align_up((size_t)kHaloRows * kHaloCols * cin * elem, 128);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads) stem_conv3x3_kernel(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  T* out = static_cast<T*>(p.out);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kTileRows, ox0 = blockIdx.x * kTileCols;
  const int iy0 = oy0 + p.crop, ix0 = ox0 + p.crop;

  constexpr int VEC = 16 / sizeof(T);
  const int nvec = p.Cin / VEC;
  for (int e = threadIdx.x; e < kHaloRows * kHaloCols * nvec; e += kConvThreads) {
    const int v = e % nvec, pix = e / nvec;
    const int iy = iy0 + pix / kHaloCols, ix = ix0 + pix % kHaloCols;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (iy < p.H && ix < p.W)
      val = *reinterpret_cast<const uint4*>(x + (((size_t)b * p.H + iy) * p.W + ix) * p.Cin +
                                            v * VEC);
    *reinterpret_cast<uint4*>(halo + (size_t)pix * p.Cin + v * VEC) = val;
  }
  __syncthreads();

  if constexpr (IsBF16<T>::value) {
    // warp -> two 16-pixel row tiles (one output row, columns c0 and
    // c0 + 16) x all Cout, kNChunk 8-channel tiles at a time; the A tile
    // of a (tap, 16-channel) k-step is 16 consecutive halo pixels, read by
    // ldmatrix straight out of the halo
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r = warp / 2, c0 = (warp % 2) * 32;
    const int oy = oy0 + r;
    const int n8 = p.Cout / 8, kc_per_tap = p.Cin / 16, ksteps = 9 * kc_per_tap;
    const uint2* wf = static_cast<const uint2*>(p.w);
    for (int j0 = 0; j0 < n8; j0 += kNChunk) {
      float acc[2][kNChunk][4] = {};
      for (int ks = 0; ks < ksteps; ++ks) {
        const int tap = ks / kc_per_tap, kc = ks % kc_per_tap;
        uint2 bf[kNChunk];
#pragma unroll
        for (int j = 0; j < kNChunk; ++j)
          if (j0 + j < n8) bf[j] = __ldg(wf + ((size_t)ks * n8 + j0 + j) * 32 + lane);
        const T* hp = halo + ((size_t)(r + tap / 3) * kHaloCols + c0 + tap % 3 + lane % 16) * p.Cin +
                      kc * 16 + (lane / 16) * 8;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t a[4];
          ldmatrix_x4(a, hp + (size_t)i * 16 * p.Cin);
#pragma unroll
          for (int j = 0; j < kNChunk; ++j)
            if (j0 + j < n8) mma_16816(acc[i][j], a, bf[j].x, bf[j].y);
        }
      }
#pragma unroll
      for (int j = 0; j < kNChunk; ++j) {
        if (j0 + j >= n8) continue;
        const int c = (j0 + j) * 8 + 2 * t;
        const float b0 = __ldg(p.bias + c), b1 = __ldg(p.bias + c + 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int hrow = 0; hrow < 2; ++hrow) {
            const int ox = ox0 + c0 + i * 16 + g + 8 * hrow;
            if (oy < p.Ho && ox < p.Wo) {
              float y0 = acc[i][j][2 * hrow] + b0, y1 = acc[i][j][2 * hrow + 1] + b1;
              if (p.has_slope) {
                if (y0 < 0.f) y0 *= p.slope;
                if (y1 < 0.f) y1 *= p.slope;
              }
              store2(out + (((size_t)b * p.Ho + oy) * p.Wo + ox) * p.Cout + c, y0, y1);
            }
          }
        }
      }
    }
  } else {
    const int r = threadIdx.x / kTileCols, c = threadIdx.x % kTileCols;
    const int oy = oy0 + r, ox = ox0 + c;
    if (oy < p.Ho && ox < p.Wo) {
      T* o = out + (((size_t)b * p.Ho + oy) * p.Wo + ox) * p.Cout;
      for (int co = 0; co < p.Cout; ++co) {
        float acc = 0.f;
        for (int tap = 0; tap < 9; ++tap) {
          const T* hp = halo + ((size_t)(r + tap / 3) * kHaloCols + c + tap % 3) * p.Cin;
          const T* wp = w + (size_t)tap * p.Cin * p.Cout + co;
          for (int ci = 0; ci < p.Cin; ++ci) acc = fmaf(hp[ci], wp[(size_t)ci * p.Cout], acc);
        }
        float y = acc + p.bias[co];
        if (p.has_slope && y < 0.f) y *= p.slope;
        o[co] = y;
      }
    }
  }
}

template <typename T>
cudaError_t launch_stem_conv3x3(ConvArgs p, cudaStream_t stream) {
  const size_t smem = halo_bytes(p.Cin, sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(stem_conv3x3_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Wo + kTileCols - 1) / kTileCols, (p.Ho + kTileRows - 1) / kTileRows, p.B);
  stem_conv3x3_kernel<T><<<grid, kConvThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_stem_conv3x3(int dtype, const void* x, const void* w, const void* bias,
                                  void* out, int B, int H, int W, int Cin, int Cout, int crop,
                                  int has_slope, float slope, void* stream) {
  using namespace nunif;
  ConvArgs p{};
  p.x = x;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.Ho = H - 2 - 2 * crop;
  p.Wo = W - 2 - 2 * crop;
  p.crop = crop;
  p.has_slope = has_slope;
  p.slope = slope;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDtypeBF16 ? launch_stem_conv3x3<__nv_bfloat16>(p, s)
                    : dtype == kDtypeF32 ? launch_stem_conv3x3<float>(p, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
}
