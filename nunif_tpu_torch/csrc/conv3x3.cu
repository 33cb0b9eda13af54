// K2: 3x3 VALID conv + bias + optional leaky-ReLU + crop on an NHWC image,
// as an implicit GEMM.
//
// Replaces nunif_tpu/ops/conv3x3.py:stem_conv3x3 (Pallas, kernel _kernel).
// out[b, y, x, :] = act(sum_{di,dj,ci} in[b, y+crop+di, x+crop+dj, ci]
//                       * w[(di*3+dj)*Cin + ci, :] + bias)
// with w the (3, 3, Cin, Cout) kernel viewed as a (9 Cin, Cout) matrix;
// fp32 accumulator, fp32 bias, one rounding to the output dtype.
//
// What bounds it on the H100.  swin_unet_2x's patch_conv1, (1, 1118, 1934,
// 48) -> (1, 1104, 1920, 96) bf16, reads ~207 MB, writes ~407 MB and does
// ~176 GFLOP: ~0.18 ms of HBM traffic against ~0.18 ms of dense bf16
// tensor-core time.  swin_unet_4xl's, (1, 590, 974, 96) -> (1, 576, 960,
// 192), moves ~0.32 GB (~0.10 ms) for ~184 GFLOP (~0.19 ms): bound by the
// tensor cores.  So the design feeds the tensor cores from shared memory
// and reads each input and weight byte from L2 / HBM as few times as it can.
//
// bf16 design (stem_conv3x3_wgmma):
// - Column groups.  Cout is cut into groups of NB output channels (NB = 96
//   where Cout is a multiple of 96, else 48, 32 or 16: the widths
//   wgmma.cuh writes out); a block owns one group.  The wrapper packs the
//   weights once per weight load (ops/conv3x3.py:pack_stem_weights) as
//   (Cout / NB, 9 Cin / 16, NB / 8, 2, 8, 8): element [h, ks, nb, kb, r, c]
//   is w[16 ks + 8 kb + c][NB h + 8 nb + r], i.e. for every k16 step the
//   K-major, unswizzled core matrices that wgmma reads B from (LBO 128 B
//   along K, SBO 256 B along N), one group contiguous.  (32-, 64- and
//   128-byte swizzled layouts of B measured the same or slower.)
// - Weights resident.  The grid is persistent: as many blocks as fit on
//   the 132 SMs (the occupancy API decides: two a SM at 48 -> 96, one at
//   96 -> 192), split evenly over the column groups.  Each block copies its
//   group's weights into shared memory once, with cp.async.bulk signalling
//   an mbarrier, then walks a contiguous run of output tiles.  96 -> 192
//   needs 331 KB of weights, more than a block's 227 KB: a block owns one
//   96-channel half (166 KB) rather than streaming the taps through a ring,
//   because a ring would re-read 331 KB from L2 for every 64-pixel tile
//   (~2.9 GB a launch), while the halves only read the input twice
//   (~0.22 GB, mostly L2 hits when the two halves run side by side).
// - Tiles and the halo ring.  A tile is one output row of 64 pixels (the
//   wgmma M) by NB channels, for one warpgroup (128 threads).  A block
//   walks down a 64-column strip, so consecutive tiles share two of their
//   three input rows: the halo lives in a ring of 4 rows of 66 pixels (3 in
//   use, 1 in flight); while tile y computes, cp.async brings input row
//   y + 3 (16-byte copies, zero-filled past W).  A halo row is stored as
//   Cin / 8 planes of 8 channels, 16 bytes a pixel, which is wgmma's
//   unswizzled K-major A layout for any run of 64 pixels: core matrices of
//   8 pixels x 8 channels are 128 contiguous bytes (SBO 128 B), one plane
//   leads to the next 8 channels (LBO 1,056 B).  Shared memory a block:
//   48 -> 96: 82,944 B of weights + 4 x 6,336 B of halo = 105.8 KB (two
//   blocks a SM); 96 -> 192: 165,888 + 4 x 12,672 = 211.5 KB.
// - wgmma with A from shared memory.  Each k16 step (tap, 16 channels) is
//   one wgmma.mma_async m64nNBk16 whose A descriptor points at the halo
//   row of the tap, shifted by the tap's column (16 bytes a pixel), and
//   whose B descriptor points at the resident weights; a tile's 9 Cin / 16
//   steps are issued back to back and waited for once.  Each A element is
//   read once per k-step (the mma.sync kernel this replaced re-read it for
//   every 32 output channels).  Accumulators: NB / 2 fp32 registers a
//   thread (48 at NB = 96).
//   Planned otherwise, and dropped after a trial on the H100: A from
//   registers (each warp's 16 rows loaded by ldmatrix in mma.m16n8k16's
//   fragment layout, so the tap shifts need no descriptor).  Each such
//   wgmma kept its warps from issuing the next step until it had run,
//   whatever the wait depth (1 to 3 in flight), so the chain ran one
//   instruction at a time, several times its tensor-core work, and the
//   kernel lost to cuDNN at 96 -> 192.  A from shared memory removes the
//   register dependency, and the plane layout makes any tap shift a valid
//   descriptor.
// - Epilogue in registers: bias (fp32), leaky-ReLU and one bf16 rounding;
//   a quad of lanes then transposes its 32-bit words (four shuffles for
//   four 8-channel chunks), so each lane stores 16 contiguous bytes and a
//   quad a 64-byte run of one pixel, masked at Wo.  Ragged H and W are
//   handled here, so the TPU strip constraint (H - 2 - 2 crop) % 8 == 0
//   does not apply.
// Registers (`-Xptxas -v`, which chip_smoke.py prints): 125 at NB = 96, 72
// at 48, 48 at 32, 40 at 16, no spills; one block of 128 threads needs far
// fewer than the SM holds, so shared memory alone sets the blocks a SM.
//
// The fp32 variant (stem_conv3x3_f32) keeps the earlier tiling on CUDA
// cores with FMA, never rounding to bf16 or TF32: a block owns a 2 x 64
// output tile and its 4 x 66 halo.
#include "common.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

struct ConvArgs {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  int B, H, W, Cin, Cout, Ho, Wo, crop, has_slope;
  float slope;
};

__device__ __forceinline__ float act(float v, const ConvArgs& p) {
  return p.has_slope && v < 0.f ? v * p.slope : v;
}

// ---------------------------------------------------------------- bf16
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kTileCols = 64;    // output pixels a tile: the wgmma M
constexpr int kHaloCols = kTileCols + 2;
constexpr int kRingRows = 4;     // 3 halo rows in use + 1 in flight
constexpr uint32_t kPlaneBytes = kHaloCols * 16;  // 8 channels of a halo row
constexpr uint32_t kBulkChunk = 32768;

// a halo row: Cin / 8 planes, plane c holding channels 8 c .. 8 c + 7 of
// pixels 0 .. 65 at 16 bytes a pixel
__host__ __device__ inline uint32_t wg_row_bytes(int cin) { return cin / 8 * kPlaneBytes; }
// one column group of packed weights: 9 Cin / 16 k16 steps of NB x 16
__host__ __device__ inline uint32_t wg_weight_bytes(int cin, int nb) { return 9 * cin * nb * 2; }

// the weights, then the halo ring, then the mbarrier
__host__ inline size_t wg_smem_bytes(int cin, int nb) {
  return align_up(wg_weight_bytes(cin, nb), 128) + kRingRows * wg_row_bytes(cin) +
         sizeof(uint64_t);
}

// one input row (66 pixels from ix0, all Cin channels) into a ring slot,
// asynchronously; pixels past W read as zero
__device__ __forceinline__ void load_halo_row(unsigned char* dst, const __nv_bfloat16* x,
                                              const ConvArgs& p, int b, int iy, int ix0) {
  const int nvec = p.Cin / 8;
  const __nv_bfloat16* row = x + ((size_t)b * p.H + iy) * p.W * p.Cin;
  for (int e = threadIdx.x; e < kHaloCols * nvec; e += kWgThreads) {
    const int pix = e / nvec, v = e - pix * nvec;
    const int ix = ix0 + pix;
    const bool in = ix < p.W;
    cp_async16(dst + v * kPlaneBytes + pix * 16, row + (size_t)(in ? ix : 0) * p.Cin + v * 8, in);
  }
}

template <int NB>
__global__ void __launch_bounds__(kWgThreads) stem_conv3x3_wgmma(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kc_per_tap = p.Cin / 16, ksteps = 9 * kc_per_tap;
  const uint32_t wbytes = wg_weight_bytes(p.Cin, NB), row_bytes = wg_row_bytes(p.Cin);
  unsigned char* wsm = smem;
  unsigned char* ring = wsm + align_up(wbytes, 128);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kRingRows * row_bytes);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int n0 = blockIdx.y * NB;

  // this block's column group of the packed weights -> shared memory, once
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, wbytes);
    const unsigned char* src =
        static_cast<const unsigned char*>(p.w) + (size_t)blockIdx.y * wbytes;
    for (uint32_t off = 0; off < wbytes; off += kBulkChunk) {
      const uint32_t left = wbytes - off;
      bulk_copy_g2s(wsm + off, src + off, left < kBulkChunk ? left : kBulkChunk, bar);
    }
  }

  // tiles in (b, 64-column strip, output row) order; this block's share
  const int strips_per_image = (p.Wo + kTileCols - 1) / kTileCols;
  const long long tiles = (long long)p.B * strips_per_image * p.Ho;
  const long long first = tiles * blockIdx.x / gridDim.x;
  const long long last = tiles * (blockIdx.x + 1) / gridDim.x;
  // descriptors, unswizzled K-major: B one k16 step of the packed weights
  // (LBO 128 B along K, SBO 256 B between 8-column groups); A a 64-pixel
  // run of one halo row, core matrices of 8 pixels x 8 channels 16 B a pixel
  // (SBO 128 B between 8-pixel groups), one plane to the next 8 channels
  // (LBO)
  const uint64_t b_desc0 = wgmma_desc(smem_addr(wsm), 128, 256);
  constexpr uint32_t b_step = NB * 32 >> 4;  // one k16 step, 16-byte units
  const uint64_t a_desc0 = wgmma_desc(smem_addr(ring), kPlaneBytes, 128);
  const uint32_t a_chunk_step = 2 * kPlaneBytes >> 4;  // 16 channels on
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  bool weights_ready = false;
  long long strip = -1;
  for (long long tile = first; tile < last; ++tile) {
    const long long s = tile / p.Ho;
    const int y = (int)(tile - s * p.Ho);
    const int b = (int)(s / strips_per_image);
    const int ox0 = (int)(s - (long long)b * strips_per_image) * kTileCols;
    const int iy = y + p.crop, ix0 = ox0 + p.crop;
    if (s != strip) {  // a new strip: its first three halo rows
      __syncthreads();  // the previous tile's wgmmas have read the ring
      for (int r = 0; r < 3; ++r)
        load_halo_row(ring + ((y + r) % kRingRows) * row_bytes, x, p, b, iy + r, ix0);
      cp_async_commit();
      strip = s;
    }
    cp_async_wait<0>();
    // the rows landed through the generic proxy; wgmma reads them through
    // the async proxy
    fence_proxy_async();
    __syncthreads();  // rows y .. y + 2 landed; nobody reads slot (y + 3) % 4 any more
    if (tile + 1 < last && tile + 1 < (s + 1) * p.Ho)
      load_halo_row(ring + ((y + 3) % kRingRows) * row_bytes, x, p, b, iy + 3, ix0);
    cp_async_commit();
    if (!weights_ready) {
      mbar_wait(bar, 0);
      weights_ready = true;
    }

    // k16 step k = (tap row dr, tap column dc, 16-channel chunk kc): A is
    // halo row y + dr from pixel dc, channels 16 kc ..; B is step k of the
    // weights.  The whole chain is issued back to back, then waited for
    // once.
    const uint64_t a_rows[3] = {a_desc0 + ((y % kRingRows) * row_bytes >> 4),
                                a_desc0 + (((y + 1) % kRingRows) * row_bytes >> 4),
                                a_desc0 + (((y + 2) % kRingRows) * row_bytes >> 4)};
    uint64_t a_desc = a_rows[0], b_desc = b_desc0;
    int kc = 0, dc = 0, dr = 0;
    wgmma_fence();  // the previous epilogue read the accumulators
#pragma unroll 1
    for (int k = 0; k < ksteps; ++k) {
      WgmmaSS<NB>::mma(acc, a_desc, b_desc, k > 0);
      a_desc += a_chunk_step;
      if (++kc == kc_per_tap) {
        kc = 0;
        a_desc = a_desc + 1 - (uint64_t)kc_per_tap * a_chunk_step;  // next pixel, channel 0
        if (++dc == 3) {
          dc = 0;
          ++dr;
          a_desc = dr == 1 ? a_rows[1] : a_rows[2];
        }
      }
      b_desc += b_step;
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: bias, leaky-ReLU, bf16 pairs; for each run of four 8-channel
    // chunks a quad transposes its words, so a lane stores 16 contiguous
    // bytes (8 channels of one pixel) and a quad 64
    __nv_bfloat16* orow = out + ((size_t)b * p.Ho + y) * p.Wo * p.Cout + n0;
    constexpr int kChunks = NB / 8, kQuadChunks = kChunks / 4 * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + 16 * warp + g + 8 * h;
      __nv_bfloat16* opix = orow + (size_t)ox * p.Cout;
#pragma unroll
      for (int j0 = 0; j0 < kQuadChunks; j0 += 4) {
        uint32_t v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c, ch = n0 + 8 * j + 2 * t;
          v[c] = pack_bf16x2(act(acc[4 * j + 2 * h] + __ldg(p.bias + ch), p),
                             act(acc[4 * j + 2 * h + 1] + __ldg(p.bias + ch + 1), p));
        }
        quad_transpose(v, t);
        if (ox < p.Wo)
          *reinterpret_cast<uint4*>(opix + 8 * (j0 + t)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = kQuadChunks; j < kChunks; ++j) {
        const int ch = n0 + 8 * j + 2 * t;
        if (ox < p.Wo)
          store2(opix + 8 * j + 2 * t, act(acc[4 * j + 2 * h] + __ldg(p.bias + ch), p),
                 act(acc[4 * j + 2 * h + 1] + __ldg(p.bias + ch + 1), p));
      }
    }
  }
  if (!weights_ready) mbar_wait(bar, 0);  // no tile: still let the copy land before exit
}

template <int NB>
cudaError_t launch_wgmma(ConvArgs p, cudaStream_t stream) {
  const size_t smem = wg_smem_bytes(p.Cin, NB);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(stem_conv3x3_wgmma<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_conv3x3_wgmma<NB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_conv3x3_wgmma<NB>,
                                                        kWgThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = p.Cout / NB;
  const long long tiles = (long long)p.B * ((p.Wo + kTileCols - 1) / kTileCols) * p.Ho;
  long long per_group = (long long)sms * per_sm / groups;
  per_group = per_group < 1 ? 1 : per_group > tiles ? tiles : per_group;
  stem_conv3x3_wgmma<NB><<<dim3((unsigned)per_group, groups), kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32
constexpr int kF32Threads = 128;
constexpr int kF32Rows = 2;
constexpr int kF32Cols = 64;
static_assert(kF32Threads == kF32Rows * kF32Cols, "one thread per output pixel");

__global__ void __launch_bounds__(kF32Threads) stem_conv3x3_f32(ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  float* out = static_cast<float*>(p.out);
  constexpr int hrows = kF32Rows + 2, hcols = kF32Cols + 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kF32Rows, ox0 = blockIdx.x * kF32Cols;
  const int iy0 = oy0 + p.crop, ix0 = ox0 + p.crop;
  const int nvec = p.Cin / 4;
  for (int e = threadIdx.x; e < hrows * hcols * nvec; e += kF32Threads) {
    const int v = e % nvec, pix = e / nvec;
    const int iy = iy0 + pix / hcols, ix = ix0 + pix % hcols;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (iy < p.H && ix < p.W)
      val = *reinterpret_cast<const float4*>(x + (((size_t)b * p.H + iy) * p.W + ix) * p.Cin +
                                             v * 4);
    *reinterpret_cast<float4*>(halo + (size_t)pix * p.Cin + v * 4) = val;
  }
  __syncthreads();
  const int r = threadIdx.x / kF32Cols, c = threadIdx.x % kF32Cols;
  const int oy = oy0 + r, ox = ox0 + c;
  if (oy >= p.Ho || ox >= p.Wo) return;
  float* o = out + (((size_t)b * p.Ho + oy) * p.Wo + ox) * p.Cout;
  for (int co = 0; co < p.Cout; ++co) {
    float sum = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* hp = halo + ((size_t)(r + tap / 3) * hcols + c + tap % 3) * p.Cin;
      const float* wp = w + (size_t)tap * p.Cin * p.Cout + co;
      for (int ci = 0; ci < p.Cin; ++ci) sum = fmaf(hp[ci], wp[(size_t)ci * p.Cout], sum);
    }
    o[co] = act(sum + p.bias[co], p);
  }
}

cudaError_t launch_f32(ConvArgs p, cudaStream_t stream) {
  const size_t smem =
      align_up((size_t)(kF32Rows + 2) * (kF32Cols + 2) * p.Cin * sizeof(float), 128);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(stem_conv3x3_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Wo + kF32Cols - 1) / kF32Cols, (p.Ho + kF32Rows - 1) / kF32Rows, p.B);
  stem_conv3x3_f32<<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nunif

// nb: the bf16 kernel's column group (16, 32, 48 or 96, dividing Cout), the
// width the weights were packed for; ignored for fp32, whose w is the plain
// (9 Cin, Cout) matrix
extern "C" int nunif_stem_conv3x3(int dtype, const void* x, const void* w, const void* bias,
                                  void* out, int B, int H, int W, int Cin, int Cout, int nb,
                                  int crop, int has_slope, float slope, void* stream) {
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
  if (dtype == kDtypeF32) return (int)launch_f32(p, s);
  if (dtype != kDtypeBF16 || Cin % 16 || nb <= 0 || Cout % nb) return (int)cudaErrorInvalidValue;
  switch (nb) {
    case 96: return (int)launch_wgmma<96>(p, s);
    case 48: return (int)launch_wgmma<48>(p, s);
    case 32: return (int)launch_wgmma<32>(p, s);
    case 16: return (int)launch_wgmma<16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
