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
// K6 replaces nunif_tpu/ops/swin_attention.py:fused_window_attention_image
// (Pallas, kernel _kernel_img): qkv (B, H, W, 3C), already rolled, in;
// out (B, H, W, C).  Token t of window (b, wr, wc) is pixel (b, wr ws +
// t / ws, wc ws + t % ws), so no window partition or reverse touches device
// memory; the roll mask comes from (wr, wc).  The TPU kernel's sublane
// transposes, 128 // N window packing and W chunking have no counterpart.
//
// What bounds it on the H100: per token it reads 3C and writes C values and
// does 4 N C multiply-adds (Q K^T and P V), 144 flops a byte at N = 36 in
// bf16, below the ridge of ~295: memory-bound.  One 540p frame of
// swin_unet_4xl moves ~7.4 GB through it (2.22 ms at 3.35 TB/s).  A second
// floor is the attention's instruction issue: a unit (16 queries of one
// head of one window) issues ~390 warp instructions at head dim 16, most of
// them the softmax's (each __expf is 6 with its subnormal path), so at
// C = 192 (36 units a window) the attention alone takes longer than the
// copies alone (tools/window_attn_variants.py times the kernel without
// either part), and at C = 384 the copies alone take the kernel's time.
//
// bf16 design (window_attn_tma), a persistent warp-specialised kernel:
// - Head groups and grid.  A block owns one group of heads whose q, k and v
//   columns are at most 192 wide each (the largest divisor of heads that
//   fits: all 12 heads at C = 192, 6 at C = 384, 3 at swin_t's C = 96) and
//   strides over the windows: blockIdx.x % groups is the group,
//   blockIdx.x / groups the first window, gridDim.x / groups the stride.
//   The grid is groups x min(SMs / groups, windows), one block an SM.
// - Windows by TMA into a ring.  The producer warp's first lane loads window
//   after window into a ring of stages, each with a "full" mbarrier
//   (complete_tx) and a "done" one on which every consumer warp arrives,
//   and writes the window's grid position into a word of the stage, so that
//   no consumer divides.  A stage holds the group's q, k and v as three
//   row-major regions of N rows of cg + 8 columns (cg = group x head dim:
//   2 cg + 16 bytes a row, an odd number of 16-byte units, so ldmatrix's
//   eight rows hit eight bank groups).  Each region is one box of a 5-D
//   tensor map over qkv viewed as (cg, 3 groups, x, y, z): (cg, 3G, ws, ws,
//   nw) over K4's (nw, N, 3C) and (cg, 3G, W, H, B) over K6's image, so
//   neither layout costs an address computation a row.  The box is cg + 8
//   wide: its last 8 columns lie past dim 0 and read as zeros.  v's region
//   has 16 x key tiles rows; its rows past N, zeroed once at block start,
//   are never written, so P V meets finite values where the probabilities
//   are 0.  q's and k's rows past N, read only for dropped queries and
//   keys, are the next region's.
// - Bias resident.  At block start the threads copy the group's fp32 bias
//   (group, N, N) into shared memory once, rows padded to
//   bias_row_stride(N) (69,120 bytes at C = 192), where attention_unit reads
//   a lane's two keys with one conflict-free 8-byte load.  Where it does not
//   fit beside two stages (windows 7 and 8 at head dims 16 and 32 with more
//   than 4 heads a group, off every path), units read it from L2 (LdgBias).
// - Consumers run attention_unit (window_attention.cuh, K1 / K5's body; N
//   and the key tiles are constants for the windows of the paths and tests,
//   n_constant) on the units (head, 16-query block) of the block's windows,
//   dealt round robin over the windows' concatenated units, so no warp waits
//   at a window's end (36 units a window at C = 192, 18 at C = 384).  19
//   consumer warps for up to 3 key tiles (80 and 93 registers at head dims
//   16 and 32), 12 for 4 (up to 128): the attention-bound C = 192 launches
//   run faster with 19 than with 12.  The output overwrites q's columns in
//   the stage; after its last unit of a window a warp fences its stores for
//   the async proxy and arrives on "done".
// - Output by TMA store.  The producer waits for a window's "done", stores
//   q's region through a 5-D map over out ((cg, G, x, y, z), the same box,
//   whose last 8 columns lie outside and are not written), and reloads the
//   stage only once the store has read it (cp.async.bulk.wait_group.read).
// - Plan (tma_plan, the one owner; ops/swin_attention.py:window_attn_plan
//   asks for it through nunif_window_attn_plan): 3 stages of 48,128 bytes at
//   C = 192 (213,564 bytes with the bias), 4 at C = 384, 2 to 4 at swin_t's
//   stages and window 8.  Two stages are slower than three; a fourth adds
//   little.  The shared-memory attribute is set once an instantiation and
//   device, and the two tensor maps of a launch are kept in a per-thread
//   cache keyed on address and shape (window_map), so a launch that repeats
//   encodes none.
//
// The fp32 variant (window_attn_f32) is the first design, kept as it was:
// a block of 8 warps a (window, head group), cp.async staging of the rows,
// attention_fma, 16-byte stores.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"
#include "window_attention.cuh"

namespace nunif {
namespace {

constexpr int kMaxGroupCols = 192;  // columns of q (and of k, v) a block stages

// the largest divisor of heads whose columns fit kMaxGroupCols
int head_group(int heads, int hd) {
  for (int g = heads; g > 1; --g)
    if (heads % g == 0 && g * hd <= kMaxGroupCols) return g;
  return 1;
}

// the arguments both kernels check alike
bool window_args_ok(int nw, int N, int C, int heads, int ws, int shift, int n_wh, int n_ww) {
  return N >= 1 && N <= kMaxAttnTiles * 16 && heads >= 1 && C % heads == 0 &&
         (C / heads) % 16 == 0 && C / heads <= kMaxHeadDim && shift >= 0 && shift < ws &&
         n_wh >= 1 && n_ww >= 1 && nw >= 1 && nw % (n_wh * n_ww) == 0;
}

// ---------------------------------------------------------------- bf16
// consumer warps a block: 19 for up to 3 key tiles (at most 96 registers
// a thread: 20 warps of 32 x 96), 12 for 4 (at most 128: ptxas caps 416
// threads as 512)
__host__ __device__ constexpr int consumer_warps(int tiles) { return tiles <= 3 ? 19 : 12; }
__host__ __device__ constexpr int tma_threads(int tiles) { return (consumer_warps(tiles) + 1) * 32; }
constexpr int kMaxStages = 4;

struct TmaPlan {
  int group, groups;  // heads a block, blocks a window
  int tiles, rows;    // 16-key tiles; rows of v's region (16 tiles)
  int ldr;            // row stride of a region, elements: group * hd + 8
  int region_bytes, stage_bytes, stages;
  int bias_resident, bias_ld, bias_bytes;  // SmemBias: row stride, bytes
  int bar_off, smem;
};

// N a constant in the kernel: the windows a path or a test runs at head
// dims 16 and 32 (4 and 6; 6, 7 and 8); any other shape takes a run-time N
// and four key tiles
bool n_constant(int hd, int N) {
  return (hd == 16 && (N == 16 || N == 36)) || (hd == 32 && (N == 36 || N == 49 || N == 64));
}

bool tma_plan(int C, int heads, int N, TmaPlan* P) {
  if (heads < 1 || C % heads || N < 1 || N > kMaxAttnTiles * 16) return false;
  const int hd = C / heads;
  if (hd % 16 || hd > kMaxHeadDim) return false;
  P->group = head_group(heads, hd);
  P->groups = heads / P->group;
  P->tiles = n_constant(hd, N) ? (N + 15) / 16 : 4;
  P->rows = 16 * P->tiles;
  P->ldr = P->group * hd + 8;
  P->region_bytes = (int)align_up((size_t)N * P->ldr * 2, 128);
  P->stage_bytes = (int)align_up(2 * (size_t)P->region_bytes + (size_t)P->rows * P->ldr * 2, 128);
  const int avail = (int)kMaxSmem - 3 * kMaxStages * 8;  // room beside barriers, positions
  P->bias_ld = bias_row_stride(N);
  P->bias_bytes = (int)align_up((size_t)P->group * N * P->bias_ld * 4, 128);
  P->bias_resident = P->bias_bytes + 2 * P->stage_bytes <= avail;
  if (!P->bias_resident) P->bias_bytes = 0;
  P->stages = (avail - P->bias_bytes) / P->stage_bytes;
  if (P->stages > kMaxStages) P->stages = kMaxStages;
  if (P->stages < 2) return false;
  P->bar_off = P->bias_bytes + P->stages * P->stage_bytes;
  P->smem = P->bar_off + 2 * P->stages * 8 + P->stages * 4;
  return true;
}

int tma_grid(const TmaPlan& P, int nw, int sms) {
  int per_group = sms / P.groups;
  if (per_group > nw) per_group = nw;
  return P.groups * (per_group > 1 ? per_group : 1);
}

struct TmaArgs {
  const float* relbias;  // (heads, N, N) fp32
  int N, ws, shift, n_wh, n_ww, nw;
  int image;  // K6: (x, y, z) of window w = pixel column, row and image
  float scale;
  int group, groups, ldr, region_bytes, stage_bytes, stages, bias_ld, bias_bytes, bar_off;
};

template <int KT, int Tiles, int NFix, bool BiasSmem>
__global__ void __launch_bounds__(tma_threads(Tiles), 1)
    window_attn_tma(const __grid_constant__ CUtensorMap tm_qkv,
                    const __grid_constant__ CUtensorMap tm_out, const TmaArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using bf16 = __nv_bfloat16;
  float* bias_s = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + p.bias_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* done = full + p.stages;
  int* wpos = reinterpret_cast<int*>(done + p.stages);  // a stage's window: wr << 16 | wc
  const int N = NFix > 0 ? NFix : p.N;
  const int grp = blockIdx.x % p.groups, w0 = blockIdx.x / p.groups;
  const int wstride = gridDim.x / p.groups;
  const int n_mine = (p.nw - w0 + wstride - 1) / wstride;  // >= 1: w0 < wstride <= nw
  constexpr int Warps = consumer_warps(Tiles), Threads = tma_threads(Tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], Warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // the ring starts as zeros: v's rows past N are never written
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = threadIdx.x; i < p.stages * p.stage_bytes / 16; i += Threads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (BiasSmem) {  // the group's bias rows, a warp a row, padded with zeros
    const float* src = p.relbias + (size_t)grp * p.group * N * N;
    for (int r = warp; r < p.group * N; r += Warps + 1)
      for (int c = lane; c < p.bias_ld; c += 32)
        bias_s[r * p.bias_ld + c] = c < N ? __ldg(src + (size_t)r * N + c) : 0.f;
  }
  fence_proxy_async();  // the zeros before the tensor copies into the ring
  __syncthreads();

  if (warp == Warps) {
    // ---- producer: lane 0 loads window i into stage i % stages once the
    // store of window i - stages has read it
    if (lane == 0) {
      // window i's grid position and (x, y, z) coordinates in either map
      auto coords = [&](int i, int& wr, int& wc, int& x, int& y, int& z) {
        const int w = w0 + i * wstride, per_img = p.n_wh * p.n_ww, rem = w % per_img;
        wr = rem / p.n_ww;
        wc = rem % p.n_ww;
        x = p.image ? wc * p.ws : 0;
        y = p.image ? wr * p.ws : 0;
        z = p.image ? w / per_img : w;
      };
      auto store = [&](int i) {
        const int s = i % p.stages;
        int wr, wc, x, y, z;
        coords(i, wr, wc, x, y, z);
        mbar_wait(&done[s], (i / p.stages) & 1);
        tma_store_5d(&tm_out, ring + (size_t)s * p.stage_bytes, 0, grp, x, y, z);
        bulk_commit();
      };
      const uint32_t tx = 3u * N * p.ldr * 2;
      for (int i = 0; i < n_mine; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) {
          store(i - p.stages);
          bulk_wait_read<0>();
        }
        int wr, wc, x, y, z;
        coords(i, wr, wc, x, y, z);
        unsigned char* st = ring + (size_t)s * p.stage_bytes;
        wpos[s] = wr << 16 | wc;  // released to the consumers by the arrive
        mbar_expect_tx(&full[s], tx);
        for (int seg = 0; seg < 3; ++seg)
          tma_load_5d(st + seg * p.region_bytes, &tm_qkv, 0, seg * p.groups + grp, x, y, z,
                      &full[s]);
      }
      for (int i = n_mine > p.stages ? n_mine - p.stages : 0; i < n_mine; ++i) store(i);
      bulk_wait<0>();
    }
    return;
  }

  // ---- consumers: warp `warp` takes units warp, warp + Warps, ... of the
  // block's windows' concatenated units
  const int qblocks = (N + 15) / 16, units = p.group * qblocks;
  const int step = units % Warps;
  const uint32_t inv_ws = (65536u + p.ws - 1) / p.ws;
  const auto bias = [&] {
    if constexpr (BiasSmem)
      return SmemBias{bias_s, p.bias_ld};
    else
      return LdgBias{p.relbias + (size_t)grp * p.group * N * N};
  }();
  const int region = p.region_bytes / 2;
  int first = warp;  // this warp's first unit of window i: (warp - i units) mod Warps
  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_mine; ++i) {
    bf16* st = reinterpret_cast<bf16*>(ring + (size_t)s * p.stage_bytes);
    const RowsQKV a{st, st + region, st + 2 * region, p.ldr};
    mbar_wait(&full[s], phase);
    const int pos = wpos[s];
    const WindowMask mask = roll_mask(p.ws, p.shift, pos >> 16, pos & 0xffff, p.n_wh, p.n_ww);
    for (int u = first; u < units; u += Warps)
      attention_unit<KT, Tiles, NFix>(a, bias, u / qblocks, u % qblocks, mask, true, N, p.scale,
                                      inv_ws);
    fence_proxy_async();  // this warp's outputs before the tensor store reads them
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[s]);
    first = first >= step ? first - step : first - step + Warps;
    if (++s == p.stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// A 5-D map over a bf16 tensor of tokens of `segs` column groups of cg,
// token stride tok_bytes: dims (cg, segs, nx, ny, nz), strides (cg, tok,
// y, z bytes), box (cg + 8, 1, ws, ws, 1), unswizzled.
int encode_window_map(CUtensorMap* map, const void* ptr, int cg, int segs, long long tok_bytes,
                      int nx, int ny, long long y_bytes, int nz, long long z_bytes, int ws) {
  const Encoder& enc = encoder();
  if (enc.err != cudaSuccess) return (int)enc.err;
  const cuuint64_t dims[5] = {(cuuint64_t)cg, (cuuint64_t)segs, (cuuint64_t)nx, (cuuint64_t)ny,
                              (cuuint64_t)nz};
  const cuuint64_t strides[4] = {(cuuint64_t)cg * 2, (cuuint64_t)tok_bytes, (cuuint64_t)y_bytes,
                                 (cuuint64_t)z_bytes};
  const cuuint32_t box[5] = {(cuuint32_t)cg + 8, 1, (cuuint32_t)ws, (cuuint32_t)ws, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc.fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + (int)r;
}

// encode_window_map through this thread's cache of maps: a launch that
// repeats (same tensor address and shape) encodes nothing
int window_map(CUtensorMap* map, const void* ptr, int cg, int segs, long long tok_bytes, int nx,
               int ny, long long y_bytes, int nz, long long z_bytes, int ws) {
  thread_local MapCache<10> cache;
  return cache.get({(long long)(uintptr_t)ptr, cg, segs, tok_bytes, nx, ny, y_bytes, nz, z_bytes,
                    ws},
                   map, [&](CUtensorMap* m) {
                     return encode_window_map(m, ptr, cg, segs, tok_bytes, nx, ny, y_bytes, nz,
                                              z_bytes, ws);
                   });
}

// (device, SM count) of the current device, the count looked up once
cudaError_t current_sms(int* dev, int* sms) {
  static std::atomic<int> cached[64] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& c = cached[*dev & 63];
  *sms = c.load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess) c.store(*sms, std::memory_order_relaxed);
  return err;
}

template <int KT, int Tiles, int NFix, bool BiasSmem>
cudaError_t launch_tma(const CUtensorMap& in, const CUtensorMap& out, const TmaArgs& p, int dev,
                       int grid, int smem, cudaStream_t stream) {
  auto kernel = window_attn_tma<KT, Tiles, NFix, BiasSmem>;
  // the attribute once an instantiation and device, at the largest size
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  kernel<<<grid, tma_threads(Tiles), smem, stream>>>(in, out, p);
  return cudaGetLastError();
}

// the instantiation for the plan: N and the key tiles as constants where
// n_constant, bias in shared memory where resident
cudaError_t dispatch_tma(const CUtensorMap& in, const CUtensorMap& out, const TmaArgs& p,
                         const TmaPlan& P, int hd, int dev, int grid, cudaStream_t stream) {
#define WA_LAUNCH(KT, T, NF, B) \
  return launch_tma<KT, T, NF, B>(in, out, p, dev, grid, P.smem, stream)
  if (!P.bias_resident) {
    if (P.tiles == 4 && hd == 16) WA_LAUNCH(1, 4, 0, false);
    if (P.tiles == 4 && hd == 32) WA_LAUNCH(2, 4, 0, false);
    return cudaErrorInvalidConfiguration;
  }
  switch (hd) {
    case 16:
      if (p.N == 16) WA_LAUNCH(1, 1, 16, true);
      if (p.N == 36) WA_LAUNCH(1, 3, 36, true);
      WA_LAUNCH(1, 4, 0, true);
    case 32:
      if (p.N == 36) WA_LAUNCH(2, 3, 36, true);
      if (p.N == 49) WA_LAUNCH(2, 4, 49, true);
      if (p.N == 64) WA_LAUNCH(2, 4, 64, true);
      WA_LAUNCH(2, 4, 0, true);
    case 48: WA_LAUNCH(3, 4, 0, true);
    default: WA_LAUNCH(4, 4, 0, true);
  }
#undef WA_LAUNCH
}

// K4 (image 0: qkv (nw, N, 3C), out (nw, N, C)) or K6 (image 1: qkv
// (B, H, W, 3C), out (B, H, W, C), nw = B n_wh n_ww), bf16
int launch_bf16(const void* qkv, const float* relbias, void* out, int nw, int N, int C, int heads,
                int ws, int shift, int n_wh, int n_ww, int image, float scale,
                cudaStream_t stream) {
  if (!window_args_ok(nw, N, C, heads, ws, shift, n_wh, n_ww) || N != ws * ws)
    return (int)cudaErrorInvalidValue;
  TmaPlan P;
  if (!tma_plan(C, heads, N, &P)) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = current_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const int cg = P.group * (C / heads);
  const long long row3 = 3LL * C * 2, row1 = (long long)C * 2;  // token strides, bytes
  const int nx = image ? n_ww * ws : ws, ny = image ? n_wh * ws : ws;
  const int nz = image ? nw / (n_wh * n_ww) : nw;
  const long long ypix = image ? nx : ws;  // tokens a y step
  CUtensorMap tm_in, tm_out;
  int rc = window_map(&tm_in, qkv, cg, 3 * P.groups, row3, nx, ny, ypix * row3, nz,
                      ypix * ny * row3, ws);
  if (rc == 0)
    rc = window_map(&tm_out, out, cg, P.groups, row1, nx, ny, ypix * row1, nz, ypix * ny * row1,
                    ws);
  if (rc != 0) return rc;
  TmaArgs p{};
  p.relbias = relbias;
  p.N = N;
  p.ws = ws;
  p.shift = shift;
  p.n_wh = n_wh;
  p.n_ww = n_ww;
  p.nw = nw;
  p.image = image;
  p.scale = scale;
  p.group = P.group;
  p.groups = P.groups;
  p.ldr = P.ldr;
  p.region_bytes = P.region_bytes;
  p.stage_bytes = P.stage_bytes;
  p.stages = P.stages;
  p.bias_ld = P.bias_ld;
  p.bias_bytes = P.bias_bytes;
  p.bar_off = P.bar_off;
  const int grid = tma_grid(P, nw, sms);
  return (int)dispatch_tma(tm_in, tm_out, p, P, C / heads, dev, grid, stream);
}

// ---------------------------------------------------------------- fp32
constexpr int kWaThreads = 256;
constexpr int kWaWarps = kWaThreads / 32;

struct WinArgs {
  const float* qkv;
  const float* relbias;  // (heads, N, N)
  float* out;
  int nw, N, C, heads, hd, ws, shift, n_wh, n_ww;
  int image;  // K6: qkv and out in image layout (B, n_wh ws, n_ww ws, .)
  float scale;
  int group;  // heads per block
  int ld;     // shared-memory row stride in elements: 3 * group * hd + pad
};

size_t wa_smem_bytes(const WinArgs& p) {
  return align_up((size_t)p.N * p.ld * sizeof(float), 128) + (size_t)kWaWarps * p.N * sizeof(float);
}

// Row of token t of window w in a tensor of `width` values a token.
__device__ __forceinline__ long long token_offset(const WinArgs& p, int w, int t, int width) {
  if (!p.image) return ((long long)w * p.N + t) * width;
  const int per_img = p.n_wh * p.n_ww, rem = w % per_img;
  const int row = rem / p.n_ww * p.ws + t / p.ws, col = rem % p.n_ww * p.ws + t % p.ws;
  return (((long long)(w / per_img) * p.n_wh * p.ws + row) * p.n_ww * p.ws + col) * width;
}

__global__ void __launch_bounds__(kWaThreads) window_attn_f32(WinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);
  const int groups = p.heads / p.group;
  const int w = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int N = p.N, C = p.C, cg = p.group * p.hd;
  const int warp = threadIdx.x / 32;

  // 1. stage q, k and v of this head group: shared row r holds q at
  //    columns 0 .. cg, k at cg .., v at 2 cg ..
  constexpr int VEC = 16 / sizeof(float);
  const int vseg = cg / VEC;
  const float* src = p.qkv + grp * cg;
  for (int e = threadIdx.x; e < N * 3 * vseg; e += kWaThreads) {
    const int r = e / (3 * vseg), rem = e % (3 * vseg);
    const int seg = rem / vseg, v = rem % vseg;
    cp_async16(S + (size_t)r * p.ld + seg * cg + v * VEC,
               src + token_offset(p, w, r, 3 * C) + seg * C + v * VEC, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. attention of every head of the group
  const int rem = w % (p.n_wh * p.n_ww);
  const WindowMask mask = roll_mask(p.ws, p.shift, rem / p.n_ww, rem % p.n_ww, p.n_wh, p.n_ww);
  const float* rb = p.relbias + (size_t)grp * p.group * N * N;
  float* pr = reinterpret_cast<float*>(smem + align_up((size_t)N * p.ld * sizeof(float), 128)) +
              warp * N;
  for (int h = warp; h < p.group; h += kWaWarps)
    attention_fma(S, p.ld, cg, h, p.hd, N, p.scale, rb + (size_t)h * N * N, mask, pr);
  __syncthreads();

  // 3. the output (in q's columns) to token r's row of out, columns
  //    grp * cg ..
  float* out = p.out + grp * cg;
  for (int e = threadIdx.x; e < N * vseg; e += kWaThreads) {
    const int r = e / vseg, v = e % vseg;
    *reinterpret_cast<uint4*>(out + token_offset(p, w, r, C) + v * VEC) =
        *reinterpret_cast<const uint4*>(S + (size_t)r * p.ld + v * VEC);
  }
}

int launch_f32(WinArgs p, cudaStream_t stream) {
  if (!window_args_ok(p.nw, p.N, p.C, p.heads, p.ws, p.shift, p.n_wh, p.n_ww))
    return (int)cudaErrorInvalidValue;
  p.group = head_group(p.heads, p.hd);
  p.ld = 3 * p.group * p.hd + 4;  // +16 bytes
  const size_t smem = wa_smem_bytes(p);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(window_attn_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.nw * (p.heads / p.group);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_attn_f32<<<(unsigned)blocks, kWaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_win(int dtype, const void* qkv, const void* relbias, void* out, int nw, int N, int C,
               int heads, int ws, int shift, int n_wh, int n_ww, int image, float scale,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rb = static_cast<const float*>(relbias);
  if (dtype == kDtypeBF16)
    return launch_bf16(qkv, rb, out, nw, N, C, heads, ws, shift, n_wh, n_ww, image, scale, s);
  if (dtype != kDtypeF32) return (int)cudaErrorInvalidValue;
  WinArgs p{};
  p.qkv = static_cast<const float*>(qkv);
  p.relbias = rb;
  p.out = static_cast<float*>(out);
  p.nw = nw;
  p.N = N;
  p.C = C;
  p.heads = heads;
  p.hd = heads > 0 ? C / heads : 0;
  p.ws = ws;
  p.shift = shift;
  p.n_wh = n_wh;
  p.n_ww = n_ww;
  p.image = image;
  p.scale = scale;
  return launch_f32(p, s);
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_window_attn(int dtype, const void* qkv, const void* relbias, void* out, int nw,
                                 int N, int C, int heads, int ws, int shift, int n_wh, int n_ww,
                                 float scale, void* stream) {
  return nunif::launch_win(dtype, qkv, relbias, out, nw, N, C, heads, ws, shift, n_wh, n_ww, 0,
                           scale, stream);
}

// K6: qkv (B, H, W, 3C) and out (B, H, W, C), H and W multiples of ws.
extern "C" int nunif_window_attn_image(int dtype, const void* qkv, const void* relbias, void* out,
                                       int B, int H, int W, int C, int heads, int ws, int shift,
                                       float scale, void* stream) {
  if (ws < 1 || B < 1 || H % ws || W % ws) return (int)cudaErrorInvalidValue;
  return nunif::launch_win(dtype, qkv, relbias, out, B * (H / ws) * (W / ws), ws * ws, C, heads,
                           ws, shift, H / ws, W / ws, 1, scale, stream);
}

// The bf16 kernel's plan for width C, `heads` heads and N = ws^2 tokens a
// window, over nw windows on `sms` SMs: out[0..6] = heads a block, rows of
// a stage's v region (16 x key tiles), ring stages, bias resident in shared
// memory (1) or read from L2 (0), shared-memory bytes, grid size, bytes a
// stage.
extern "C" int nunif_window_attn_plan(int C, int heads, int N, int nw, int sms, int* out) {
  using namespace nunif;
  TmaPlan P;
  if (nw < 1 || sms < 1 || !tma_plan(C, heads, N, &P)) return (int)cudaErrorInvalidConfiguration;
  out[0] = P.group;
  out[1] = P.rows;
  out[2] = P.stages;
  out[3] = P.bias_resident;
  out[4] = P.smem;
  out[5] = tma_grid(P, nw, sms);
  out[6] = P.stage_bytes;
  return 0;
}
