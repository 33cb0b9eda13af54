// T1: Hopper probe of the image strip <-> window relayout inside a kernel.
//
// Replaces tools/microbench_strip.py:strip_call (Pallas kernels
// _pass_kernel and _relayout_kernel).  Both kernels compute out = x * scale
// on a contiguous bf16 (1, H, W, C) image:
// - pass: streamed in image order;
// - relayout: through the TPU kernel's round trip, image order -> windows
//   of ws x ws tokens in fast memory, the scale applied in window order,
//   -> image order.
// What bounds both on the H100: bytes (each element read and written once;
// 2 x 407 MB at 1104 x 1920 x 96, 0.243 ms at 3.35 TB/s).  The question the
// probe answers is whether forming windows in shared memory costs anything
// beside the copy.  Design:
// - The unit of work is a segment: one window row of `seg` windows (the
//   largest divisor of cw up to 8 whose stage fits twice in a block), as
//   the first design's blocks walked them.  A persistent grid (the plan's
//   blocks a SM on every SM) deals segments round robin in the order of the
//   TPU tool's (rh x cw)-window blocks, so (rh, cw) sets the order of the
//   walk and not the occupancy.
// - A ring of stages in shared memory, each with a full and an empty
//   mbarrier.  One producer thread fills the stages ahead; eight consumer
//   warps scale a stage in place in 16-byte vectors; one consumer thread
//   then stores it and, once the previous stage's store has read its
//   bytes, hands that stage back to the producer (empty).
// - pass: a segment's ws image rows are contiguous runs of seg ws C bf16;
//   they come in by ws bulk copies and go out by ws bulk stores.
// - relayout: the segment lands in shared memory in window order,
//   [window][row][col][C], by one TMA box over a 5-D map of the image,
//   (C, column in window, row in window, window, window row), whose
//   strides are not monotonic; the consumers scale that window-ordered
//   stage (a token is C contiguous values, so 16-byte vectors are
//   conflict-free), and one TMA store through the same kind of map over
//   the output puts it back in image order.  The test hook `windows`
//   receives the scaled stage as it is, by one more bulk store.
// - No per-launch host work beyond the launch: the scale arrives as a host
//   float, the tensor maps come from a per-thread cache, the SM count and
//   the shared-memory attribute are looked up once a device.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

constexpr int kStripConsumerWarps = 8;
constexpr int kStripConsumers = kStripConsumerWarps * 32;
constexpr int kStripThreads = kStripConsumers + 32;  // + the producer warp
constexpr int kSegWindows = 8;
constexpr int kStripStages = 4;
constexpr int kStripBarBytes = 128;  // full and empty barriers, padded
constexpr int kMaxBox = 256;         // a TMA box dimension, elements
// shared memory of an SM (228 KB) and the 1 KB the hardware reserves a
// block
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReserved = 1024;

struct StripPlan {
  int seg;          // windows a segment
  int stages;       // ring stages a block
  int stage_bytes;  // a segment, 128-byte aligned
  int per_sm;       // blocks a SM
  int smem;         // shared-memory bytes a block
};

// The widest segment (a divisor of cw up to kSegWindows) whose stage fits
// twice in a block; kStripStages stages, on two blocks a SM where both
// fit, else as many stages (at least 2) as one block holds.
bool strip_plan(int C, int ws, int cw, StripPlan* P) {
  for (int seg = cw < kSegWindows ? cw : kSegWindows; seg >= 1; --seg) {
    if (cw % seg) continue;
    const long long stage = (long long)align_up((size_t)seg * ws * ws * C * 2, 128);
    if (kStripBarBytes + 2 * stage > (long long)kMaxSmem) continue;
    P->seg = seg;
    P->stage_bytes = (int)stage;
    const long long full = kStripBarBytes + kStripStages * stage;
    if (2 * (full + kSmemReserved) <= kSmemPerSm) {
      P->per_sm = 2;
      P->stages = kStripStages;
    } else {
      P->per_sm = 1;
      const long long fit = ((long long)kMaxSmem - kStripBarBytes) / stage;
      P->stages = fit < kStripStages ? (int)fit : kStripStages;
    }
    P->smem = kStripBarBytes + P->stages * P->stage_bytes;
    return true;
  }
  return false;
}

struct StripArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  __nv_bfloat16* windows;  // the relayout's hook (nh nw, ws ws, C), or null
  long long units;         // segments of the image
  int W, C, ws, rh, cw, seg, nw;
  int stages, stage_bytes;
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

// segment u's window row and first window column: the TPU tool's blocks in
// its grid's order, in each block its window rows, in each row its
// segments
__device__ __forceinline__ void segment_at(const StripArgs& p, long long u, int& wr, int& wc) {
  const int per_row = p.cw / p.seg, per_block = p.rh * per_row, blocks_x = p.nw / p.cw;
  const long long b = u / per_block;
  const int k = (int)(u - b * per_block);
  const int bi = (int)(b / blocks_x), bj = (int)(b - (long long)bi * blocks_x);
  wr = bi * p.rh + k / per_row;
  wc = bj * p.cw + (k % per_row) * p.seg;
}

template <bool Relayout>
__global__ void __launch_bounds__(kStripThreads, 1)
    strip_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_out,
                 const StripArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStripStages;
  unsigned char* ring = smem + kStripBarBytes;
  const long long step = gridDim.x;
  const int n_mine = (int)((p.units - blockIdx.x + step - 1) / step);  // >= 1: grid <= units
  const uint32_t bytes = (uint32_t)p.seg * p.ws * p.ws * p.C * 2;
  const uint32_t row_bytes = (uint32_t)p.seg * p.ws * p.C * 2;  // pass: an image row's run
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kStripConsumerWarps) {
    // ---- producer: segment i into stage i % stages once the store of
    // segment i - stages has read it
    if (lane == 0) {
      for (int i = 0; i < n_mine; ++i) {
        const int s = i % p.stages;
        if (i >= p.stages) mbar_wait(&empty[s], (i / p.stages - 1) & 1);
        int wr, wc;
        segment_at(p, blockIdx.x + i * step, wr, wc);
        unsigned char* st = ring + (size_t)s * p.stage_bytes;
        mbar_expect_tx(&full[s], bytes);
        if constexpr (Relayout) {
          tma_load_5d(st, &tm_x, 0, 0, 0, wc, wr, &full[s]);
        } else {
          const __nv_bfloat16* src = p.x + ((size_t)wr * p.ws * p.W + (size_t)wc * p.ws) * p.C;
          for (int r = 0; r < p.ws; ++r)
            bulk_copy_g2s(st + r * row_bytes, src + (size_t)r * p.W * p.C, row_bytes, &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: scale each stage in place, then thread 0 stores it
  const int tid = threadIdx.x;
  const int nvec = (int)(bytes / 16);
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % p.stages;
    unsigned char* st = ring + (size_t)s * p.stage_bytes;
    mbar_wait(&full[s], (i / p.stages) & 1);
    uint4* v = reinterpret_cast<uint4*>(st);
#pragma unroll 4
    for (int e = tid; e < nvec; e += kStripConsumers) v[e] = scale8(v[e], p.scale);
    fence_proxy_async();  // this thread's writes before the stores read them
    named_bar_sync(1, kStripConsumers);
    if (tid == 0) {
      int wr, wc;
      segment_at(p, blockIdx.x + i * step, wr, wc);
      if constexpr (Relayout) {
        tma_store_5d(&tm_out, st, 0, 0, 0, wc, wr);
        if (p.windows != nullptr)
          bulk_copy_s2g(p.windows + ((size_t)wr * p.nw + wc) * p.ws * p.ws * p.C, st, bytes);
      } else {
        __nv_bfloat16* dst = p.out + ((size_t)wr * p.ws * p.W + (size_t)wc * p.ws) * p.C;
        for (int r = 0; r < p.ws; ++r)
          bulk_copy_s2g(dst + (size_t)r * p.W * p.C, st + r * row_bytes, row_bytes);
      }
      bulk_commit();
      bulk_wait_read<1>();  // the previous segment's stores have read its stage
      if (i >= 1) mbar_arrive(&empty[(i - 1) % p.stages]);
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// A 5-D map over a bf16 (H, W, C) image whose box is one segment of seg
// windows in window order: dims (C, column in window, row in window,
// window, window row), box (C, ws, ws, seg, 1), unswizzled.
int encode_segment_map(CUtensorMap* map, const void* ptr, int H, int W, int C, int ws, int seg) {
  const Encoder& enc = encoder();
  if (enc.err != cudaSuccess) return (int)enc.err;
  const cuuint64_t px = (cuuint64_t)C * 2, row = (cuuint64_t)W * px;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)ws, (cuuint64_t)ws, (cuuint64_t)(W / ws),
                              (cuuint64_t)(H / ws)};
  const cuuint64_t strides[4] = {px, row, ws * px, ws * row};
  const cuuint32_t box[5] = {(cuuint32_t)C, (cuuint32_t)ws, (cuuint32_t)ws, (cuuint32_t)seg, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc.fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + (int)r;
}

// encode_segment_map through this thread's cache: a launch that repeats
// (same addresses and shape) encodes nothing
int segment_map(CUtensorMap* map, const void* ptr, int H, int W, int C, int ws, int seg) {
  thread_local MapCache<6> cache;
  return cache.get({(long long)(uintptr_t)ptr, H, W, C, ws, seg}, map, [&](CUtensorMap* m) {
    return encode_segment_map(m, ptr, H, W, C, ws, seg);
  });
}

// the current device and its SM count, looked up once a device
cudaError_t device_sms(int* dev, int* sms) {
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

template <bool Relayout>
cudaError_t launch_strip(const CUtensorMap& in, const CUtensorMap& out, const StripArgs& p,
                         int dev, int grid, int smem, cudaStream_t stream) {
  auto kernel = strip_kernel<Relayout>;
  // the attribute once an instantiation and device, at the largest size
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  kernel<<<grid, kStripThreads, smem, stream>>>(in, out, p);
  return cudaGetLastError();
}

bool strip_args_ok(int H, int W, int C, int ws, int rh, int cw) {
  return H > 0 && W > 0 && C > 0 && C % 8 == 0 && C <= kMaxBox && ws >= 1 && ws <= kMaxBox &&
         rh >= 1 && cw >= 1 && H % (rh * ws) == 0 && W % (cw * ws) == 0;
}

long long strip_units(int H, int W, int ws, int seg) {
  return (long long)(H / ws) * (W / ws / seg);
}

}  // namespace
}  // namespace nunif

// x, out: (1, H, W, C) bf16, contiguous and 16-byte aligned; H a multiple
// of rh ws, W of cw ws, C of 8 and at most 256.  relayout 0: the pass
// kernel; 1: the relayout round trip, which with windows != null also
// writes its scaled window-ordered stages there, (H/ws W/ws, ws ws, C) in
// window_partition2 order.  out = x * scale, rounded to bf16.
extern "C" int nunif_strip(int relayout, const void* x, void* out, void* windows, int H, int W,
                           int C, int ws, int rh, int cw, float scale, void* stream) {
  using namespace nunif;
  StripPlan P;
  if (!strip_args_ok(H, W, C, ws, rh, cw) ||
      ((uintptr_t)x | (uintptr_t)out | (uintptr_t)windows) % 16 || (windows && !relayout))
    return (int)cudaErrorInvalidValue;
  if (!strip_plan(C, ws, cw, &P)) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  StripArgs p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.windows = static_cast<__nv_bfloat16*>(windows);
  p.units = strip_units(H, W, ws, P.seg);
  p.W = W;
  p.C = C;
  p.ws = ws;
  p.rh = rh;
  p.cw = cw;
  p.seg = P.seg;
  p.nw = W / ws;
  p.stages = P.stages;
  p.stage_bytes = P.stage_bytes;
  p.scale = scale;
  const long long blocks = (long long)sms * P.per_sm;
  const int grid = (int)(p.units < blocks ? p.units : blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_x{}, tm_out{};
  if (relayout) {
    int rc = segment_map(&tm_x, x, H, W, C, ws, P.seg);
    if (rc == 0) rc = segment_map(&tm_out, out, H, W, C, ws, P.seg);
    if (rc != 0) return rc;
    return (int)launch_strip<true>(tm_x, tm_out, p, dev, grid, P.smem, s);
  }
  return (int)launch_strip<false>(tm_x, tm_out, p, dev, grid, P.smem, s);
}

// The launch plan for an (H, W, C) image in (rh, cw)-window blocks of
// windows of ws on `sms` SMs: out[0..6] = windows a segment, ring stages,
// bytes a stage, blocks a SM, shared-memory bytes a block, segments, grid.
extern "C" int nunif_strip_plan(int H, int W, int C, int ws, int rh, int cw, int sms, int* out) {
  using namespace nunif;
  StripPlan P;
  if (sms < 1 || !strip_args_ok(H, W, C, ws, rh, cw) || !strip_plan(C, ws, cw, &P))
    return (int)cudaErrorInvalidValue;
  const long long units = strip_units(H, W, ws, P.seg), blocks = (long long)sms * P.per_sm;
  out[0] = P.seg;
  out[1] = P.stages;
  out[2] = P.stage_bytes;
  out[3] = P.per_sm;
  out[4] = P.smem;
  out[5] = (int)units;
  out[6] = (int)(units < blocks ? units : blocks);
  return 0;
}
