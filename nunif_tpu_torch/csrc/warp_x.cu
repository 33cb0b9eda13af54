// K3: horizontal bilinear backward warp with border padding, NHWC.
//
// Replaces nunif_tpu/modules/grid_sample.py:_warp_x_bounded_pallas (Pallas,
// body _warp_x_kernel).  out[b, y, x, c] for gx = clip(x + delta[b, y, x],
// 0, W - 1), x0 = floor(gx), t = gx - x0:
//   (1 - t) * r(in[b, y, x0, c]) + t * r(in[b, y, min(x0 + 1, W - 1), c])
// where r rounds to bf16; fp32 arithmetic; the result in x's type (fp32 or
// bf16), as the TPU function's wrapper casts around its Pallas body.
//
// The TPU kernel sums 2S + 1 hat-weighted shifted copies of an edge-padded
// strip (S = max_shift + 1) because the TPU has no fast gather; every term
// but the two taps around gx has weight 0, so a direct two-tap gather gives
// the same values.  It multiplies and adds with the twin's roundings (no
// fused multiply-add), taking the x0 tap first as the offset sum does.
//
// What bounds it on the H100: bytes.  Per pixel it reads C elements of x
// and 4 bytes of delta and writes C elements; on the iw3 path, (16, 1080,
// 1920, 3) with fp32 x, that is 28 bytes, 0.93 GB a launch, 0.277 ms at
// 3.35 TB/s; the few operations an element are far below that.  Design:
// - x is read in its own type and rounded to bf16 in registers, so no cast
//   pass runs before the launch, and the output is written in x's type.
// - A persistent grid (the occupancy API's blocks an SM on every SM)
//   strides over units: a row, or a segment of one (below).  The per-pixel
//   loop has no integer division; a unit's row and columns cost one.
// - A unit's staged columns of x and its delta come into a ring of
//   kWarpStages stages by cp.async.bulk, counted on one mbarrier a stage;
//   thread 0 issues the next unit's copies before the block computes this
//   one, so loads overlap arithmetic.  Taps are read from shared memory.
// - The output goes to one of two shared buffers and leaves by a bulk
//   store, which runs while the next unit is computed.
// - Rows whose bytes or addresses are not multiples of 16 (W = 1001 at
//   C = 3, W % 4 != 0, an unaligned tensor) take the same ring through a
//   plain copy loop and write the output with plain stores: the launch
//   decides once (WarpArgs::bulk).
// - Rows that do not fit: where a whole row's ring and output buffers
//   exceed kWarpSmemBudget (two blocks an SM), a unit writes `seg` columns
//   (a multiple of kWarpAlignCols) and stages halo = max_shift + 1 more on
//   each side, rounded out to kWarpAlignCols.  That holds both taps of every
//   pixel for |delta| <= max_shift, the function's contract; beyond it a tap
//   is clamped into the staged columns (memory-safe, not meant to agree).
//   Chosen over gathering such rows from global memory because it keeps one
//   gather, from shared memory, for every shape.
#include "common.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

constexpr int kWarpThreads = 256;
constexpr int kWarpStages = 2;
// shared memory a block may plan: two blocks an SM (2 x (112 KB + the 1 KB
// the hardware reserves a block) within the SM's 228 KB)
constexpr int kWarpSmemBudget = 114688;
// segment starts and staged column ranges are multiples of this, so that a
// bulk copy's address stays 16-byte aligned for every C and element size
constexpr int kWarpAlignCols = 8;

struct WarpArgs {
  const void* x;
  const float* delta;
  void* out;
  long long rows;  // B * H
  int W;
  int seg;   // columns a unit writes
  int nseg;  // units a row
  int halo;  // columns staged beyond each side of a segment (0: whole rows)
  int cap;   // columns of x a stage holds
  int bulk;  // 1: copies and stores by the copy engine; 0: by the copy loop
};

__host__ __device__ inline int align16(long long v) { return (int)((v + 15) / 16 * 16); }

// Shared memory: the stages' mbarriers, kWarpStages stages of (x: cap
// columns, delta: seg values), two output buffers of seg columns.
struct WarpLayout {
  int x_bytes, stage_bytes, out_bytes, ring, total;
};

__host__ __device__ inline WarpLayout warp_layout(int cap, int seg, int C, int es) {
  WarpLayout L;
  L.x_bytes = align16((long long)cap * C * es);
  L.stage_bytes = L.x_bytes + align16((long long)seg * 4);
  L.out_bytes = align16((long long)seg * C * es);
  L.ring = align16(kWarpStages * 8);
  L.total = L.ring + kWarpStages * L.stage_bytes + 2 * L.out_bytes;
  return L;
}

struct WarpPlan {
  int seg, nseg, halo, cap, smem;
};

// Whole rows where they fit the budget, else the widest segment that does;
// false where not even kWarpAlignCols columns fit beside the halo.
bool warp_plan(int W, int C, int es, int max_shift, WarpPlan* P) {
  const WarpLayout whole = warp_layout(W, W, C, es);
  if (whole.total <= kWarpSmemBudget) {
    *P = {W, 1, 0, W, whole.total};
    return true;
  }
  const int halo = max_shift + 1;
  const int slack = 2 * (halo + kWarpAlignCols);  // the rounding out of both ends
  auto fits = [&](int seg) {
    return warp_layout(seg + slack, seg, C, es).total <= kWarpSmemBudget;
  };
  // from an estimate without the 16-byte rounding to the widest that fits
  const long long per_col = (long long)kWarpStages * (C * es + 4) + 2LL * C * es;
  const long long fixed = warp_layout(slack, 0, C, es).total;
  int seg = (int)((kWarpSmemBudget - fixed) / per_col) / kWarpAlignCols * kWarpAlignCols;
  seg = seg < 0 ? 0 : seg;
  while (fits(seg + kWarpAlignCols)) seg += kWarpAlignCols;
  while (seg >= kWarpAlignCols && !fits(seg)) seg -= kWarpAlignCols;
  if (seg < kWarpAlignCols) return false;
  *P = {seg, (W + seg - 1) / seg, halo, seg + slack, warp_layout(seg + slack, seg, C, es).total};
  return true;
}

// the bf16 rounding of a tap, as fp32
__device__ __forceinline__ float tap(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float tap(__nv_bfloat16 v) { return __bfloat162float(v); }

// unit u: its row, the columns it writes [c0, c0 + n) and the columns it
// stages [lo, lo + m)
struct WarpUnit {
  long long row;
  int c0, n, lo, m;
};

__device__ __forceinline__ WarpUnit warp_unit(const WarpArgs& p, long long u) {
  WarpUnit q;
  q.row = u / p.nseg;
  q.c0 = (int)(u - q.row * p.nseg) * p.seg;
  q.n = min(p.seg, p.W - q.c0);
  q.lo = max(0, q.c0 - p.halo) & ~(kWarpAlignCols - 1);
  const int hi = (q.c0 + q.n + p.halo + kWarpAlignCols - 1) & ~(kWarpAlignCols - 1);
  q.m = min(p.W, hi) - q.lo;
  return q;
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarpThreads) warp_x_kernel(WarpArgs p) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr int es = sizeof(T);
  const WarpLayout L = warp_layout(p.cap, p.seg, C, es);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const long long units = p.rows * p.nseg, step = gridDim.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWarpStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // bring unit u's x columns and delta into stage s
  auto issue = [&](long long u, int s) {
    const WarpUnit q = warp_unit(p, u);
    unsigned char* st = sm + L.ring + s * L.stage_bytes;
    const T* xs = x + (q.row * p.W + q.lo) * C;
    const float* ds = p.delta + q.row * p.W + q.c0;
    if (p.bulk) {
      if (tid == 0) {
        const uint32_t xb = (uint32_t)q.m * C * es, db = (uint32_t)q.n * 4;
        mbar_expect_tx(&full[s], xb + db);
        bulk_copy_g2s(st, xs, xb, &full[s]);
        bulk_copy_g2s(st + L.x_bytes, ds, db, &full[s]);
      }
    } else {
      T* sx = reinterpret_cast<T*>(st);
      float* sd = reinterpret_cast<float*>(st + L.x_bytes);
      for (int e = tid; e < q.m * C; e += kWarpThreads) sx[e] = xs[e];
      for (int e = tid; e < q.n; e += kWarpThreads) sd[e] = ds[e];
    }
  };

  long long u = blockIdx.x;
  for (int s = 0; s < kWarpStages - 1; ++s)
    if (u + s * step < units) issue(u + s * step, s);
  __syncthreads();  // the copy loop's stores, before the first unit reads them
  for (int i = 0; u < units; u += step, ++i) {
    const int s = i % kWarpStages;
    if (u + (kWarpStages - 1) * step < units)
      issue(u + (kWarpStages - 1) * step, (i + kWarpStages - 1) % kWarpStages);
    if (p.bulk) mbar_wait(&full[s], (i / kWarpStages) & 1);
    const WarpUnit q = warp_unit(p, u);
    const unsigned char* st = sm + L.ring + s * L.stage_bytes;
    const T* sx = reinterpret_cast<const T*>(st);
    const float* sd = reinterpret_cast<const float*>(st + L.x_bytes);
    T* og = out + (q.row * p.W + q.c0) * C;
    T* ob = reinterpret_cast<T*>(sm + L.ring + kWarpStages * L.stage_bytes + (i & 1) * L.out_bytes);
    T* o = p.bulk ? ob : og;
    for (int j = tid; j < q.n; j += kWarpThreads) {
      float gx = __fadd_rn((float)(q.c0 + j), sd[j]);
      gx = fminf(fmaxf(gx, 0.f), (float)(p.W - 1));
      const float x0f = floorf(gx);
      const float t = __fsub_rn(gx, x0f);
      const float w0 = __fsub_rn(1.f, t);
      const int x0 = (int)x0f;
      const int x1 = x0 + 1 < p.W ? x0 + 1 : p.W - 1;
      const T* a = sx + min(max(x0 - q.lo, 0), q.m - 1) * C;
      const T* b = sx + min(max(x1 - q.lo, 0), q.m - 1) * C;
#pragma unroll
      for (int c = 0; c < C; ++c)
        o[j * C + c] = from_f<T>(__fadd_rn(__fmul_rn(tap(a[c]), w0), __fmul_rn(tap(b[c]), t)));
    }
    if (p.bulk) {
      fence_proxy_async();
      if (tid == 0) bulk_wait_read<0>();  // the last unit's store has read its buffer
    }
    __syncthreads();  // stage s and the output buffer are complete
    if (p.bulk && tid == 0) {
      bulk_copy_s2g(og, ob, (uint32_t)q.n * C * es);
      bulk_commit();
    }
  }
  if (p.bulk && tid == 0) bulk_wait<0>();
}

template <typename T, int C>
cudaError_t launch_warp(const WarpArgs& p, int smem, cudaStream_t stream) {
  auto kernel = warp_x_kernel<T, C>;
  // the attribute, the SM count and the occupancy once an instantiation,
  // device and shared-memory size: the host calls cost more than a small
  // launch
  thread_local int last_dev = -1, last_smem = -1, blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWarpSmemBudget);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    blocks = sms * per_sm;
  }
  const long long units = p.rows * p.nseg;
  const long long grid = units < blocks ? units : blocks;
  kernel<<<(unsigned)grid, kWarpThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const WarpArgs& p, int C, int smem, cudaStream_t s) {
  switch (C) {
    case 1: return launch_warp<T, 1>(p, smem, s);
    case 2: return launch_warp<T, 2>(p, smem, s);
    case 3: return launch_warp<T, 3>(p, smem, s);
    case 4: return launch_warp<T, 4>(p, smem, s);
    case 5: return launch_warp<T, 5>(p, smem, s);
    case 6: return launch_warp<T, 6>(p, smem, s);
    case 7: return launch_warp<T, 7>(p, smem, s);
    case 8: return launch_warp<T, 8>(p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

int elem_size(int dtype) { return dtype == kDtypeF32 ? 4 : dtype == kDtypeBF16 ? 2 : 0; }

}  // namespace
}  // namespace nunif

// x (B, H, W, C <= 8) fp32 or bf16 (dtype 0 / 1), delta (B, H, W) fp32, out
// (B, H, W, C) in x's type; all contiguous.  |delta| <= max_shift.
extern "C" int nunif_warp_x_bounded(int dtype, const void* x, const void* delta, void* out, int B,
                                    int H, int W, int C, int max_shift, void* stream) {
  using namespace nunif;
  const int es = elem_size(dtype);
  WarpPlan P;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > 8 || max_shift < 0 || es == 0 ||
      !warp_plan(W, C, es, max_shift, &P))
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)x | (uintptr_t)delta | (uintptr_t)out) % 16 == 0 &&
                       (long long)W * C * es % 16 == 0 && W % 4 == 0;
  const WarpArgs p{x, static_cast<const float*>(delta), out, (long long)B * H, W,
                   P.seg, P.nseg, P.halo, P.cap, aligned ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == kDtypeF32 ? launch_c<float>(p, C, P.smem, s)
                                  : launch_c<__nv_bfloat16>(p, C, P.smem, s));
}

// The launch plan for rows of W pixels of C channels of x's type (dtype 0 /
// 1) and max_shift: out[0..4] = columns a unit writes, units a row, halo
// columns, columns a stage holds, shared-memory bytes a block.
extern "C" int nunif_warp_x_plan(int W, int C, int dtype, int max_shift, int* out) {
  using namespace nunif;
  const int es = elem_size(dtype);
  WarpPlan P;
  if (W < 1 || C < 1 || C > 8 || max_shift < 0 || es == 0 || !warp_plan(W, C, es, max_shift, &P))
    return (int)cudaErrorInvalidValue;
  out[0] = P.seg;
  out[1] = P.nseg;
  out[2] = P.halo;
  out[3] = P.cap;
  out[4] = P.smem;
  return 0;
}
