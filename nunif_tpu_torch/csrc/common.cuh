// Shared helpers for the hand-written Hopper kernels of nunif_tpu_torch.
//
// Every kernel is templated on its element type T: __nv_bfloat16 (tensor
// cores through mma.sync, fp32 accumulation) or float (plain FMA loops; no input
// is ever rounded to bf16 or TF32 on that path).  Biases and the relative
// position bias always arrive as fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nunif {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

// An entry point returns a cudaError_t, or kDriverErrorBase + the CUresult
// of a driver call made through the runtime's entry points (K7's
// cuTensorMapEncodeTiled); errors.cu gives both their text.
constexpr int kDriverErrorBase = 100000;

template <typename T> struct IsBF16 : std::is_same<T, __nv_bfloat16> {};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value through T (the kernels' bf16 rounding points).
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max / sum over the four lanes of an mma accumulator row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16-byte global -> shared copy, asynchronous (sm_80+); pred false
// zero-fills the 16 bytes
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// ldmatrix / mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Lane l = 4g + t
// of an m16n8 accumulator holds c[0..1] at (row g, cols 2t, 2t+1) and
// c[2..3] at (row g + 8, same cols); B fragments of a (K, N) row-major
// weight are pre-arranged on the host so that lane 4g + t of the fragment
// for k-step ks and 8-column tile j holds W[16 ks + 2t + {0, 1, 8, 9}][8 j + g]
// (ops/_build.py:mma_weight_layout).  ldmatrix reads A tiles from shared
// memory, each lane naming one 16-byte row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate.
// Lane l = 4 g + t holds c[0..1] at (g, 2t..2t+1), c[2..3] at (g + 8, ...).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One MMA on 32-bit words: a k-step is 8 words (16 bf16 or 32 int8) for
// both types, so fragments are addressed alike.  Lane 4g + t holds
// A words (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B^T words
// (g, t), (g, t + 4); accumulators c[0..1] at (g, 2t..), c[2..3] at (g + 8).
template <typename T>
struct DotMma;
template <> struct DotMma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    mma_16816(c, a, b0, b1);
  }
};
template <> struct DotMma<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The block-wide GEMM of T2 on tensor cores: epi(r, c, v_c,
// v_c+1) for v = A W over every r < rows_pad and even c < n_out, Warps warps
// a block.  T = bf16: fp32 sums plus the fp32 bias (n_out,); T = int8: the
// int32 sums, which the caller scales before it adds a bias (bias unused,
// pass nullptr).  A is in
// shared memory, lda bytes a row, read by ldmatrix; W is (K, n_out) in
// fragment order (ops/_build.py:mma_weight_layout): for k-step ks (16 bf16
// or 32 int8) and 8-column tile j, lane 4g + t holds words t and t + 4 of
// column 8 j + g, one 8-byte load.  A warp owns a 16-wide column panel over
// up to MTiles row tiles, so each weight fragment feeds every row tile of
// its run; the next fragment is in flight while the current one is used.
template <typename T, int Warps, int MTiles, typename Epi>
__device__ __forceinline__ void block_gemm(const void* A, int lda, const void* __restrict__ Wg,
                                           const float* __restrict__ bias, int K, int n_out,
                                           int rows_pad, Epi epi) {
  using Acc = typename DotMma<T>::Acc;
  constexpr int kStep = 32 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mt = rows_pad / 16, ksteps = K / kStep, n8 = n_out / 8;
  // work item = (16-wide column panel, run of <= MTiles row tiles)
  const int splits = (mt + MTiles - 1) / MTiles;
  const int mper = (mt + splits - 1) / splits;
  const int items = (n_out / 16) * splits;
  const uint2* wf = static_cast<const uint2*>(Wg);
  const unsigned char* a_lane =
      static_cast<const unsigned char*>(A) + (size_t)(lane % 16) * lda + (lane / 16) * 16;
  for (int it = warp; it < items; it += Warps) {
    const int n = it / splits, m0 = (it % splits) * mper;
    const int mcount = mt - m0 < mper ? mt - m0 : mper;
    const uint2* wn = wf + (size_t)(2 * n) * 32 + lane;
    Acc acc[MTiles][2][4] = {};
    uint2 b0 = __ldg(wn), b1 = __ldg(wn + 32);
    for (int k = 0; k < ksteps; ++k) {
      uint2 c0 = b0, c1 = b1;
      if (k + 1 < ksteps) {  // next fragment in flight while this one is used
        c0 = __ldg(wn + (size_t)(k + 1) * n8 * 32);
        c1 = __ldg(wn + (size_t)(k + 1) * n8 * 32 + 32);
      }
#pragma unroll
      for (int m = 0; m < MTiles; ++m) {
        if (m < mcount) {
          uint32_t a[4];
          ldmatrix_x4(a, a_lane + (size_t)(m0 + m) * 16 * lda + k * 32);
          DotMma<T>::mma(acc[m][0], a, b0.x, b0.y);
          DotMma<T>::mma(acc[m][1], a, b1.x, b1.y);
        }
      }
      b0 = c0;
      b1 = c1;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n * 16 + j * 8 + 2 * t;
      Acc bias0 = 0, bias1 = 0;
      if constexpr (IsBF16<T>::value) {
        bias0 = __ldg(bias + c);
        bias1 = __ldg(bias + c + 1);
      }
#pragma unroll
      for (int m = 0; m < MTiles; ++m) {
        if (m < mcount) {
          const int r = (m0 + m) * 16 + g;
          epi(r, c, acc[m][j][0] + bias0, acc[m][j][1] + bias1);
          epi(r + 8, c, acc[m][j][2] + bias0, acc[m][j][3] + bias1);
        }
      }
    }
  }
}

// 4 x 4 transpose of 32-bit words within a quad (lanes 4 g .. 4 g + 3):
// lane t holds v[c] = M[t][c] and ends with v[c] = M[c][t]
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool top = (t & 2) == 0, left = (t & 1) == 0;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, top ? v[2] : v[0], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, top ? v[3] : v[1], 2);
  if (top) {
    v[2] = r0;
    v[3] = r1;
  } else {
    v[0] = r0;
    v[1] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, left ? v[1] : v[0], 1);
  r1 = __shfl_xor_sync(0xffffffffu, left ? v[3] : v[2], 1);
  if (left) {
    v[1] = r0;
    v[3] = r1;
  } else {
    v[0] = r0;
    v[2] = r1;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two adjacent elements (p is 2-element aligned)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__host__ __device__ __forceinline__ size_t align_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

}  // namespace nunif
