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
// c[2..3] at (row g + 8, same cols).  ldmatrix reads A tiles from shared
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
