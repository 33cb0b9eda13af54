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
