// Hopper-only helpers (sm_90a): wgmma with A from shared memory or from
// registers, the operands' descriptors, mbarriers, bulk and tensor (TMA)
// copies that signal one, tensor stores, named barriers and setmaxnreg.
//
// wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate) is issued by the four
// warps of a warpgroup together and runs asynchronously: a chain of them
// into one accumulator is issued back to back, then committed and waited
// for.  The fp32 accumulator d[N / 2] of lane 4 g + t in warp w holds, for
// each 8-column chunk j, d[4 j], d[4 j + 1] at (row 16 w + g, columns
// 8 j + 2 t, + 1) and d[4 j + 2], d[4 j + 3] at row 16 w + g + 8.  With A
// in registers (WgmmaRS), lane 4 g + t of warp w holds the 64 x 16 A tile
// as four bf16 pairs: (row 16 w + g, columns 2 t, + 1), (row + 8, same),
// (row, columns 2 t + 8, + 9), (row + 8, same) -- the accumulator layout of
// two adjacent 8-column chunks, so a product's accumulator becomes the next
// product's A without moving between lanes.
//
// Operands in shared memory are described by a 64-bit descriptor (start
// address, leading and stride byte offsets (LBO, SBO), layout type):
// - Unswizzled K-major (wgmma_desc, layout type 0): 8 x 8 "core matrices"
//   of 128 contiguous bytes (8 rows, or columns, of 8 k values, 16 bytes
//   each); LBO steps between the two core matrices of a k16 step along K,
//   SBO between groups of 8 rows (columns) along M (N).
// - 128-byte swizzled (wgmma_desc_sw128, layout type 1), the layout a TMA
//   copy with CU_TENSOR_MAP_SWIZZLE_128B writes for rows of 128 bytes (64
//   bf16): row r lies at 128 r bytes with its 16-byte chunk c stored at
//   chunk c ^ (r % 8), in atoms of 8 rows (1,024 bytes, 1,024-aligned).
//   K-major (rows along M or N, the 64 k values of a row contiguous): SBO
//   = 1,024 bytes between 8-row groups; LBO unused; k16 step s starts 32 s
//   bytes into the row (the hardware applies the swizzle to the address).
//   MN-major (rows along K, the 64 m or n values of a row contiguous, with
//   the transpose bit set): SBO = 1,024 bytes between groups of 8 k rows,
//   LBO between 64-wide atoms along M or N; k16 step s starts 2,048 s bytes
//   on.
//
// The WgmmaSS<N> / WgmmaRS<N> specialisations below differ only in the
// accumulator list; they are written out for the widths the kernels
// instantiate.
#pragma once

#include <stdint.h>

namespace nunif {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor, layout type 0 (no swizzle): start
// address, LBO and SBO in 16-byte units.  The start address is the low
// field, so adding n to the descriptor moves it by 16 n bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// 128-byte swizzled layout (type 1): see the header; addr 1,024-aligned
// for the atom's base, or moved from one by whole k16 steps
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return wgmma_desc(addr, lbo, sbo) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// Pin accumulator registers across the asynchronous wgmma (the compiler
// must not move them while a wgmma may still write them).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// order this thread's earlier generic-proxy writes to shared memory (plain
// stores, cp.async) before later async-proxy reads (wgmma operands, bulk
// copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive when pred holds, without a branch (a divergent path while a
// wgmma is in flight makes ptxas serialize the wgmmas)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine; completion is counted on bar
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from shared to
// global memory by the copy engine, in this thread's current bulk group.
// The writes of other threads to src must be ordered before it
// (fence_proxy_async, then a barrier).
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// from global to shared memory, as tma_load_4d
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tensor_map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost first,
// from global to shared memory by the TMA unit; completion is counted on
// bar.  Parts of the box outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tensor_map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// box of a 5-D tensor map at (c0 .. c4), innermost first, from global to
// shared memory, as tma_load_4d
__device__ __forceinline__ void tma_load_5d(void* dst, const void* tensor_map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_addr(bar))
      : "memory");
}

// box of a 5-D tensor map at (c0 .. c4) from shared to global memory by
// the TMA unit, in this thread's current bulk group; parts of the box
// outside the tensor are not written.  The writes of other threads to src
// must be ordered before it (fence_proxy_async, then a barrier).
__device__ __forceinline__ void tma_store_5d(const void* tensor_map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4, %5}], [%6];\n" ::"l"(reinterpret_cast<uint64_t>(tensor_map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_addr(src))
      : "memory");
}

// close this thread's bulk group; wait until at most Pending of its groups
// are still reading shared memory (read) or not yet complete
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(Pending) : "memory");
}
template <int Pending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// named barrier id (1-15) over `threads` threads: sync waits until all
// have come, arrive counts this warp in and goes on
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// move registers between warpgroups: every warp of the warpgroup runs it
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (+)= A (64 x 16) * B (16 x N), both in shared memory, described by
// desc_a and desc_b; scale_d 0 overwrites d.
template <int N>
struct WgmmaSS;

template <> struct WgmmaSS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <> struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// d (+)= A (64 x 16, in registers, see the header) * B (16 x N) in shared
// memory, B read MN-major (transpose bit set): the bf16 layout of a
// (keys, N) tile stored row by row, as V is
template <int N>
struct WgmmaRS;

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

}  // namespace nunif
