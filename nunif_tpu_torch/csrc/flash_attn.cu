// K7: forward flash attention, softmax(q k^T * scale) v, bf16 in and out.
//
// Replaces nunif_tpu/ops/sdpa.py:_flash, which calls JAX's shipped Pallas TPU
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py) for
// DINOv2's attention (nunif_tpu/iw3/depth/dinov2.py:41).  q (B, H, N, D),
// k and v (B, H, M, D), out (B, H, N, D), each addressed by its own strides
// (the last dimension contiguous), so q, k and v are read straight out of
// the qkv projection's (B, N, 3, H, D) rows and the output is written in
// the (B, N, H, D) order the out projection reads: no copies around it.
//
// Numerics follow the twin (_xla_sdpa): fp32 scores of bf16 q and k, an fp32
// softmax, probabilities rounded to bf16 before P V, fp32 accumulation,
// one rounding of the output.  The scale is applied to the fp32 scores; for
// a power-of-two scale (1/8 at D = 64) that equals the twin's bf16 q * scale.
// Unlike the twin the softmax is online: each 64-key tile rescales the
// running sums, and the unnormalised probabilities are rounded before P V
// and divided by the row sum at the end.
//
// What bounds it on the H100: at DINOv2's N = 1373, D = 64, a (b, h) pair
// does 4 N^2 D = 483 MFLOP (Q K^T and P V) against 3 N D x 2 bytes in and
// N D x 2 out (~0.7 MB), far above the bf16 ridge, so tensor-core
// throughput and latency bound it; the plain version instead writes and
// re-reads the fp32 N x N score matrix (7.5 MB a pair).  Design: one block
// of 4 warps per (batch, head, 64-query tile); each warp owns 16 query
// rows.  Q stays in registers
// as mma.sync A fragments; K and V tiles of 64 keys are staged in shared
// memory by cp.async, two stages deep, so the next tile loads while this one
// is used.  S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate); S, the running max and sum and O never leave registers.
// Ragged tails: K/V rows >= M and Q rows >= N are zero-filled in shared
// memory, keys >= M get -inf before the running max, and rows >= N are not
// stored.  No padding is done outside the kernel.
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kFaThreads = 128;  // 4 warps x 16 query rows
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

struct FlashArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int N, M;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  float scale_log2;  // scale * log2(e): the softmax runs on exp2
};

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

// Stage rows row0 .. row0 + 63 of a (rows, D) matrix with row stride
// stride_n into shared memory (row stride D + 8); rows >= n_rows read as 0.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          long long stride_n, int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  constexpr int LD = D + 8;
  for (int e = threadIdx.x; e < kBlockK * kChunks; e += kFaThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < n_rows;
    const __nv_bfloat16* src = ok ? g + (long long)(row0 + r) * stride_n + c * 8 : g;
    cp_async16(s + r * LD + c * 8, src, ok);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr size_t flash_smem_bytes() {
  return (size_t)(kBlockQ + 4 * kBlockK) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kFaThreads) flash_attn_kernel(FlashArgs p) {
  constexpr int LD = D + 8;     // padded shared-memory row: ldmatrix without bank conflicts
  constexpr int KT = D / 16;    // 16-wide slices of the head dimension
  constexpr int STAGE = kBlockK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LD;  // two stages
  __nv_bfloat16* sV = sK + 2 * STAGE;     // two stages

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.M + kBlockK - 1) / kBlockK;

  load_tile<D>(sQ, qg, p.q_sn, q0, p.N);
  load_tile<D>(sK, kg, p.k_sn, 0, p.M);
  load_tile<D>(sV, vg, p.v_sn, 0, p.M);
  cp_async_commit();

  const float ninf = __int_as_float(0xff800000);
  uint32_t qa[KT][4];
  float o[2 * KT][4] = {};
  float m0 = ninf, m1 = ninf;  // running max of rows g and g + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;    // this lane's part of the running sums

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // next tile in flight while this one is used
      load_tile<D>(sK + (stage ^ 1) * STAGE, kg, p.k_sn, (j + 1) * kBlockK, p.M);
      load_tile<D>(sV + (stage ^ 1) * STAGE, vg, p.v_sn, (j + 1) * kBlockK, p.M);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: Q and tile j have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldmatrix_x4(qa[kk], sQ + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Ks = sK + stage * STAGE;
    const __nv_bfloat16* Vs = sV + stage * STAGE;

    // S = Q K^T: lane holds keys 8 jn + 2t + {0, 1} of rows g and g + 8
    float s[kBlockK / 8][4] = {};
#pragma unroll
    for (int jk = 0; jk < kBlockK / 16; ++jk) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t bk[4];
        const int key = jk * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bk, Ks + key * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * jk], qa[kk], bk[0], bk[1]);
        mma_16816(s[2 * jk + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // online softmax; every tile holds at least one key < M, so the new
    // max is finite
    const int kbase = j * kBlockK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jn = 0; jn < kBlockK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + jn * 8 + 2 * t + e < p.M;
        s[jn][e] = ok ? s[jn][e] * p.scale_log2 : ninf;
        s[jn][2 + e] = ok ? s[jn][2 + e] * p.scale_log2 : ninf;
        mx0 = fmaxf(mx0, s[jn][e]);
        mx1 = fmaxf(mx1, s[jn][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < kBlockK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[jn][e] = exp2f(s[jn][e] - mx0);
        s[jn][2 + e] = exp2f(s[jn][2 + e] - mx1);
        rs0 += s[jn][e];
        rs1 += s[jn][2 + e];
      }
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int nd = 0; nd < 2 * KT; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }

    // O += P V, P rounded to bf16: two adjacent 8-key accumulator tiles
    // are one 16-key A fragment
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < KT; ++nd) {
        uint32_t bv[4];
        const int key = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(bv, Vs + key * LD + nd * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * nd], pa, bv[0], bv[1]);
        mma_16816(o[2 * nd + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is overwritten by the next iteration's loads
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int nd = 0; nd < 2 * KT; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < p.N) store2(og + r0 * p.o_sn + col, o[nd][0] * inv0, o[nd][1] * inv0);
    if (r1 < p.N) store2(og + r1 * p.o_sn + col, o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

template <int D>
cudaError_t launch_flash(const FlashArgs& p, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBlockQ - 1) / kBlockQ, H, B);
  flash_attn_kernel<D><<<grid, kFaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_flash_attn(const void* q, const void* k, const void* v, void* o, int B,
                                int H, int N, int M, int D, long long q_sb, long long q_sh,
                                long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                                long long v_sb, long long v_sh, long long v_sn, long long o_sb,
                                long long o_sh, long long o_sn, float scale, void* stream) {
  using namespace nunif;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  FlashArgs p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.N = N;
  p.M = M;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // DINOv2 ViT-S/B/L all have D = 64, the one head dim built
  if (D != 64) return (int)cudaErrorInvalidValue;
  return (int)launch_flash<64>(p, B, H, s);
}
