// K7: forward flash attention, softmax(q k^T * scale) v, bf16 in and out.
//
// Replaces nunif_tpu/ops/sdpa.py:_flash, which calls JAX's shipped Pallas TPU
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py) for
// DINOv2's attention (nunif_tpu/iw3/depth/dinov2.py:41).  q (B, H, N, D),
// k and v (B, H, M, D), out (B, H, N, D), each addressed by its own strides
// (the last dimension contiguous), so q, k and v are read straight out of
// the qkv projection's (B, N, 3, H, D) rows and the output is written in
// the (B, N, H, D) order the out projection reads: no copies around it.
// D = 64 (DINOv2 ViT-S/B/L).
//
// Numerics follow the twin (_xla_sdpa): fp32 scores of bf16 q and k, an fp32
// softmax, probabilities rounded to bf16 before P V, fp32 accumulation,
// one rounding of the output.  The scale is applied to the fp32 scores; for
// a power-of-two scale (1/8 at D = 64) that equals the twin's bf16 q * scale.
// Unlike the twin the softmax is online: each 128-key tile rescales the
// running sums, and the unnormalised probabilities are rounded before P V
// and divided by the row sum at the end.
//
// What bounds it on the H100.  At DINOv2's (8, 6, 1373, 64) a launch does
// 4 B H N^2 D = 23.2 GFLOP on the tensor cores (~23 us at 989 TFLOP/s) and
// B H N^2 = 90.5 M exp2 on the SFU (16 a clock an SM on 132 SMs: ~23 us),
// and moves 33.7 MB (~10 us of HBM): the tensor cores and the exp2 pipe are
// equal work, the bytes less than half of it.  So the design keeps both
// units fed, and runs one warpgroup's exp2 while wgmmas run.
//
// Design (flash_attn_wgmma):
// - Work items are (128-query tile, h, b): at the main shape 11 x 6 x 8 =
//   528, four for each of 132 persistent blocks (one an SM; the registers
//   allow no second), dealt round robin with the query tile fastest, so
//   the blocks running at once share K and V through L2.  A block has
//   three warpgroups.  Warpgroups 0 and 1 are consumers, each owning 64
//   query rows of an item (the wgmma M); warpgroup 2 is the producer, one
//   thread of which issues the copies and runs ahead into the next item
//   (its Q and first K / V tiles land while the consumers finish the last
//   item's P V and stores), which a grid of one block per item leaves
//   exposed at every item: timed in turns in one call at the main shape,
//   20 launches back to back (`tools/ab_flash.py`; H100 80GB HBM3 at 700
//   W), one block per item ran 0.0671 ms a launch, this grid 0.0619.
//   The items of one head run side by side and read the same K / V tile
//   at about the same time; starting each query tile at another key tile
//   (to spread those reads over L2) ran slower in a trial build on the
//   H100, so every item walks the keys in order.
// - setmaxnreg gives the consumers 240 registers a thread and the producer
//   24, inside the one if / else on the warpgroup that splits the roles.
//   The block starts with the 168 a thread that __launch_bounds__
//   (384, 1) allows (64,512 of the SM's 65,536), and a warpgroup's increase
//   waits for registers that the others have released, so the split has to
//   add up to the same 64,512: 2 x 128 x 240 + 128 x 24 (a producer at 32
//   would leave the consumers 1,024 short).
// - Copies by TMA.  The host encodes one 4-D tensor map (D, rows, H, B)
//   over each operand's own strides (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPointByVersion, so no libcuda is linked), with
//   128-byte swizzle: a 64-wide bf16 row is 128 bytes, so every tile lands
//   in wgmma's 128-byte swizzled layout.  Rows past N or M are zero-filled
//   by the hardware, never read from the next head.  Q (16 KB) is copied
//   once an item, after both consumers have passed the item before's last
//   S (a "q_full" / "q_empty" mbarrier pair); K and V tiles of 128 keys (16
//   KB each) go through a ring of 3 stages, each with a "full" mbarrier
//   (TMA complete_tx) and an "empty" one on which each consumer warpgroup
//   arrives once it has read the stage.  Shared memory: 16 + 3 x 32 = 112
//   KB and 8 mbarriers.
// - S = Q K^T: four wgmma m64n128k16 (D / 16), both operands from shared
//   memory, K-major: Q as A, K as stored as B.  64 fp32 accumulators.
// - O += P V: eight wgmma m64n64k16 with P as A from registers -- the S
//   accumulators rounded to bf16 pairs are A's fragments as they lie, as in
//   FlashAttention-3 -- and V as stored (keys x D, D contiguous) as an
//   MN-major B with the transpose bit: 128-byte swizzle, SBO 1,024 bytes
//   between groups of 8 keys, one 64-wide atom along D (LBO, the next
//   atom, unused), each k16 step 2,048 bytes on.  P is final before its
//   chain starts, and stays pinned until the chain has been waited for.
//   Unlike K2's register-A chain (conv3x3.cu), whose A was reloaded by
//   ldmatrix between the wgmmas of one chain, these did not serialise:
//   ptxas reports no C751x warning here, and P never went to shared
//   memory.
// - Softmax on exp2: keys past M are set to -inf on the last key tile
//   only; each probability is one FFMA and one ex2, exp2(s * scale_log2 -
//   m * scale_log2); row max and sum across the quad of lanes of a row.  O
//   is rescaled on every tile (32 multiplies against 64 ex2 a lane; a
//   branch on whether the max moved was not kept).
// - Overlap, both steps kept:
//   (a) ping-pong: two named barriers pass a token between the consumer
//   warpgroups, so one issues its wgmmas while the other runs its softmax;
//   (b) within a warpgroup, S_j = Q K_j^T and O += P_{j-1} V_{j-1} are
//   issued together, and the softmax of tile j runs while P_{j-1} V_{j-1}
//   is still on the tensor cores (O is rescaled once that lands).  While
//   the kernel was built, each step was a template switch, timed at the
//   main shape in one call, 20 launches back to back, medians of two turns
//   (H100 80GB HBM3 at 700 W): neither 0.06615 ms a launch, (a) alone
//   0.06475, (b) alone 0.06413, both 0.06316; the four gave bit-identical
//   outputs.  Both won in every call that timed them, so the switches went.
// - Epilogue: divide by the quad-summed row sum, one bf16 rounding, and a
//   4-byte store a lane of rows < N into the strided output.
// Registers (`-Xptxas -v`, which chip_smoke.py prints): 168 a thread at
// launch (the __launch_bounds__ cap; setmaxnreg moves them after), no
// spills; 16 named barriers.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 128;  // two consumer warpgroups x 64 rows
constexpr int kBlockK = 128;
constexpr int kStages = 3;
constexpr int kThreads = 384;  // consumers 0, 1; producer 2
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr uint32_t kRowBytes = kHeadDim * 2;  // 128: one swizzle row
constexpr uint32_t kTileBytes = kBlockK * kRowBytes;
constexpr uint32_t kQBytes = kBlockQ * kRowBytes;
constexpr uint32_t kVStepBytes = 16 * kRowBytes;  // 16 keys: one k16 step of P V
// Q, the K ring, the V ring, the mbarriers; 1 KB of slack to align the base
constexpr size_t kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + (2 * kStages + 2) * 8;

struct FlashParams {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_sn;
  int B, H, N, M;
  float scale_log2;  // scale * log2(e): the softmax runs on exp2
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one consumer: four k16 steps, committed as one group
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    WgmmaSS<128>::mma(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);  // 32 bytes a step
  wgmma_commit();
}

// O += P V: eight k16 steps of 16 keys, committed as one group
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[8][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    WgmmaRS<64>::mma(o, pa[kk], v_desc + kk * (kVStepBytes >> 4), 1);
  wgmma_commit();
}

// Online softmax of one S tile in place: s becomes the unnormalised
// probabilities exp2((s - m) * scale_log2) of rows g and g + 8; m and l are
// the running max (raw score units) and this lane's part of the running
// sums; c the factors that rescale the previous O and l.  Keys >= M are
// masked when `mask` (the last tile); every tile holds a key < M, so the
// new max is finite.
__device__ __forceinline__ void softmax_tile(float (&s)[64], bool mask, int key0, int M, int t,
                                             float sl2, float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1) {
  const float ninf = __int_as_float(0xff800000);
  if (mask) {
#pragma unroll
    for (int jc = 0; jc < kBlockK / 8; ++jc)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * jc + 2 * t + e >= M) {
          s[4 * jc + e] = ninf;
          s[4 * jc + 2 + e] = ninf;
        }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int jc = 0; jc < kBlockK / 8; ++jc) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jc], s[4 * jc + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jc + 2], s[4 * jc + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  c0 = ex2((m0 - mx0) * sl2);  // 0 on the first tile (m = -inf)
  c1 = ex2((m1 - mx1) * sl2);
  m0 = mx0;
  m1 = mx1;
  const float b0 = -mx0 * sl2, b1 = -mx1 * sl2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int jc = 0; jc < kBlockK / 8; ++jc) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * jc + e] = ex2(fmaf(s[4 * jc + e], sl2, b0));
      s[4 * jc + 2 + e] = ex2(fmaf(s[4 * jc + 2 + e], sl2, b1));
      rs0 += s[4 * jc + e];
      rs1 += s[4 * jc + 2 + e];
    }
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// the probabilities rounded to bf16 as P V's A fragments: k16 step kk is
// the accumulator chunks 2 kk and 2 kk + 1
__device__ __forceinline__ void to_fragments(const float (&s)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void pin(float (&s)[64], float (&o)[32], uint32_t (&pa)[8][4]) {
  fence_regs(s);
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) fence_regs(pa[kk]);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FlashParams p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle atoms want a 1,024-aligned base
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kQBytes;
  unsigned char* sV = sK + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;

  // work items (query tile, h, b), query tile fastest, dealt round robin
  // to the persistent blocks
  const int n_qt = (p.N + kBlockQ - 1) / kBlockQ;
  const int items = n_qt * p.H * p.B;
  const int n_tiles = (p.M + kBlockK - 1) / kBlockK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps Q and the ring full, running ahead
    // into the next item while the consumers finish this one
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int tile = 0, n_item = 0;  // key tiles and items this block has loaded
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++n_item) {
        const int qt = it % n_qt, h = it / n_qt % p.H, b = it / n_qt / p.H;
        mbar_wait(q_empty, (n_item & 1) ^ 1);  // the previous Q has been read
        mbar_expect_tx(q_full, kQBytes);
        tma_load_4d(sQ, &tm_q, 0, qt * kBlockQ, h, b, q_full);
        for (int j = 0; j < n_tiles; ++j, ++tile) {
          const int s = tile % kStages;
          mbar_wait(&empty[s], ((tile / kStages) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(&full[s], 2 * kTileBytes);
          tma_load_4d(sK + s * kTileBytes, &tm_k, 0, j * kBlockK, h, b, &full[s]);
          tma_load_4d(sV + s * kTileBytes, &tm_v, 0, j * kBlockK, h, b, &full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows 64 wg .. + 63 of a tile
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;
    const uint64_t q_desc = wgmma_desc_sw128(smem_addr(sQ) + wg * 64 * kRowBytes, 16, 1024);
    const uint64_t k_desc = wgmma_desc_sw128(smem_addr(sK), 16, 1024);
    const uint64_t v_desc = wgmma_desc_sw128(smem_addr(sV), kTileBytes, 1024);
    constexpr uint32_t kStageStep = kTileBytes >> 4;  // descriptor units
    // ping-pong: warpgroup w waits on barrier 1 + w for its turn to issue
    // and hands the turn over on the other's; warpgroup 1 starts it, and
    // skips its last hand-over, which nobody would wait for
    auto turn_begin = [&]() { named_bar_sync(1 + wg, 256); };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1)) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);

    const bool ragged = p.M % kBlockK != 0;
    float s[64], o[32];
    uint32_t pa[8][4];
    int tile = 0, n_item = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++n_item) {
      const int qt = it % n_qt, h = it / n_qt % p.H, b = it / n_qt / p.H;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m0 = __int_as_float(0xff800000), m1 = m0, l0 = 0.f, l1 = 0.f, c0, c1;

      // key tile 0: S, softmax, P
      int prev = tile % kStages;
      mbar_wait(q_full, n_item & 1);
      mbar_wait(&full[prev], (tile / kStages) & 1);
      turn_begin();
      wgmma_fence();
      issue_s(s, q_desc, k_desc + prev * kStageStep);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      if (n_tiles == 1 && leader) mbar_arrive(q_empty);  // the item's last S has read Q
      softmax_tile(s, ragged && n_tiles == 1, 0, p.M, t, p.scale_log2, m0, m1, l0, l1, c0, c1);
      to_fragments(s, pa);
      ++tile;

      for (int j = 1; j < n_tiles; ++j, ++tile) {
        const int stage = tile % kStages;
        mbar_wait(&full[stage], (tile / kStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_s(s, q_desc, k_desc + stage * kStageStep);
        issue_pv(o, pa, v_desc + prev * kStageStep);
        turn_end(false);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
        fence_regs(s);
        if (j == n_tiles - 1 && leader) mbar_arrive(q_empty);
        softmax_tile(s, ragged && j == n_tiles - 1, j * kBlockK, p.M, t, p.scale_log2, m0, m1,
                     l0, l1, c0, c1);
        wgmma_wait<0>();
        pin(s, o, pa);
        if (leader) mbar_arrive(&empty[prev]);  // done with K / V of tile j - 1
#pragma unroll
        for (int jc = 0; jc < kHeadDim / 8; ++jc) {
          o[4 * jc] *= c0;
          o[4 * jc + 1] *= c0;
          o[4 * jc + 2] *= c1;
          o[4 * jc + 3] *= c1;
        }
        to_fragments(s, pa);
        prev = stage;
      }
      turn_begin();
      wgmma_fence();
      issue_pv(o, pa, v_desc + prev * kStageStep);
      turn_end(it + (int)gridDim.x >= items);
      wgmma_wait<0>();
      pin(s, o, pa);
      if (leader) mbar_arrive(&empty[prev]);

      // epilogue: rows < N of the strided output
      const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
      const int r0 = qt * kBlockQ + wg * 64 + warp * 16 + g, r1 = r0 + 8;
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int jc = 0; jc < kHeadDim / 8; ++jc) {
        const int col = jc * 8 + 2 * t;
        if (r0 < p.N) store2(og + r0 * p.o_sn + col, o[4 * jc] * inv0, o[4 * jc + 1] * inv0);
        if (r1 < p.N) store2(og + r1 * p.o_sn + col, o[4 * jc + 2] * inv1, o[4 * jc + 3] * inv1);
      }
    }
  }
}

// 4-D map (D, rows, H, B) of a bf16 operand with element strides sn, sh,
// sb; a box is box_rows x D.  A dimension of extent 1 is never stepped,
// so its stride is given as one row of D (any stride TMA accepts).
int encode(CUtensorMap* map, const void* ptr, int rows, int H, int B, long long sb, long long sh,
           long long sn, int box_rows) {
  const Encoder& enc = encoder();
  if (enc.err != cudaSuccess) return (int)enc.err;
  const auto bytes = [](int extent, long long stride) {
    return (cuuint64_t)(extent == 1 ? kRowBytes : stride * 2);
  };
  const cuuint64_t dims[4] = {kHeadDim, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(rows, sn), bytes(H, sh), bytes(B, sb)};
  const cuuint32_t box[4] = {kHeadDim, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc.fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + (int)r;
}

cudaError_t launch_flash(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const FlashParams& p, cudaStream_t stream) {
  auto kernel = flash_attn_wgmma;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one persistent block an SM (registers allow no second), none idle
  const long long items = (long long)((p.N + kBlockQ - 1) / kBlockQ) * p.H * p.B;
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(tq, tk, tv, p);
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
  // DINOv2 ViT-S/B/L all have D = 64, the one head dim built
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || D != kHeadDim)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, N, H, B, q_sb, q_sh, q_sn, kBlockQ);
  if (rc == 0) rc = encode(&tk, k, M, H, B, k_sb, k_sh, k_sn, kBlockK);
  if (rc == 0) rc = encode(&tv, v, M, H, B, v_sb, v_sh, v_sn, kBlockK);
  if (rc != 0) return rc;
  FlashParams p{};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_sn = o_sn;
  p.B = B;
  p.H = H;
  p.N = N;
  p.M = M;
  p.scale_log2 = scale * 1.4426950408889634f;
  return (int)launch_flash(tq, tk, tv, p, static_cast<cudaStream_t>(stream));
}
