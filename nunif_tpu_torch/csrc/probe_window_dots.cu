// T4: a Hopper probe of the per-window attention dot pair
//   s = q khat (N x C . C x P),  o = e vhat (N x P . P x C)
// repeated on resident operands, in bf16 (wgmma m64nNk16, fp32 sums) and
// int8 (wgmma m64nNk32 .s8, int32 sums).  (T3, the same pair streamed, is
// probe_window_ring.cu.)
//
// T4 replaces tools/microbench_mxu_dots.py:bench (Pallas kernel _mk_kernel):
// per block of 16 windows, REPS times
//   e = T(s + carry)                       (bf16)
//   e = int8 wrap((s + int(carry)) >> 7)   (int8: the int32 -> int8 cast wraps)
//   carry = carry * 0 + o[block's first window, 0, 0] * 1e-30
// and the last block's carry fills an (8, 128) output.  Every window x
// repetition runs both products, as on the TPU.  What bounds it:
// operations (the operands are read once, the products run REPS times).
//
// Design.
// - Products in the direct form on wgmma with A in registers: s = q khat
//   with q's fragments loaded once a window (ldmatrix) and khat^T as the
//   K-major B; e goes from s's accumulators straight into the A registers
//   of o = e vhat, with vhat^T as the K-major B.  Nothing passes through
//   shared memory between the products.  The token rows pad to 64 (36 of
//   64 used at N = 36); P is cut into chunks of PC columns (bf16 112, or 64
//   at C = 128; int8 64), so that s of one chunk, e and o fit the
//   registers: o accumulates over the chunks.  (bf16 chunks of 128 at C =
//   128 gave NaNs on the H100 in every plan, with every other piece of the
//   kernel unchanged; the cause was not found, and 64 is exact.)  (The transposed form, P
//   and C as M, pads less but runs n40 products whose A and B come from
//   shared memory at once, about the same time by shared-memory bytes, and
//   moves e through shared memory between the products.)
// - int8 e as A: the s32 accumulator holds columns 8 j + 2 t, + 1 of each
//   8-column chunk j, while the s8 A fragment holds k 4 t .. 4 t + 3.  The
//   pack orders vhat's rows within each 32-row block by the same map
//   (k slot 4 t + i <- column 8 (i / 2) + 2 t + i % 2, and + 16), so e
//   packs into A words without moving between lanes; int32 sums are exact
//   in any order.
// - Operands resident in shared memory: a producer thread brings each
//   window's q, khat^T and vhat^T (packed by ops/probes.py:pack_dots into
//   wgmma's K-major core matrices, planes of 16 bytes) by bulk copy into a
//   ring of stages, where they stay for the REPS repetitions.  The
//   producer is a whole warpgroup so that setmaxnreg can give the
//   consumers 240 registers (s, e and o of a chunk, q's fragments).
// - Every SM works: a block of 16 windows is split over a cluster of two
//   blocks (128 blocks at the tool's 1024 windows).  Where two windows of a
//   block fit the shared memory, each block takes 8 windows and two
//   consumer warpgroups work on two windows at once; else each takes
//   every window and half of P's chunks (each computes a partial o).  The
//   carry chain runs only through window 0: its warpgroup writes o[0, 0]
//   (its partial) of each repetition into both blocks' shared memory and
//   arrives on a barrier per repetition there; every warpgroup waits for
//   repetition r - 1's barrier before e of repetition r (once the chain
//   is done, without waiting), sums the partials in one order and steps
//   the carry itself.  The plan (dot_plan) is the library's.
// - Check output (a test hook): each window's o of the last repetition,
//   (nw, N, C) fp32, added into a zeroed tensor (one or two partials; the
//   sum of two onto zero is the same in either order).
#include "common.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

constexpr int kDotConsumers = 256;               // two warpgroups
constexpr int kDotThreads = kDotConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg: a ninth warp at launch would cap
// every thread at 168 (three warps on one SM sub-partition), where ptxas
// serialises the bf16 products for want of registers.  K1's split: with
// 232 for the consumers, the bf16 C = 128 kernel computed NaNs.
constexpr int kDotConsumerRegs = 240, kDotProducerRegs = 24;
constexpr int kDotMaxReps = 64;                     // one carry barrier a repetition
constexpr int kDotMaxStages = 4;
constexpr int kDotBlockWindows = 16;

template <typename T>
struct DotOps;
template <>
struct DotOps<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kK = 16;  // k values a wgmma step
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    WgmmaRSK<N>::mma(d, a, b, scale_d);
  }
};
template <>
struct DotOps<int8_t> {
  using Acc = int;
  static constexpr int kK = 32;
  template <int N>
  static __device__ __forceinline__ void mma(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    WgmmaS8RS<N>::mma(d, a, b, scale_d);
  }
};

// The plan of a shape: the pack's widths (kp: C padded as K; cn: C as N;
// pc: P's chunk; nch chunks), the split of a block's 16 windows over the
// cluster (psplit 1: 8 windows a block; 2: every window, half the chunks),
// the 64-row tiles of a window's tokens, the stages of the ring and the
// shared memory.
struct DotPlan {
  int kp, cn, pc, nch, psplit, mtiles, stages;
  size_t q_raw, q_bytes, kt_chunk, vt_chunk, stage_bytes, part_off, cbar_off, bar_off, total;
};

// A test hook: bf16 chunks of 128 at C = 128 (the configuration that gave
// NaNs, see the header) in place of 64, set only by
// nunif_window_dots_force_chunk128 for a sanitizer run; the path's plan
// never sets it.
int g_dot_chunk128 = 0;

// es: element bytes (2 bf16, 1 int8).  N = 0 gives the pack's widths only.
__host__ inline bool dot_plan(int es, int N, int C, int P, DotPlan* D) {
  if ((es != 1 && es != 2) || N < 0 || N > 128 || C < 1 || C > 128 || P < 1) return false;
  DotPlan d{};
  d.cn = C <= 48 ? 48 : C <= 96 ? 96 : 128;
  d.kp = es == 2 ? d.cn : (int)align_up(C, 32);
  d.pc = es == 2 && d.cn < 128 ? 112 : es == 2 && g_dot_chunk128 ? 128 : 64;
  d.nch = (P + d.pc - 1) / d.pc;
  if (N == 0) {
    *D = d;
    return true;
  }
  d.mtiles = (N + 63) / 64;
  d.q_raw = (size_t)N * d.kp * es;
  d.q_bytes = align_up(d.q_raw, 128);
  d.kt_chunk = (size_t)d.pc * d.kp * es;
  d.vt_chunk = (size_t)d.pc * d.cn * es;
  const size_t fixed = kDotMaxReps * 2 * sizeof(float) + kDotMaxReps * 8 + 2 * kDotMaxStages * 8;
  for (int split = 1; split <= 2; ++split) {
    const int per = (d.nch + split - 1) / split;
    const size_t stage = align_up(d.q_bytes + per * (d.kt_chunk + d.vt_chunk), 128);
    size_t fit = (kMaxSmem - fixed) / stage;
    if (fit > kDotMaxStages) fit = kDotMaxStages;
    // two windows at once where a window is one 64-row tile; else one
    const size_t need = split == 2 ? 1 : (d.mtiles == 1 ? 2 : 1);
    if (fit < need) continue;
    d.psplit = split;
    d.stages = (int)fit;
    d.stage_bytes = stage;
    d.part_off = stage * fit;
    d.cbar_off = d.part_off + kDotMaxReps * 2 * sizeof(float);
    d.bar_off = d.cbar_off + kDotMaxReps * 8;
    d.total = d.bar_off + 2 * kDotMaxStages * 8;
    *D = d;
    return true;
  }
  return false;
}

struct DotArgs {
  const unsigned char* q;   // planes (nw, kp / E, N, E)
  const unsigned char* kt;  // (nw, nch, kp / E, pc, E): khat^T chunks
  const unsigned char* vt;  // (nw, nch, pc / E, cn, E): vhat^T chunks
  float* out;               // (8, 128)
  float* check;             // (nw, N, C) zeroed, or null
  int nw, N, C, reps;
  int nch, psplit, mtiles, stages;
  uint32_t q_raw, q_bytes, kt_chunk, vt_chunk, stage_bytes, part_off, cbar_off, bar_off;
};

// Predicated on pred, without a branch: write v into slot (this block's
// address) and arrive on bar, in both blocks of the cluster.
__device__ __forceinline__ void publish_if(bool pred, const float* slot, const uint64_t* bar,
                                           float v) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 a;\nsetp.ne.b32 p, %0, 0;\n"
      "@p mapa.shared::cluster.u32 a, %1, 0;\n"
      "@p st.shared::cluster.f32 [a], %3;\n"
      "@p mapa.shared::cluster.u32 a, %2, 0;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [a];\n"
      "@p mapa.shared::cluster.u32 a, %1, 1;\n"
      "@p st.shared::cluster.f32 [a], %3;\n"
      "@p mapa.shared::cluster.u32 a, %2, 1;\n"
      "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [a];\n}\n" ::"r"((int)pred),
      "r"(smem_addr(slot)), "r"(smem_addr(bar)), "f"(v)
      : "memory");
}

__device__ __forceinline__ uint32_t wrap8(int v) { return (uint32_t)(uint8_t)(int8_t)v; }

// e of one P chunk into the A registers of the second product.  bf16: k16
// step kk is 8-column chunks 2 kk, 2 kk + 1 in the accumulator's order.
// int8: k32 step kk is chunks 4 kk .. 4 kk + 3, bytes in the pack's k order.
template <int PC>
__device__ __forceinline__ void e_fragments(const float (&S)[PC / 2], float cin,
                                            uint32_t (&a)[PC / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < PC / 16; ++kk) {
    const float* s = S + 8 * kk;
    a[kk][0] = pack_bf16x2(s[0] + cin, s[1] + cin);
    a[kk][1] = pack_bf16x2(s[2] + cin, s[3] + cin);
    a[kk][2] = pack_bf16x2(s[4] + cin, s[5] + cin);
    a[kk][3] = pack_bf16x2(s[6] + cin, s[7] + cin);
  }
}

template <int PC>
__device__ __forceinline__ void e_fragments(const int (&S)[PC / 2], float cin,
                                            uint32_t (&a)[PC / 32][4]) {
  const int ci = (int)cin;
  // arithmetic shift, then the wrapping int32 -> int8 cast
  auto e = [&](int v) { return wrap8((v + ci) >> 7); };
#pragma unroll
  for (int kk = 0; kk < PC / 32; ++kk) {
    const int* s = S + 16 * kk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g (h 0) and g + 8 (h 1)
      a[kk][h] = e(s[2 * h]) | e(s[2 * h + 1]) << 8 | e(s[2 * h + 4]) << 16 |
                 e(s[2 * h + 5]) << 24;
      a[kk][2 + h] = e(s[8 + 2 * h]) | e(s[9 + 2 * h]) << 8 | e(s[12 + 2 * h]) << 16 |
                     e(s[13 + 2 * h]) << 24;
    }
  }
}

template <typename T, int KP, int CN, int PC>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kDotThreads, 1)
    window_dots_wgmma(const DotArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Ops = DotOps<T>;
  using Acc = typename Ops::Acc;
  constexpr int KS = KP / Ops::kK;   // k steps of s = q khat
  constexpr int KS2 = PC / Ops::kK;  // k steps of o += e vhat, a chunk
  float* part = reinterpret_cast<float*>(smem + p.part_off);  // [rep][rank]
  uint64_t* cbar = reinterpret_cast<uint64_t*>(smem + p.cbar_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + kDotMaxStages;
  const int rank = (int)cluster_ctarank();
  const int block = blockIdx.x / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], p.mtiles);  // the warpgroups on a window
    }
    for (int r = 0; r < p.reps; ++r) mbar_init(&cbar[r], p.psplit);  // partials of o[0, 0]
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peer's barriers exist before anyone arrives on them

  const int wins = p.psplit == 1 ? kDotBlockWindows / 2 : kDotBlockWindows;
  const int win0 = block * kDotBlockWindows + (p.psplit == 1 ? rank * wins : 0);
  const int half = (p.nch + 1) / 2;
  const int ch0 = p.psplit == 1 ? 0 : rank * half;
  const int per = p.psplit == 1 ? p.nch : (rank == 0 ? half : p.nch - half);

  if (threadIdx.x >= kDotConsumers) {
    // ---- producer: one thread brings each window of this block's share
    setmaxnreg_dec<kDotProducerRegs>();
    if (threadIdx.x == kDotConsumers) {
      for (int i = 0; i < wins; ++i) {
        const int w = win0 + i, s = i % p.stages;
        mbar_wait(&empty[s], ((i / p.stages) & 1) ^ 1);  // the first round passes
        unsigned char* st = smem + (size_t)s * p.stage_bytes;
        const uint32_t kb = per * p.kt_chunk, vb = per * p.vt_chunk;
        mbar_expect_tx(&full[s], p.q_raw + kb + vb);
        bulk_copy_g2s(st, p.q + (size_t)w * p.q_raw, p.q_raw, &full[s]);
        if (per > 0) {
          bulk_copy_g2s(st + p.q_bytes, p.kt + ((size_t)w * p.nch + ch0) * p.kt_chunk, kb,
                        &full[s]);
          bulk_copy_g2s(st + p.q_bytes + kb, p.vt + ((size_t)w * p.nch + ch0) * p.vt_chunk, vb,
                        &full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes items wg, wg + 2, ... of (window,
    // 64-row tile)
    setmaxnreg_inc<kDotConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t qplane = p.N * 16;  // bytes a plane of q
    for (int it = wg; it < wins * p.mtiles; it += 2) {
      const int wi = it / p.mtiles, mt = it % p.mtiles;
      const int w = win0 + wi, s = wi % p.stages;
      mbar_wait(&full[s], (wi / p.stages) & 1);
      const unsigned char* st = smem + (size_t)s * p.stage_bytes;
      // q's fragments for rows 64 mt + 16 warp .. (rows past N read the
      // next plane or khat: finite, and only their own rows use them)
      uint32_t qf[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], st + (2 * ks + (lane >> 4)) * qplane +
                                (mt * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * 16);
      const bool chain = w % kDotBlockWindows == 0 && mt == 0;  // window 0: the carry's source
      const uint32_t kt_addr = smem_addr(st) + p.q_bytes;
      const uint32_t vt_addr = kt_addr + per * p.kt_chunk;
      float cin = 0.f;
      Acc O[CN / 2];
#pragma unroll
      for (int i = 0; i < CN / 2; ++i) O[i] = 0;
      // The A registers (qf, a) are read by the wgmmas after they issue:
      // fence_regs after each wait keeps the compiler from reusing them
      // while a product may still read them.
      uint32_t a[KS2][4] = {};
      for (int rep = 0; rep < p.reps; ++rep) {
        for (int c = 0; c < per; ++c) {
          Acc S[PC / 2];
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            Ops::template mma<PC>(
                S, qf[ks],
                wgmma_desc(kt_addr + c * p.kt_chunk + 2 * ks * (PC * 16), PC * 16, 128), ks > 0);
          wgmma_commit();
          wgmma_wait<0>();  // also the chunk before's second product: e is free
          fence_regs(S);
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) fence_regs(qf[ks]);
#pragma unroll
          for (int kk = 0; kk < KS2; ++kk) fence_regs(a[kk]);
          if (rep > 0 && c == 0) {  // the carry entering this repetition
            mbar_wait_cluster(&cbar[rep - 1], 0);
            float red = part[2 * (rep - 1)];
            if (p.psplit == 2) red += part[2 * (rep - 1) + 1];
            cin = cin * 0.f + red * 1e-30f;
          }
          e_fragments<PC>(S, cin, a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS2; ++kk)
            Ops::template mma<CN>(
                O, a[kk], wgmma_desc(vt_addr + c * p.vt_chunk + 2 * kk * (CN * 16), CN * 16, 128),
                c > 0 || kk > 0);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(O);
#pragma unroll
        for (int kk = 0; kk < KS2; ++kk) fence_regs(a[kk]);
        // o[0, 0] (lane 0 of warp 0) of window 0, or this block's partial
        publish_if(chain && warp == 0 && lane == 0, &part[2 * rep + rank], &cbar[rep], (float)O[0]);
      }
      mbar_arrive_if(&empty[s], threadIdx.x % 128 == 0);  // the window's operands are read
      if (p.check != nullptr) {
#pragma unroll
        for (int j = 0; j < CN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 64 + warp * 16 + g + 8 * h, c = 8 * j + 2 * t;
            float* dst = p.check + ((size_t)w * p.N + r) * p.C + c;
            if (r < p.N && c < p.C) atomicAdd(dst, (float)O[4 * j + 2 * h]);
            if (r < p.N && c + 1 < p.C) atomicAdd(dst + 1, (float)O[4 * j + 2 * h + 1]);
          }
        }
      }
      if (chain && rank == 0 && block == (int)gridDim.x / 2 - 1) {
        // the last block's carry after the last repetition fills the output
        mbar_wait_cluster(&cbar[p.reps - 1], 0);
        float red = part[2 * (p.reps - 1)];
        if (p.psplit == 2) red += part[2 * (p.reps - 1) + 1];
        const float fin = cin * 0.f + red * 1e-30f;
        for (int i = threadIdx.x % 128; i < 8 * 128; i += 128) p.out[i] = fin;
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while its peer may still write to it
}

template <typename T, int KP, int CN, int PC>
cudaError_t launch_dots_t(const DotArgs& p, size_t smem, cudaStream_t stream) {
  auto kernel = window_dots_wgmma<T, KP, CN, PC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.nw / kDotBlockWindows * 2, kDotThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kDotBF16 = 1;
constexpr int kDotInt8 = 2;

int dots(int dtype, DotArgs p, int P, int bw, cudaStream_t stream) {
  const int es = dtype == kDotBF16 ? 2 : dtype == kDotInt8 ? 1 : 0;
  DotPlan d;
  if (es == 0 || p.nw < 1 || p.N < 1 || bw != kDotBlockWindows || p.nw % bw || p.reps < 1 ||
      p.reps > kDotMaxReps || !dot_plan(es, p.N, p.C, P, &d))
    return (int)cudaErrorInvalidValue;
  p.nch = d.nch;
  p.psplit = d.psplit;
  p.mtiles = d.mtiles;
  p.stages = d.stages;
  p.q_raw = (uint32_t)d.q_raw;
  p.q_bytes = (uint32_t)d.q_bytes;
  p.kt_chunk = (uint32_t)d.kt_chunk;
  p.vt_chunk = (uint32_t)d.vt_chunk;
  p.stage_bytes = (uint32_t)d.stage_bytes;
  p.part_off = (uint32_t)d.part_off;
  p.cbar_off = (uint32_t)d.cbar_off;
  p.bar_off = (uint32_t)d.bar_off;
  const size_t smem = d.total;
  cudaError_t err = cudaErrorInvalidValue;
  if (es == 2) {
    if (d.kp == 96 && d.cn == 96 && d.pc == 112)
      err = launch_dots_t<__nv_bfloat16, 96, 96, 112>(p, smem, stream);
    else if (d.kp == 128 && d.cn == 128 && d.pc == 64)
      err = launch_dots_t<__nv_bfloat16, 128, 128, 64>(p, smem, stream);
    else if (d.kp == 128 && d.cn == 128 && d.pc == 128)
      err = launch_dots_t<__nv_bfloat16, 128, 128, 128>(p, smem, stream);
    else if (d.kp == 48 && d.cn == 48 && d.pc == 112)
      err = launch_dots_t<__nv_bfloat16, 48, 48, 112>(p, smem, stream);
  } else {
    if (d.kp == 96 && d.cn == 96)
      err = launch_dots_t<int8_t, 96, 96, 64>(p, smem, stream);
    else if (d.kp == 128 && d.cn == 128)
      err = launch_dots_t<int8_t, 128, 128, 64>(p, smem, stream);
    else if (d.kp == 64 && d.cn == 48)
      err = launch_dots_t<int8_t, 64, 48, 64>(p, smem, stream);
  }
  return (int)err;
}

}  // namespace
}  // namespace nunif

// T4's plan for dtype (1 bf16, 2 int8) at N tokens, width C and P: out[0..9]
// = kp, cn, pc, nch, psplit, mtiles, stages, stage bytes, shared-memory
// bytes.  N = 0 gives the pack's widths (out[0..3]) only.
extern "C" int nunif_window_dots_plan(int dtype, int N, int C, int P, int* out) {
  using namespace nunif;
  DotPlan d;
  const int es = dtype == kDotBF16 ? 2 : dtype == kDotInt8 ? 1 : 0;
  if (es == 0 || !dot_plan(es, N, C, P, &d)) return (int)cudaErrorInvalidConfiguration;
  const int v[9] = {d.kp, d.cn, d.pc, d.nch, d.psplit, d.mtiles, d.stages, (int)d.stage_bytes,
                    (int)d.total};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The test hook above: 1 plans bf16 C = 128 in chunks of 128, 0 restores
// the plan.  Returns the previous setting.
extern "C" int nunif_window_dots_force_chunk128(int on) {
  const int old = nunif::g_dot_chunk128;
  nunif::g_dot_chunk128 = on != 0;
  return old;
}

// T4.  q, kt, vt packed by ops/probes.py:pack_dots to the plan's widths;
// out (8, 128) fp32; check (nw, N, C) fp32 zeroed, or null; nw a multiple
// of bw = 16; reps <= 64.
extern "C" int nunif_window_dots_repeat(int dtype, const void* q, const void* kt, const void* vt,
                                        void* out, void* check, int nw, int N, int C, int P,
                                        int reps, int bw, void* stream) {
  nunif::DotArgs p{};
  p.q = static_cast<const unsigned char*>(q);
  p.kt = static_cast<const unsigned char*>(kt);
  p.vt = static_cast<const unsigned char*>(vt);
  p.out = static_cast<float*>(out);
  p.check = static_cast<float*>(check);
  p.nw = nw;
  p.N = N;
  p.C = C;
  p.reps = reps;
  return nunif::dots(dtype, p, P, bw, static_cast<cudaStream_t>(stream));
}
