// T3: a Hopper probe of the per-window attention dot pair, streamed
//   (N, C) . (C, P)  then  (N, P) . (P, Cout)
// in bf16 (mma.sync m16n8k16, fp32 accumulation) and int8 (mma.sync
// m16n8k32, int32 accumulation).
//
// Replaces tools/microbench_int8_attn.py:bench (Pallas kernels
// _kernel_bf16, _kernel_int8).  Per window, from device memory:
//   bf16: s = q khat;  e = bf16(exp2(max(s - rowmax s, -100)));
//         out = bf16((e vhat)[:, :Cout])
//   int8: s = (q khat) / 127^2 (int32 sums);  e = exp2(max(s - rowmax, -100));
//         e8 = int8(round(e 127));  out = bf16((e8 vhat)[:, :Cout] / 127^2)
// with Cout = C, the roundings of the first design (exp2f,
// __float2bfloat16_rn, rintf(e * 127)) and its order of k-steps, so the
// outputs are bit for bit the same.
//
// What bounds it on the H100: bytes.  At the tool's shapes (N 36, C 96,
// P 216, vhat 104 wide, 14720 windows) a window moves 100,224 bytes in
// bf16 (53,568 in int8, bf16 out) for 3.1 MFLOP: 1.475 / 0.789 GB a call,
// 0.440 / 0.235 ms at 3.35 TB/s, against 0.046 ms of products.  Design:
// - A persistent grid, one block an SM, each striding over the windows.
//   Each window's q, khat and vhat come into a ring of 2-4 stages (as many
//   as fit: 2 in bf16, 4 in int8) by cp.async.bulk, completion counted on
//   the stage's full mbarrier, by one producer thread (warp 8); the
//   consumers release a stage on its empty mbarrier.  Each
//   operand of a window is contiguous: one bulk copy where its dense rows
//   suit the reads, else one TMA copy through a 3-D tensor map (columns,
//   rows, windows) whose box is 16 bytes wider than the row (q at C = 96),
//   the columns past the edge reading as zeros.  Three copies a window: a
//   copy a row cost more to issue than the window took to compute.
// - Two groups of four consumer warps take the windows in turns, so one
//   group's softmax runs beside the other's MMAs (with every warp on one
//   window, the tensor pipe idled through the softmax and the exp2 pipe
//   through the products).  They compute from the untransposed layouts.
//   The A operands (q, e) come by ldmatrix, the bf16 B operands (khat (C,
//   P), vhat (P, Cv), rows along K) by ldmatrix.trans.  int8 has no
//   transposing ldmatrix and wgmma's s8 form wants a K-major B, which khat
//   and vhat are not, so int8 feeds mma.sync m16n8k32 with B fragments put
//   together by prmt: a lane reads one word (4 columns) of each of four rows
//   and transposes the 4 x 4 bytes, which gives it one column's fragment
//   word in four tiles; so four tiles interleave a 32-column block (lane
//   group g of tile j holds column 4 g + j).  The int32 sums are exact in
//   any column order; a lane's 8 output columns are adjacent and leave as
//   one 16-byte store.
// - Work: in the first product a warp owns its columns of s over every row
//   tile (N <= 48; bf16 up to four 16-column panels, int8 up to two
//   32-column blocks; P <= 256) and keeps them in registers; the row maxima
//   meet in shared memory across the group's warps; e is rounded into the
//   stage over khat, which the first product has read.  The second
//   product's items are 16-column panels over every row tile (bf16) or (row
//   tile, 32-column block) (int8), so each B fragment feeds several MMAs.
// - Bank conflicts: a row stride of an odd number of 16-byte units keeps
//   ldmatrix's eight rows on distinct banks.  Dense rows that are an even
//   number (q's 192 bytes in bf16, 96 in int8; vhat's 224 at Cv = 112) come
//   through the wider box.  int8's word reads
//   (lane t on rows 4 t + i) fall on distinct banks at the tool's widths.
// - Pad rows (q and e past N) and pad columns (k past C and P) are zeros
//   that no copy overwrites.
#include <cuda.h>

#include <climits>

#include "common.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace nunif {
namespace {

// two groups of four consumer warps take the windows in turns
constexpr int kRingGroups = 2;
constexpr int kRingGroupWarps = 4;
constexpr int kRingConsumerWarps = kRingGroups * kRingGroupWarps;
constexpr int kRingThreads = (kRingConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kRingMaxStages = 4;
constexpr int kRingMaxMTiles = 3;  // N <= 48
constexpr int kRingTiles = 8;      // 8-column tiles of s a warp holds
constexpr int kRingMaxP = kRingGroupWarps * kRingTiles * 8;  // 256
constexpr double kInt8Scale = 1.0 / (127.0 * 127.0);

struct RingArgs {
  const void* q;     // (nw, N, C)
  const void* khat;  // (nw, C, P)
  const void* vhat;  // (nw, P, Cv)
  __nv_bfloat16* out;  // (nw, N, Cout)
  int nw, N, C, P, Cv, Cout;
  int m_tiles, c_pad, p_pad;  // N in 16-row tiles; C and P padded to whole k-steps
  int lq, lk, lv, le;         // shared row strides of q, khat, vhat, e, bytes
  int q_whole, k_whole, v_whole;  // 1: one bulk copy of dense rows; 0: a TMA box
  int stages, stage_bytes, k_off, v_off, ring_off, smem;
};

// the bars: full[kRingMaxStages], empty[kRingMaxStages]; then the row
// maxima of each consumer warp: kRingConsumerWarps x 48 floats
constexpr int kRingBarBytes = 2 * kRingMaxStages * 8;
constexpr int kRingRowMaxBytes = kRingConsumerWarps * 16 * kRingMaxMTiles * 4;

inline int align_to(long long v, int a) { return (int)((v + a - 1) / a * a); }

// row bytes -> a stride of an odd number of 16-byte units, at least `least`
inline int odd_units(int bytes, int least) {
  int s = align_to(bytes > least ? bytes : least, 16);
  return (s / 16) % 2 ? s : s + 16;
}

// Strides, pads and the shared-memory layout; false for a shape the kernel
// does not take.
template <typename T>
bool ring_plan(RingArgs& p) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int es = sizeof(T), kstep = 32 / es;
  if (p.nw < 1 || p.N < 1 || p.N > 16 * kRingMaxMTiles || p.C < 1 || p.C > 256 || p.P < 1 ||
      p.P > kRingMaxP || p.Cout < 8 || p.Cout % 8 || p.Cout > p.Cv || p.Cout > kRingMaxP)
    return false;
  const int rq = p.C * es, rk = p.P * es, rv = p.Cv * es;
  // q's rows by bulk copy; bf16 B rows by ldmatrix.trans (16-byte
  // aligned), int8 B rows by words
  if (rq % 16 || (kInt8 ? rk % 4 || rv % 4 : rk % 16 || rv % 16)) return false;
  // each window of each operand starts 16-byte aligned
  if ((long long)p.C * rk % 16 || (long long)p.P * rv % 16) return false;
  p.m_tiles = (p.N + 15) / 16;
  p.c_pad = align_to(p.C, kstep);
  p.p_pad = align_to(p.P, kstep);
  p.lq = odd_units(rq, p.c_pad * es);
  p.le = odd_units(p.p_pad * es, 0);
  // int8 B fragments come by word reads: dense rows serve
  p.lk = kInt8 ? rk : odd_units(rk, 0);
  p.lv = kInt8 ? rv : odd_units(rv, 0);
  p.q_whole = p.lq == rq;
  p.k_whole = p.lk == rk;
  p.v_whole = p.lv == rv;
  // a TMA box is at most 256 elements wide
  if ((!p.q_whole && p.lq > 256 * es) || (!p.k_whole && p.lk > 256 * es) ||
      (!p.v_whole && p.lv > 256 * es))
    return false;
  const int n_pad = 16 * p.m_tiles;
  // reads past the last row of khat (panels beyond P) and of vhat (columns
  // beyond Cout) stay inside the stage: 32 bytes of slack after each.  e
  // takes khat's place once the first product has read it.
  const long long k_bytes = (long long)p.c_pad * p.lk + 32, e_bytes = (long long)n_pad * p.le;
  p.k_off = align_to((long long)n_pad * p.lq, 128);
  p.v_off = align_to(p.k_off + (k_bytes > e_bytes ? k_bytes : e_bytes), 128);
  p.stage_bytes = align_to(p.v_off + (long long)p.p_pad * p.lv + 32, 128);
  p.ring_off = align_to(kRingBarBytes + kRingRowMaxBytes, 128);
  p.stages = (int)((kMaxSmem - p.ring_off) / p.stage_bytes);
  p.stages = p.stages > kRingMaxStages ? kRingMaxStages : p.stages;
  p.smem = p.ring_off + p.stages * p.stage_bytes;
  return p.stages >= 1;
}

// bf16: B fragments of the 16-column panel at n0 for k-step ks of a (K, N)
// row-major operand with `ld` bytes a row, by ldmatrix.trans: b[0], b[1]
// of the tile of columns n0 .. n0 + 7, b[2], b[3] of the next.
__device__ __forceinline__ void b_panel_bf16(uint32_t (&b)[4], const unsigned char* B, int ld,
                                             int ks, int n0, int lane) {
  ldmatrix_x4_trans(b, B + (size_t)(16 * ks + lane % 16) * ld + (n0 + (lane / 16) * 8) * 2);
}

// int8: B fragments of four 8-column tiles that interleave the 32-column
// block at n0 of a (K, N) row-major operand: lane group g of tile j holds
// column n0 + 4 g + j.  A lane reads the words at columns n0 + 4 g .. + 3 of
// its eight rows of k-step ks (32 ks + 4 t + i, and + 16) and transposes
// their 4 x 4 bytes: b[j][0], b[j][1] of tile j.
__device__ __forceinline__ void b_block_int8(uint32_t (&b)[4][2], const unsigned char* B, int ld,
                                             int ks, int n0, int lane) {
  const unsigned char* p = B + (size_t)(32 * ks + 4 * (lane & 3)) * ld + n0 + 4 * (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* r = p + (size_t)16 * h * ld;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r + ld);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(r + 2 * ld);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(r + 3 * ld);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    b[0][h] = __byte_perm(t0, t2, 0x5410);
    b[1][h] = __byte_perm(t0, t2, 0x7632);
    b[2][h] = __byte_perm(t1, t3, 0x5410);
    b[3][h] = __byte_perm(t1, t3, 0x7632);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRingThreads, 1)
    window_dots_ring_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const RingArgs p) {
  extern __shared__ __align__(128) unsigned char sm[];
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int es = sizeof(T);
  using Acc = typename DotMma<T>::Acc;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kRingMaxStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // zeros under every pad, once: the copies never write there
  for (int i = threadIdx.x * 16; i < p.smem - p.ring_off; i += kRingThreads * 16)
    *reinterpret_cast<uint4*>(sm + p.ring_off + i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRingGroupWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kRingConsumerWarps) {  // the producer
    if (lane != 0) return;
    const uint32_t bytes = (uint32_t)p.N * (p.q_whole ? p.C * es : p.lq) +
                           (uint32_t)p.C * (p.k_whole ? p.P * es : p.lk) +
                           (uint32_t)p.P * (p.v_whole ? p.Cv * es : p.lv);
    const size_t qb = (size_t)p.C * es, kb = (size_t)p.P * es, vb = (size_t)p.Cv * es;
    int k = 0;
    for (int w = blockIdx.x; w < p.nw; w += gridDim.x, ++k) {
      const int s = k % p.stages;
      if (k >= p.stages) mbar_wait(&empty[s], (k / p.stages - 1) & 1);
      unsigned char* st = sm + p.ring_off + s * p.stage_bytes;
      mbar_expect_tx(&full[s], bytes);
      const unsigned char* q = static_cast<const unsigned char*>(p.q) + (size_t)w * p.N * qb;
      const unsigned char* kh = static_cast<const unsigned char*>(p.khat) + (size_t)w * p.C * kb;
      const unsigned char* vh = static_cast<const unsigned char*>(p.vhat) + (size_t)w * p.P * vb;
      if (p.q_whole) bulk_copy_g2s(st, q, (uint32_t)(p.N * qb), &full[s]);
      else tma_load_3d(st, &tm_q, 0, 0, w, &full[s]);
      if (p.k_whole) bulk_copy_g2s(st + p.k_off, kh, (uint32_t)(p.C * kb), &full[s]);
      else tma_load_3d(st + p.k_off, &tm_k, 0, 0, w, &full[s]);
      if (p.v_whole) bulk_copy_g2s(st + p.v_off, vh, (uint32_t)(p.P * vb), &full[s]);
      else tma_load_3d(st + p.v_off, &tm_v, 0, 0, w, &full[s]);
    }
    return;
  }

  // the consumers: group gi takes the block's windows gi, gi + 2, ...; its
  // warp gw holds eight 8-column tiles of s: bf16, the 16-column panels
  // gw + 4 i (i < 4); int8, the interleaved 32-column blocks gw + 4 i
  // (i < 2)
  const int gi = warp / kRingGroupWarps, gw = warp % kRingGroupWarps;
  const int bar1 = 1 + 2 * gi, bar2 = 2 + 2 * gi, group_threads = 32 * kRingGroupWarps;
  float* row_max = reinterpret_cast<float*>(sm + kRingBarBytes) +
                   gi * kRingGroupWarps * 16 * kRingMaxMTiles;  // [gw][row]
  const int g = lane >> 2, t = lane & 3;
  const int ks1 = p.c_pad * es / 32, ks2 = p.p_pad * es / 32;  // k-steps of the products
  const int groups1 = p.p_pad / (kInt8 ? 32 : 16);             // panels / blocks of s
  const int groups2 = (p.Cout + (kInt8 ? 31 : 15)) / (kInt8 ? 32 : 16);  // ... of out
  const float s_scale = kInt8 ? (float)kInt8Scale : 1.f;
  // the panel (bf16) or block (int8) of tile j, and whether it exists
  auto group_of = [&](int j) { return gw + kRingGroupWarps * (kInt8 ? j >> 2 : j >> 1); };
  auto owns = [&](int j) { return group_of(j) < groups1; };
  // the column of element e (0, 1) of tile j in this lane
  auto col = [&](int j, int e) {
    return kInt8 ? 32 * group_of(j) + 8 * t + 4 * e + (j & 3)
                 : 16 * group_of(j) + 8 * (j & 1) + 2 * t + e;
  };
  int k = gi;
  for (int w = blockIdx.x + gi * gridDim.x; w < p.nw; w += kRingGroups * gridDim.x,
           k += kRingGroups) {
    const int s = k % p.stages;
    mbar_wait(&full[s], (k / p.stages) & 1);
    unsigned char* st = sm + p.ring_off + s * p.stage_bytes;

    // 1. s = q khat over every row tile
    Acc acc[kRingMaxMTiles][kRingTiles][4] = {};
    for (int ks = 0; ks < ks1; ++ks) {
      uint32_t a[kRingMaxMTiles][4], b[kRingTiles][2];
#pragma unroll
      for (int mi = 0; mi < kRingMaxMTiles; ++mi)
        if (mi < p.m_tiles)
          ldmatrix_x4(a[mi], st + (size_t)(16 * mi + lane % 16) * p.lq + 32 * ks + (lane / 16) * 16);
      if constexpr (kInt8) {
#pragma unroll
        for (int bi = 0; bi < kRingTiles / 4; ++bi)
          if (owns(4 * bi)) {
            uint32_t r[4][2];
            b_block_int8(r, st + p.k_off, p.lk, ks, 32 * group_of(4 * bi), lane);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[4 * bi + j][0] = r[j][0], b[4 * bi + j][1] = r[j][1];
          }
      } else {
#pragma unroll
        for (int pi = 0; pi < kRingTiles / 2; ++pi)
          if (owns(2 * pi)) {
            uint32_t r[4];
            b_panel_bf16(r, st + p.k_off, p.lk, ks, 16 * group_of(2 * pi), lane);
            b[2 * pi][0] = r[0];
            b[2 * pi][1] = r[1];
            b[2 * pi + 1][0] = r[2];
            b[2 * pi + 1][1] = r[3];
          }
      }
#pragma unroll
      for (int j = 0; j < kRingTiles; ++j)
        if (owns(j))
#pragma unroll
          for (int mi = 0; mi < kRingMaxMTiles; ++mi)
            if (mi < p.m_tiles) DotMma<T>::mma(acc[mi][j], a[mi], b[j][0], b[j][1]);
    }

    // 2. the row maxima over columns < P: a warp's own, then across the
    //    group's warps (int8: of the int32 sums, whose order the scaling keeps)
#pragma unroll
    for (int mi = 0; mi < kRingMaxMTiles; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = __int_as_float(0xff800000);
        if constexpr (kInt8) {
          int mx = INT_MIN;
#pragma unroll
          for (int j = 0; j < kRingTiles; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (owns(j) && col(j, e) < p.P) mx = max(mx, acc[mi][j][2 * h + e]);
          if (mx != INT_MIN) m = __fmul_rn((float)mx, s_scale);
        } else {
#pragma unroll
          for (int j = 0; j < kRingTiles; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (owns(j) && col(j, e) < p.P) m = fmaxf(m, acc[mi][j][2 * h + e]);
        }
        m = quad_max(m);
        if (t == 0 && mi < p.m_tiles) row_max[gw * 16 * kRingMaxMTiles + 16 * mi + 8 * h + g] = m;
      }
    named_bar_sync(bar1, group_threads);

    // 3. e, rounded into E over khat (read by now; zero past P and past N
    //    within the row tiles of rows < N)
    unsigned char* E = st + p.k_off;
#pragma unroll
    for (int mi = 0; mi < kRingMaxMTiles; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // eight rows past N feed only output rows that are dropped
        if (mi >= p.m_tiles || 16 * mi + 8 * h >= p.N || !owns(0)) continue;
        const int r = 16 * mi + 8 * h + g;
        float m = row_max[r];
#pragma unroll
        for (int ww = 1; ww < kRingGroupWarps; ++ww)
          m = fmaxf(m, row_max[ww * 16 * kRingMaxMTiles + r]);
        unsigned char* er = E + (size_t)r * p.le;
#pragma unroll
        for (int jb = 0; jb < kRingTiles; jb += 4) {
          if (!owns(jb)) continue;
          float ev[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const Acc a = acc[mi][jb + j][2 * h + e];
              float v;
              if constexpr (kInt8) {
                v = __fmul_rn((float)a, s_scale);  // not fused with the subtraction
              } else {
                v = a;
              }
              ev[j][e] = (r < p.N && owns(jb + j) && col(jb + j, e) < p.P)
                             ? exp2f(fmaxf(v - m, -100.f))
                             : 0.f;
            }
          if constexpr (kInt8) {  // columns col(jb, e) .. + 3: one word each
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uint32_t word = 0;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                word |= (uint32_t)(uint8_t)(int8_t)rintf(ev[j][e] * 127.f) << (8 * j);
              *reinterpret_cast<uint32_t*>(er + col(jb, e)) = word;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (owns(jb + j))
                *reinterpret_cast<uint32_t*>(er + 2 * col(jb + j, 0)) =
                    pack_bf16x2(ev[j][0], ev[j][1]);
          }
        }
      }
    named_bar_sync(bar2, group_threads);

    // 4. out = (e vhat)[:, :Cout]
    __nv_bfloat16* out = p.out + (size_t)w * p.N * p.Cout;
    const unsigned char* V = st + p.v_off;
    if constexpr (kInt8) {
      // items (row tile, interleaved 32-column block); a lane's eight
      // columns 32 blk + 8 t .. + 7 leave as one 16-byte store a row
      for (int it = gw; it < p.m_tiles * groups2; it += kRingGroupWarps) {
        const int mi = it / groups2, blk = it % groups2;
        int o[4][4] = {};
        for (int ks = 0; ks < ks2; ++ks) {
          uint32_t a[4], b[4][2];
          ldmatrix_x4(a, E + (size_t)(16 * mi + lane % 16) * p.le + 32 * ks + (lane / 16) * 16);
          b_block_int8(b, V, p.lv, ks, 32 * blk, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) DotMma<T>::mma(o[j], a, b[j][0], b[j][1]);
        }
        const int c = 32 * blk + 8 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mi + 8 * h + g;
          if (r < p.N && c < p.Cout) {
            uint4 v;
            v.x = pack_bf16x2((float)o[0][2 * h] * s_scale, (float)o[1][2 * h] * s_scale);
            v.y = pack_bf16x2((float)o[2][2 * h] * s_scale, (float)o[3][2 * h] * s_scale);
            v.z = pack_bf16x2((float)o[0][2 * h + 1] * s_scale, (float)o[1][2 * h + 1] * s_scale);
            v.w = pack_bf16x2((float)o[2][2 * h + 1] * s_scale, (float)o[3][2 * h + 1] * s_scale);
            *reinterpret_cast<uint4*>(out + (size_t)r * p.Cout + c) = v;
          }
        }
      }
    } else {
      // items: 16-column panels over every row tile
      for (int panel = gw; panel < groups2; panel += kRingGroupWarps) {
        float o[kRingMaxMTiles][2][4] = {};
        for (int ks = 0; ks < ks2; ++ks) {
          uint32_t b[4];
          b_panel_bf16(b, V, p.lv, ks, 16 * panel, lane);
#pragma unroll
          for (int mi = 0; mi < kRingMaxMTiles; ++mi)
            if (mi < p.m_tiles) {
              uint32_t a[4];
              ldmatrix_x4(a, E + (size_t)(16 * mi + lane % 16) * p.le + 32 * ks + (lane / 16) * 16);
              DotMma<T>::mma(o[mi][0], a, b[0], b[1]);
              DotMma<T>::mma(o[mi][1], a, b[2], b[3]);
            }
        }
#pragma unroll
        for (int mi = 0; mi < kRingMaxMTiles; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * mi + 8 * h + g, c = 16 * panel + 8 * j + 2 * t;
              if (mi < p.m_tiles && r < p.N && c < p.Cout)
                store2(out + (size_t)r * p.Cout + c, o[mi][j][2 * h], o[mi][j][2 * h + 1]);
            }
      }
    }
    // e over khat was written by plain stores: order them before the next
    // window's copies into the stage, then release it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// A 3-D map over (nw, rows, cols) elements of es bytes: dims (cols, rows,
// nw), box (box_cols, rows, 1), unswizzled, columns past cols read as
// zeros; through this thread's cache, so a launch that repeats encodes
// nothing.  Unused (zeroed) where the operand comes by a bulk copy.
int window_map(CUtensorMap* map, bool whole, const void* ptr, int es, int cols, int rows, int nw,
               int box_cols) {
  if (whole) {
    *map = CUtensorMap{};
    return 0;
  }
  thread_local MapCache<6> cache;
  return cache.get(
      {(long long)(uintptr_t)ptr, es, cols, rows, nw, box_cols}, map, [&](CUtensorMap* m) {
        const Encoder& enc = encoder();
        if (enc.err != cudaSuccess) return (int)enc.err;
        const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)nw};
        const cuuint64_t strides[2] = {(cuuint64_t)cols * es, (cuuint64_t)cols * es * rows};
        const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1};
        const cuuint32_t elem[3] = {1, 1, 1};
        const CUresult r = enc.fn(
            m, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        return r == CUDA_SUCCESS ? 0 : kDriverErrorBase + (int)r;
      });
}

template <typename T>
int launch_ring(RingArgs p, cudaStream_t stream) {
  if (!ring_plan<T>(p)) return (int)cudaErrorInvalidValue;
  constexpr int es = sizeof(T);
  CUtensorMap tq, tk, tv;
  int rc = window_map(&tq, p.q_whole, p.q, es, p.C, p.N, p.nw, p.lq / es);
  if (rc == 0) rc = window_map(&tk, p.k_whole, p.khat, es, p.P, p.C, p.nw, p.lk / es);
  if (rc == 0) rc = window_map(&tv, p.v_whole, p.vhat, es, p.Cv, p.P, p.nw, p.lv / es);
  if (rc != 0) return rc;
  auto kernel = window_dots_ring_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.nw < sms ? p.nw : sms;
  kernel<<<grid, kRingThreads, p.smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

constexpr int kDotBF16 = 1;
constexpr int kDotInt8 = 2;

}  // namespace
}  // namespace nunif

// T3.  dtype 1: bf16, 2: int8.  q (nw, N, C), khat (nw, C, P), vhat (nw, P,
// Cv), contiguous, and out (nw, N, Cout) bf16, all 16-byte aligned.  N <=
// 64, P <= 256, Cout a multiple of 8 up to Cv; C * sizeof(T) a multiple of
// 16; in bf16 P and Cv multiples of 8, in int8 of 4 with C * P and P * Cv
// multiples of 16.
extern "C" int nunif_window_dots(int dtype, const void* q, const void* khat, const void* vhat,
                                 void* out, int nw, int N, int C, int P, int Cv, int Cout,
                                 void* stream) {
  using namespace nunif;
  if (((uintptr_t)q | (uintptr_t)khat | (uintptr_t)vhat | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  RingArgs p{q, khat, vhat, static_cast<__nv_bfloat16*>(out), nw, N, C, P, Cv, Cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kDotBF16  ? launch_ring<__nv_bfloat16>(p, s)
         : dtype == kDotInt8 ? launch_ring<int8_t>(p, s)
                             : (int)cudaErrorInvalidValue;
}
