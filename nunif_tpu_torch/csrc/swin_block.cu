// K1: one whole Swin-V1 block (norm "none") on an NHWC image, fused.
// K5: the same block on window-ordered tokens (nw, N, C).
//
// K1 replaces nunif_tpu/ops/swin_attention.py:fused_swin_block_image
// (Pallas, kernel _kernel_block_img, body _block_compute); K5 replaces
// fused_swin_block (kernel _kernel_block, the same body), which the JAX
// block module calls under NUNIF_TPU_SWIN_IMG=0.  Per window of ws x ws
// tokens:
//   qkv = x Wqkv + b;  per head softmax(q k^T * scale + relbias [-100 across
//   shift regions]) v;  y1 = attn Wproj + b + x;
//   out = gelu_erf(y1 Wfc1 + b) Wfc2 + b + y1
// with an optional `skip` added to x on the first read (K1 only; K5's
// caller adds it).
//
// K5 differs from K1 only in the token table: token t of window w is row
// (w N + t) of x, and the window's grid position (w mod n_wh n_ww) selects
// the mask: "roll" for the rolled grid, "pad" for a grid padded by shift /
// ws - shift whose keys outside the unpadded image get -100
// (window_attention.cuh).  The TPU kernel pads the window count to a
// multiple of its block with garbage windows; here the last tile just
// holds fewer windows.
//
// Shift (K1): the window grid is the cyclically rolled one of the module path
// (nunif_tpu/modules/attention.py:333-348).  Rolled row R reads image row
// (R + shift) % H, so neither a roll copy nor the TPU caller's pad/crop
// copies exist; the -100 region mask matches shifted_window_mask.  Every
// query keeps its own key, so no softmax row is empty.
//
// bf16 rounding points follow _block_compute: qkv after the bias, the
// normalised probabilities before PV, the attention output, y1, h1 after
// GELU, and the output.  All sums are fp32.  The softmax subtracts the row
// max (exact for any logit range) and GELU uses erff.
//
// What bounds it on the H100.  Per token the block does 16 C^2 + 4 N C
// multiply-adds against 2 C bytes in and out, far above the bf16 ridge: the
// four dense GEMMs are ~91% (C = 96) and ~95% (C = 192) of the work, so the
// tensor cores set the floor (3.22 ms of a 1080p swin_unet_2x frame's 14
// launches), and only wgmma reaches their rate.  A second floor is the
// weights: a tile of T token rows reads all 16 C^2 bytes of them from L2,
// ~5 GB at C = 96 and ~16 GB at C = 192 over a frame.
//
// bf16 design (swin_block_wgmma), a persistent warp-specialised kernel:
// - Tiles.  A tile is T = 256 token rows at C <= 96 (7 windows of 36,
//   1.6% padding), 128 at C = 192 (3 windows, 15.6%), 64 past that: the
//   largest of 256 / 128 / 64 whose activations fit.  Shared memory holds x
//   / y1 (T x C) and one T x max(3C, hidden) buffer that holds qkv, then
//   the attention output (over q), then h1 (8 C T bytes at hidden = 2C:
//   196,608 at both widths), the token table and the weight ring.
//   Activations touch device memory once in and once out.
// - Layout.  Both buffers are stored as planes of 8 columns, 16 bytes a
//   row (row r, column c at plane c / 8, byte 16 r + 2 (c % 8)): wgmma's
//   unswizzled K-major layout for any 64-row run (core matrices of 8 rows
//   x 16 bytes, SBO 128 B, LBO one plane).  The 128-byte swizzle would
//   need K in multiples of 64 (C = 96 and 3C = 288 are not); the plane
//   layout takes any multiple of 16, and the epilogue's 4-byte stores,
//   attention's ldmatrix rows and the gather's 16-byte copies are each 8
//   consecutive rows of one plane, 128 contiguous bytes, so none of them
//   has a bank conflict.  Attention reads rows up to 47 of every window,
//   past the last window's rows: a plane runs on into the next plane's
//   first rows, and the last plane into 768 zeroed bytes, all finite.
// - Four GEMMs on wgmma (qkv C -> 3C, proj C -> C, fc1 C -> hidden, fc2
//   hidden -> C), A and B from shared memory.  Two consumer warpgroups
//   split each GEMM's 64-row tiles (T = 256: two each; 128: one each; 64:
//   the first only) and walk its output columns in chunks of NC = 96 (16
//   where C or hidden is not a multiple of 96): an m64nNCk16 chain per row
//   tile, fp32 accumulators in registers (2 x 48 a thread at C = 96), read
//   directly by the epilogues (bias; bf16 store into the other buffer;
//   residual; GELU; for fc2 the residual and a quad transpose so that each
//   lane stores 16 bytes of one token to the image or the token rows).
// - Weights by bulk copy.  pack_weights (ops/swin_attention.py) puts each
//   matrix in wgmma's K-major B layout once per weight load, one NC-column
//   chunk after another (ops/_build.py:wgmma_weight_layout), so the piece a
//   GEMM consumes next -- kper k16 steps of one column chunk, 9 KB at kper
//   3 -- is contiguous.  The producer warpgroup's first thread streams the
//   pieces with cp.async.bulk into a ring (3 stages at both widths), each
//   stage with a "full" mbarrier (complete_tx) and an "empty" one on which
//   each consumer warpgroup arrives when its wgmmas have read the stage; it
//   runs ahead across GEMMs and tiles.  No consumer lane loads a weight.
// - Attention stays on mma.sync in registers (window_attention.cuh:
//   attention_unit on the Planes staging), in units of (window, head,
//   16-query block) over the tile's windows; with only the 8 consumer
//   warps an SM to run it, its cost is the instructions it issues, so it
//   has no runtime loop bounds, divisions or branches per key.
// - Phases of a tile, separated by a named barrier over the 256 consumer
//   threads (the producer never waits on one): token table; gather by
//   cp.async (zero rows for padding; skip's rows into the qkv buffer and
//   added in place); qkv; attention; proj; fc1; fc2 with the scatter.  A
//   proxy fence orders plain stores and cp.async before the next GEMM's
//   wgmma reads.  The consumers, not the producer, gather: with one x
//   buffer the gather can only start once fc2's epilogue has read x, so it
//   is on the critical path whoever issues it, and 256 threads issue it in
//   half the steps.
// - One block of 384 threads an SM (132 persistent blocks, tiles dealt
//   round robin); setmaxnreg moves registers to the consumers: 240 a
//   thread there, 24 in the producer (168 x 384 at launch).
// Where a tile's time goes: tools/swin_block_phases.py (clock counters at
// these barriers).  Tried on the H100 in scratch builds and dropped, for
// adding code without a clear gain: the producer warpgroup's three idle
// warps as helpers in attention and gathering the next tile during fc1 /
// fc2 (with y1 moved over v to free x; the consumers then had no
// setmaxnreg and spilled); columns in chunks of 48 split between the
// warpgroups, so that one's epilogue could run under the other's wgmmas,
// with and without K7's turns to issue (slower: the GEMM phases are bound
// by instruction issue in their epilogues and, at C = 192, by weights from
// L2, not by idle tensor cores); and weight pieces of 2 k16 steps in 5
// stages (slower).
//
// The fp32 variant (swin_block_f32) keeps the data flow with FMA loops
// everywhere: 16 warps own up to 4 windows, row-major shared memory, FMA
// GEMMs and attention_fma.
#include "common.cuh"
#include "wgmma.cuh"
#include "window_attention.cuh"

namespace nunif {
namespace {

constexpr int kAttnTiles = 3;  // 16-key attention tiles: windows of N <= 48

struct SwinArgs {
  const void* x;
  const void* skip;
  const void* wqkv;
  const float* bqkv;
  const void* wproj;
  const float* bproj;
  const void* wfc1;
  const float* bfc1;
  const void* wfc2;
  const float* bfc2;
  const float* relbias;  // (heads, N, N)
  void* out;
  int B, H, W, C, heads, hidden, ws, shift;
  int chunk;  // bf16: columns of the pack's weight chunks (96 or 16)
  float scale;
  int n_wh, n_ww, n_windows;
  int windowed;  // K5: x and out are (nw, N, C) window-ordered tokens
  int pad_mode;  // K5: shift_mode "pad" (else the roll regions)
  // fp32 kernel
  int wpb;       // windows per block
  int rows_pad;  // wpb * N rounded up to 16
  int ldx, ldq;  // shared-memory row strides, in elements
  // bf16 kernel (BlockPlan)
  int rows, windows, kper, stages, n_tiles;
  uint32_t stage_bytes, q_off, tok_off, ring_off, bar_off;
};

// Element offset of token t of window w: its pixel (K1) or its row (K5).
__device__ __forceinline__ long long token_offset(const SwinArgs& p, int w, int t) {
  if (p.windowed) return ((long long)w * p.ws * p.ws + t) * p.C;
  const int per_img = p.n_wh * p.n_ww;
  const int b = w / per_img, rem = w % per_img;
  const int wr = rem / p.n_ww, wc = rem % p.n_ww;
  const int row = (wr * p.ws + t / p.ws + p.shift) % p.H;
  const int col = (wc * p.ws + t % p.ws + p.shift) % p.W;
  return (((long long)b * p.H + row) * p.W + col) * p.C;
}

// The mask of the window at grid position (wr, wc), or of window w.
__device__ __forceinline__ WindowMask window_mask_at(const SwinArgs& p, int wr, int wc) {
  return p.pad_mode ? pad_mask(p.ws, p.shift, wr, wc, p.n_wh, p.n_ww)
                    : roll_mask(p.ws, p.shift, wr, wc, p.n_wh, p.n_ww);
}

__device__ __forceinline__ WindowMask window_mask(const SwinArgs& p, int w) {
  const int rem = w % (p.n_wh * p.n_ww);
  return window_mask_at(p, rem / p.n_ww, rem % p.n_ww);
}

// ---------------------------------------------------------------- bf16
constexpr int kThreadsBF16 = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kMaxStages = 4;
constexpr int kQPad = 48 * 16;  // zeroed bytes past the last plane of the qkv buffer
constexpr int kPhaseBar = 1;  // named barrier over the consumers

struct BlockPlan {
  int rows, windows, kper, stages;
  size_t q_off, tok_off, ring_off, bar_off, total;
};

// Tile rows, weight pieces and shared memory of the bf16 kernel for weight
// chunks of nc columns (the pack's, 96 or 16; the wgmma N): the
// largest tile of 256 / 128 / 64 rows whose buffers leave room for a ring
// of two one-step stages; then the largest piece (kper k16 steps, at most
// 4) of which 3 stages fit, else 2.  (Pieces of 2 steps in 5 stages, more
// bytes in flight, ran every GEMM slower on the H100: a piece's wgmmas are
// one commit group, and smaller groups leave the tensor cores idle
// between them.)
__host__ inline bool plan_bf16(int C, int hidden, int N, int nc, BlockPlan* P) {
  if ((nc != 96 && nc != 16) || C % nc || hidden % nc) return false;
  const size_t qcols = (size_t)(3 * C > hidden ? 3 * C : hidden);
  const size_t bars = 2 * kMaxStages * sizeof(uint64_t);
  const size_t step = (size_t)nc * 32;  // one k16 step of a chunk, bytes
  for (int rows = 256; rows >= 64; rows /= 2) {
    if (rows < N) return false;
    const size_t q_off = align_up((size_t)rows * C * 2, 128);
    const size_t tok_off = align_up(q_off + (size_t)rows * qcols * 2 + kQPad, 128);
    // the token table: an element offset a row, then a grid position a window
    const size_t ring_off = align_up(tok_off + (size_t)rows * (sizeof(long long) + 4), 128);
    if (ring_off + 2 * step + bars > kMaxSmem) continue;
    const size_t avail = kMaxSmem - ring_off - bars;
    int kper = 0, stages = 0;
    for (int want = 3; want >= 2 && kper == 0; --want) {
      for (int k = 4; k >= 1; --k) {
        const size_t fit = avail / (k * step);
        if (fit >= (size_t)want) {
          kper = k;
          stages = fit < (size_t)kMaxStages ? (int)fit : kMaxStages;
          break;
        }
      }
    }
    P->rows = rows;
    P->windows = rows / N;
    P->kper = kper;
    P->stages = stages;
    P->q_off = q_off;
    P->tok_off = tok_off;
    P->ring_off = ring_off;
    P->bar_off = align_up(ring_off + (size_t)stages * kper * step, 8);
    P->total = P->bar_off + 2 * (size_t)stages * sizeof(uint64_t);
    return true;
  }
  return false;
}

struct Ring {
  uint32_t base;  // shared address of stage 0
  uint32_t stage_bytes;
  int stages;
  uint64_t* full;
  uint64_t* empty;
};

// A GEMM's shape: weight chunks come in (column chunk, k piece) order.
struct GemmShape {
  const unsigned char* w;
  int ksteps, n_out;
};

__device__ __forceinline__ GemmShape gemm_shape(const SwinArgs& p, int gm) {
  const int kc = p.C / 16;
  switch (gm) {
    case 0: return {static_cast<const unsigned char*>(p.wqkv), kc, 3 * p.C};
    case 1: return {static_cast<const unsigned char*>(p.wproj), kc, p.C};
    case 2: return {static_cast<const unsigned char*>(p.wfc1), kc, p.hidden};
    default: return {static_cast<const unsigned char*>(p.wfc2), p.hidden / 16, p.C};
  }
}

// One warpgroup's part of a GEMM: rows of 64-row tiles m0 .. m0 + MT - 1 of
// A (planes of a_plane bytes from a_addr, K = 16 ksteps) times the weight
// pieces as the ring delivers them; epi(acc, n0) for each column chunk
// n0 .. n0 + NC - 1, after its wgmmas have landed.  A piece's wgmmas are
// committed as one group; the stage of the piece before is freed once only
// this group is in flight.  Every wait and arrive is on a path that all
// threads take.
template <int NC, int MT, typename Epi>
__device__ __forceinline__ void wg_gemm(const Ring& ring, uint32_t& chunk, uint32_t a_addr,
                                        uint32_t a_plane, int ksteps, int n_out, int kper, int m0,
                                        bool leader, Epi epi) {
  float acc[MT][NC / 2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[mi][i] = 0.f;
  // the wgmmas of k16 steps k0 .. of the next piece; returns its stage
  auto issue = [&](int k0) {
    const int cnt = ksteps - k0 < kper ? ksteps - k0 : kper;
    const int s = chunk % ring.stages;
    mbar_wait(&ring.full[s], (chunk / ring.stages) & 1);
    ++chunk;
    wgmma_fence();  // the epilogue before read the accumulators
    const uint32_t b_addr = ring.base + s * ring.stage_bytes;
#pragma unroll 1
    for (int j = 0; j < cnt; ++j) {
      // B: one k16 step of the piece, core matrices 128 B apart along K,
      // 256 B along N; A: k16 step k0 + j is planes 2 (k0 + j) and on
      const uint64_t b_desc = wgmma_desc(b_addr + j * (NC * 32), 128, 256);
      const uint32_t a_k = a_addr + 2 * (k0 + j) * a_plane;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        WgmmaSS<NC>::mma(acc[mi], wgmma_desc(a_k + (m0 + mi) * 1024, a_plane, 128), b_desc,
                         k0 + j > 0);
    }
    wgmma_commit();
    return s;
  };
  for (int n0 = 0; n0 < n_out; n0 += NC) {
    int prev = issue(0);
    for (int k0 = kper; k0 < ksteps; k0 += kper) {
      const int s = issue(k0);
      wgmma_wait<1>();  // the piece before has been read: free its stage
      mbar_arrive_if(&ring.empty[prev], leader);
      prev = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) fence_regs(acc[mi]);
    mbar_arrive_if(&ring.empty[prev], leader);
    epi(acc, n0);
  }
}

// f(r, c, v_c, v_c+1) with the bias added, over a warpgroup's accumulators
// (64-row tiles m0 .., columns n0 ..): lane 4 g + t of warp w holds rows
// 16 w + g and + 8, columns 8 j + 2 t and + 1 of each 8-column chunk j.
template <int NC, int MT, typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[MT][NC / 2], int m0, int n0,
                                          const float* __restrict__ bias, F f) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = (m0 + mi) * 64 + warp * 16 + g;
      f(r, c, acc[mi][4 * j] + b0, acc[mi][4 * j + 1] + b1);
      f(r + 8, c, acc[mi][4 * j + 2] + b0, acc[mi][4 * j + 3] + b1);
    }
  }
}

// Consumer warp cw's share of a tile's attention units (window, head,
// 16-query block): a contiguous run in (head, query block, window) order,
// so consecutive units read the same bias rows.
// wpos: the grid position (wr << 16 | wc) of each of the tile's windows;
// NFix as for attention_unit.
template <int KT, int NFix>
__device__ __forceinline__ void attend(const SwinArgs& p, __nv_bfloat16* Q, int plane,
                                       const int* wpos, int win0, int cw) {
  const int N = NFix > 0 ? NFix : p.ws * p.ws, qblocks = (N + 15) / 16;
  const int units = p.windows * p.heads * qblocks;
  const int u0 = cw * units / kConsumerWarps, end = (cw + 1) * units / kConsumerWarps;
  const uint32_t inv_ws = (65536u + p.ws - 1) / p.ws;
  int wl = u0 % p.windows, mi = u0 / p.windows % qblocks, h = u0 / p.windows / qblocks;
  for (int u = u0; u < end; ++u) {
    const int pos = wpos[wl];
    attention_unit<KT, kAttnTiles, NFix>(PlanesQKV{Planes{Q + wl * N * 8, plane}, p.C},
                                         LdgBias{p.relbias}, h, mi,
                                         window_mask_at(p, pos >> 16, pos & 0xffff),
                                         win0 + wl < p.n_windows, N, p.scale, inv_ws);
    if (++wl == p.windows) {
      wl = 0;
      if (++mi == qblocks) {
        mi = 0;
        ++h;
      }
    }
  }
}

template <int NFix>
__device__ __forceinline__ void attend_hd(const SwinArgs& p, __nv_bfloat16* Q, int plane,
                                          const int* wpos, int win0, int cw, int hd) {
  switch (hd / 16) {
    case 1: attend<1, NFix>(p, Q, plane, wpos, win0, cw); break;
    case 2: attend<2, NFix>(p, Q, plane, wpos, win0, cw); break;
    case 3: attend<3, NFix>(p, Q, plane, wpos, win0, cw); break;
    default: attend<4, NFix>(p, Q, plane, wpos, win0, cw); break;
  }
}

// The token table of the tile from window win0: the element offset of
// every token row (-1: padding row or window past the end) and the grid
// position (wr << 16 | wc) of every window; threads tid of n.
__device__ __forceinline__ void fill_token_table(const SwinArgs& p, int win0, long long* tok,
                                                 int* wpos, int tid, int n) {
  const int N = p.ws * p.ws;
  for (int r = tid; r < p.rows; r += n) {
    const int w = win0 + r / N;
    tok[r] = r < p.windows * N && w < p.n_windows ? token_offset(p, w, r % N) : -1;
    if (r < p.windows) {
      const int rem = (win0 + r) % (p.n_wh * p.n_ww);
      wpos[r] = (rem / p.n_ww) << 16 | rem % p.n_ww;
    }
  }
}

// Gather a tile's tokens of src into the planes of dst (C columns) by
// cp.async: lanes 2 i and 2 i + 1 copy the two 16-byte halves of 32 bytes
// of one token (planes v, v + 1 of row r); padding rows read as zeros.
// Thread tid of n; e indexes the same (row, vector) pairs in every call.
__device__ __forceinline__ void gather_rows(const SwinArgs& p, const __nv_bfloat16* src,
                                            __nv_bfloat16* dst, const long long* tok, int tid,
                                            int n) {
  const int T = p.rows, plane = T * 8, vecs = p.C / 8;
  for (int e = tid; e < T * vecs; e += n) {
    const int pr = e >> 1;
    const int r = pr % T, v = 2 * (pr / T) + (e & 1);
    const long long off = tok[r];
    cp_async16(dst + v * plane + r * 8, off >= 0 ? src + off + v * 8 : src, off >= 0);
  }
  cp_async_commit();
}

// x += skip for the tile in X (one rounding in bf16): skip lands in the
// qkv buffer's first C columns and each thread adds the vectors it copied.
__device__ __forceinline__ void add_skip(const SwinArgs& p, __nv_bfloat16* X, __nv_bfloat16* Q,
                                         const long long* tok, int tid, int n) {
  using bf16 = __nv_bfloat16;
  gather_rows(p, static_cast<const bf16*>(p.skip), Q, tok, tid, n);
  cp_async_wait<0>();
  const int T = p.rows, plane = T * 8, vecs = p.C / 8;
  for (int e = tid; e < T * vecs; e += n) {
    const int pr = e >> 1;
    const int r = pr % T, v = 2 * (pr / T) + (e & 1);
    uint4* xv = reinterpret_cast<uint4*>(X + v * plane + r * 8);
    uint4 a = *xv;
    const uint4 sk = *reinterpret_cast<const uint4*>(Q + v * plane + r * 8);
    bf16* av = reinterpret_cast<bf16*>(&a);
    const bf16* sv = reinterpret_cast<const bf16*>(&sk);
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = __float2bfloat16_rn(to_f(av[i]) + to_f(sv[i]));
    *xv = a;
  }
}

template <int NC, int MT>
__global__ void __launch_bounds__(kThreadsBF16, 1) swin_block_wgmma(const SwinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using bf16 = __nv_bfloat16;
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Q = reinterpret_cast<bf16*>(smem + p.q_off);
  long long* tok = reinterpret_cast<long long*>(smem + p.tok_off);
  int* wpos = reinterpret_cast<int*>(tok + p.rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  const int T = p.rows, C = p.C;
  const int active_wgs = T >= 128 ? 2 : 1;  // warpgroups that own 64-row tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active_wgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {  // the qkv buffer and its pad start as zeros: every value attention
     // tiles read past a window is finite
    const int qcols = 3 * C > p.hidden ? 3 * C : p.hidden;
    uint4* q4 = reinterpret_cast<uint4*>(Q);
    const int n = (T * qcols * 2 + kQPad) / 16;
    for (int i = threadIdx.x; i < n; i += kThreadsBF16) q4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread streams the weight pieces in the order the
    // consumers take them, tile after tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      unsigned char* ring = smem + p.ring_off;
      uint32_t chunk = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        for (int gm = 0; gm < 4; ++gm) {
          const GemmShape gs = gemm_shape(p, gm);
          for (int n = 0; n < gs.n_out / NC; ++n) {
            for (int k0 = 0; k0 < gs.ksteps; k0 += p.kper, ++chunk) {
              const int cnt = gs.ksteps - k0 < p.kper ? gs.ksteps - k0 : p.kper;
              const int s = chunk % p.stages;
              mbar_wait(&empty[s], ((chunk / p.stages) & 1) ^ 1);  // the first round passes
              const uint32_t bytes = cnt * NC * 32;
              mbar_expect_tx(&full[s], bytes);
              bulk_copy_g2s(ring + s * p.stage_bytes,
                            gs.w + ((size_t)n * gs.ksteps + k0) * (NC * 32), bytes, &full[s]);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int ctid = threadIdx.x;
  // the warpgroup index, warp-uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, ctid / 128, 0);
  const bool leader = ctid % 128 == 0;
  const bool has_rows = wg < active_wgs;
  const int m0 = wg * MT;  // this warpgroup's first 64-row tile
  const int plane = T * 8;  // elements a plane
  const uint32_t plane_bytes = T * 16;
  const uint32_t x_addr = smem_addr(X), q_addr = smem_addr(Q);
  const Ring ring{smem_addr(smem + p.ring_off), p.stage_bytes, p.stages, full, empty};
  const Planes xs{X, plane}, qs{Q, plane};
  bf16* out = static_cast<bf16*>(p.out);
  const int hd = C / p.heads;
  uint32_t chunk = 0;

  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int win0 = tile * p.windows;
    // 1. the token table, then the gather (+ skip, added in place)
    fill_token_table(p, win0, tok, wpos, ctid, kConsumers);
    named_bar_sync(kPhaseBar, kConsumers);
    gather_rows(p, static_cast<const bf16*>(p.x), X, tok, ctid, kConsumers);
    cp_async_wait<0>();
    if (p.skip != nullptr) add_skip(p, X, Q, tok, ctid, kConsumers);
    fence_proxy_async();  // X was written by cp.async or plain stores
    named_bar_sync(kPhaseBar, kConsumers);

    // 2. qkv projection into the qkv buffer
    if (has_rows)
      wg_gemm<NC, MT>(ring, chunk, x_addr, plane_bytes, C / 16, 3 * C, p.kper, m0, leader,
                      [&](const float (&acc)[MT][NC / 2], int n0) {
                        for_pairs<NC, MT>(acc, m0, n0, p.bqkv, [&](int r, int c, float v0, float v1) {
                          store2(qs.at(r, c), v0, v1);
                        });
                      });
    named_bar_sync(kPhaseBar, kConsumers);

    // 3. window attention: units (window, head, 16-query block); a warp
    //    takes a contiguous run of them in (head, query block, window)
    //    order, so consecutive units read the same bias rows
    if (p.ws == 6)
      attend_hd<36>(p, Q, plane, wpos, win0, ctid / 32, hd);
    else
      attend_hd<0>(p, Q, plane, wpos, win0, ctid / 32, hd);
    fence_proxy_async();
    named_bar_sync(kPhaseBar, kConsumers);

    // 4. out projection + residual 1; y1 overwrites x in place
    if (has_rows)
      wg_gemm<NC, MT>(ring, chunk, q_addr, plane_bytes, C / 16, C, p.kper, m0, leader,
                      [&](const float (&acc)[MT][NC / 2], int n0) {
                        for_pairs<NC, MT>(acc, m0, n0, p.bproj, [&](int r, int c, float v0, float v1) {
                          bf16* xr = xs.at(r, c);
                          const float2 res = load2(xr);
                          store2(xr, v0 + res.x, v1 + res.y);
                        });
                      });
    fence_proxy_async();
    named_bar_sync(kPhaseBar, kConsumers);

    // 5. fc1 + exact GELU into the qkv buffer
    if (has_rows)
      wg_gemm<NC, MT>(ring, chunk, x_addr, plane_bytes, C / 16, p.hidden, p.kper, m0, leader,
                      [&](const float (&acc)[MT][NC / 2], int n0) {
                        for_pairs<NC, MT>(acc, m0, n0, p.bfc1, [&](int r, int c, float v0, float v1) {
                          store2(qs.at(r, c), 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f)),
                                 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f)));
                        });
                      });
    fence_proxy_async();
    named_bar_sync(kPhaseBar, kConsumers);

    // 6. fc2 + residual 2, scattered back to the image (K1) or the token
    //    rows (K5): for each run of four 8-column chunks a quad transposes
    //    its words, so a lane stores 16 bytes (8 channels of one token)
    if (has_rows)
      wg_gemm<NC, MT>(
          ring, chunk, q_addr, plane_bytes, p.hidden / 16, C, p.kper, m0, leader,
          [&](const float (&acc)[MT][NC / 2], int n0) {
            constexpr int kChunks = NC / 8, kQuadChunks = kChunks / 4 * 4;
            const int warp = (ctid / 32) % 4, lane = ctid % 32;
            const int g = lane >> 2, t = lane & 3;
            auto bias = [&](int j) {
              return *reinterpret_cast<const float2*>(p.bfc2 + n0 + 8 * j + 2 * t);
            };
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = (m0 + mi) * 64 + warp * 16 + g + 8 * hh;
                const long long off = tok[r];
                auto value = [&](int j) {
                  const int c = n0 + 8 * j + 2 * t;
                  const float2 res = load2(xs.at(r, c)), b = bias(j);
                  return make_float2(acc[mi][4 * j + 2 * hh] + b.x + res.x,
                                     acc[mi][4 * j + 2 * hh + 1] + b.y + res.y);
                };
#pragma unroll
                for (int j0 = 0; j0 < kQuadChunks; j0 += 4) {
                  uint32_t v[4];
#pragma unroll
                  for (int cc = 0; cc < 4; ++cc) {
                    const float2 y = value(j0 + cc);
                    v[cc] = pack_bf16x2(y.x, y.y);
                  }
                  quad_transpose(v, t);
                  if (off >= 0)
                    *reinterpret_cast<uint4*>(out + off + n0 + 8 * (j0 + t)) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
#pragma unroll
                for (int j = kQuadChunks; j < kChunks; ++j) {
                  const float2 y = value(j);
                  if (off >= 0) store2(out + off + n0 + 8 * j + 2 * t, y.x, y.y);
                }
              }
            }
          });
    named_bar_sync(kPhaseBar, kConsumers);  // x and the token table are free
  }
}

template <int NC, int MT>
cudaError_t launch_wgmma(const SwinArgs& p, size_t smem, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(swin_block_wgmma<NC, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  swin_block_wgmma<NC, MT><<<grid, kThreadsBF16, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_swin_bf16(SwinArgs p, cudaStream_t stream) {
  const int N = p.ws * p.ws, hd = p.C / p.heads;
  if (N > kAttnTiles * 16 || p.C % 16 || p.hidden % 16 || hd % 16 || hd > kMaxHeadDim)
    return cudaErrorInvalidValue;
  BlockPlan P;
  if (!plan_bf16(p.C, p.hidden, N, p.chunk, &P)) return cudaErrorInvalidConfiguration;
  p.rows = P.rows;
  p.windows = P.windows;
  p.kper = P.kper;
  p.stages = P.stages;
  p.stage_bytes = (uint32_t)(P.kper * p.chunk * 32);
  p.q_off = (uint32_t)P.q_off;
  p.tok_off = (uint32_t)P.tok_off;
  p.ring_off = (uint32_t)P.ring_off;
  p.bar_off = (uint32_t)P.bar_off;
  p.n_tiles = (p.n_windows + P.windows - 1) / P.windows;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  const bool two = P.rows >= 256;  // 64-row tiles a consumer warpgroup: 2, else 1
  if (p.chunk == 96)
    return two ? launch_wgmma<96, 2>(p, P.total, grid, stream)
               : launch_wgmma<96, 1>(p, P.total, grid, stream);
  return two ? launch_wgmma<16, 2>(p, P.total, grid, stream)
             : launch_wgmma<16, 1>(p, P.total, grid, stream);
}

// ---------------------------------------------------------------- fp32
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 144;  // token rows per block

struct SmemLayout {
  size_t x_off, q_off, prob_off, tok_off, total;
};

// Shared memory: x / y1 (rows_pad x ldx), qkv / attention output / h1
// (rows_pad x ldq), each warp's probability row, and the token offsets.
__host__ __device__ SmemLayout smem_layout_f32(int rows_pad, int ldx, int ldq, int N) {
  SmemLayout L;
  size_t o = 0;
  L.x_off = o;
  o = align_up(o + (size_t)rows_pad * ldx * sizeof(float), 128);
  L.q_off = o;
  o = align_up(o + (size_t)rows_pad * ldq * sizeof(float), 128);
  L.prob_off = o;
  o = align_up(o + (size_t)kWarps * N * sizeof(float), 128);
  L.tok_off = o;
  o = align_up(o + (size_t)rows_pad * sizeof(long long), 128);
  L.total = o;
  return L;
}

// epi(r, c, v_c, v_c+1) with v = sum_k A[r, k] W[k, :] + bias for every
// r < rows_pad and even c < n_out.  A is in shared memory (row stride lda);
// W is (K, n_out) row-major and bias fp32 (n_out,), both in device memory.
template <typename Epi>
__device__ __forceinline__ void dense_gemm(const float* A, int lda, const float* __restrict__ W,
                                           const float* __restrict__ bias, int K, int n_out,
                                           int rows_pad, Epi epi) {
  const int half = n_out / 2;
  for (int e = threadIdx.x; e < rows_pad * half; e += kThreads) {
    const int r = e / half, c = 2 * (e % half);
    const float* a = A + (size_t)r * lda;
    float acc0 = 0.f, acc1 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float av = a[k];
      acc0 = fmaf(av, W[(size_t)k * n_out + c], acc0);
      acc1 = fmaf(av, W[(size_t)k * n_out + c + 1], acc1);
    }
    epi(r, c, acc0 + bias[c], acc1 + bias[c + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) swin_block_f32(SwinArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = p.ws * p.ws;
  const SmemLayout L = smem_layout_f32(p.rows_pad, p.ldx, p.ldq, N);
  float* X = reinterpret_cast<float*>(smem + L.x_off);
  float* Q = reinterpret_cast<float*>(smem + L.q_off);
  long long* tok = reinterpret_cast<long long*>(smem + L.tok_off);

  const float* x = static_cast<const float*>(p.x);
  const float* skip = static_cast<const float*>(p.skip);
  float* out = static_cast<float*>(p.out);
  const int C = p.C;
  const int hd = C / p.heads;
  const int tid = threadIdx.x, warp = tid / 32;
  const int win0 = blockIdx.x * p.wpb;

  // 1. element offset of every token (-1: padding row or window past the end)
  for (int r = tid; r < p.rows_pad; r += kThreads) {
    const int w = win0 + r / N;
    tok[r] = r < p.wpb * N && w < p.n_windows ? token_offset(p, w, r % N) : -1;
  }
  __syncthreads();

  // 2. gather the windows' tokens (+ skip)
  constexpr int VEC = 4;
  const int nvec = C / VEC;
  for (int e = tid; e < p.rows_pad * nvec; e += kThreads) {
    const int r = e / nvec, v = e % nvec;
    const long long off = tok[r];
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0) {
      val = *reinterpret_cast<const float4*>(x + off + v * VEC);
      if (skip != nullptr) {
        const float4 sv = *reinterpret_cast<const float4*>(skip + off + v * VEC);
        val.x += sv.x;
        val.y += sv.y;
        val.z += sv.z;
        val.w += sv.w;
      }
    }
    *reinterpret_cast<float4*>(X + (size_t)r * p.ldx + v * VEC) = val;
  }
  __syncthreads();

  // 3. qkv projection
  dense_gemm(X, p.ldx, static_cast<const float*>(p.wqkv), p.bqkv, C, 3 * C, p.rows_pad,
             [&](int r, int c, float v0, float v1) { store2(Q + (size_t)r * p.ldq + c, v0, v1); });
  __syncthreads();

  // 4. window attention, one warp per (window, head); the output of query
  //    i overwrites q_i, which only this warp reads
  for (int u = warp; u < p.wpb * p.heads; u += kWarps) {
    const int wl = u / p.heads, h = u % p.heads;
    const int w = win0 + wl;
    if (w >= p.n_windows) continue;
    float* pr = reinterpret_cast<float*>(smem + L.prob_off) + warp * N;
    attention_fma(Q + (size_t)wl * N * p.ldq, p.ldq, C, h, hd, N, p.scale,
                  p.relbias + (size_t)h * N * N, window_mask(p, w), pr);
  }
  __syncthreads();

  // 5. out projection + residual 1; y1 overwrites x in place
  dense_gemm(Q, p.ldq, static_cast<const float*>(p.wproj), p.bproj, C, C, p.rows_pad,
             [&](int r, int c, float v0, float v1) {
               float* xr = X + (size_t)r * p.ldx + c;
               const float2 res = load2(xr);
               store2(xr, v0 + res.x, v1 + res.y);
             });
  __syncthreads();

  // 6. fc1 + exact GELU into the qkv buffer
  dense_gemm(X, p.ldx, static_cast<const float*>(p.wfc1), p.bfc1, C, p.hidden, p.rows_pad,
             [&](int r, int c, float v0, float v1) {
               store2(Q + (size_t)r * p.ldq + c,
                      0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f)),
                      0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f)));
             });
  __syncthreads();

  // 7. fc2 + residual 2, scattered back to the image (K1) or the token rows
  //    (K5)
  dense_gemm(Q, p.ldq, static_cast<const float*>(p.wfc2), p.bfc2, p.hidden, C, p.rows_pad,
             [&](int r, int c, float v0, float v1) {
               const long long off = tok[r];
               if (off >= 0) {
                 const float2 res = load2(X + (size_t)r * p.ldx + c);
                 store2(out + off + c, v0 + res.x, v1 + res.y);
               }
             });
}

cudaError_t launch_swin_f32(SwinArgs p, cudaStream_t stream) {
  const int N = p.ws * p.ws;
  p.ldx = p.C + 8;
  p.ldq = (3 * p.C > p.hidden ? 3 * p.C : p.hidden) + 8;
  const int candidates[3] = {4, 2, 1};
  size_t smem = 0;
  p.wpb = 0;
  for (int i = 0; i < 3; ++i) {
    const int wpb = candidates[i];
    if (wpb * N > kMaxRows) continue;
    const int rows_pad = (int)align_up((size_t)wpb * N, 16);
    const size_t s = smem_layout_f32(rows_pad, p.ldx, p.ldq, N).total;
    if (s <= kMaxSmem) {
      p.wpb = wpb;
      p.rows_pad = rows_pad;
      smem = s;
      break;
    }
  }
  if (p.wpb == 0) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(swin_block_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.n_windows + p.wpb - 1) / p.wpb;
  swin_block_f32<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

SwinArgs swin_args(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const void* wfc1, const void* bfc1, const void* wfc2,
                   const void* bfc2, const void* relbias, void* out, int C, int heads,
                   int hidden, int ws, int shift, int chunk, float scale) {
  SwinArgs p{};
  p.x = x;
  p.wqkv = wqkv;
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = wproj;
  p.bproj = static_cast<const float*>(bproj);
  p.wfc1 = wfc1;
  p.bfc1 = static_cast<const float*>(bfc1);
  p.wfc2 = wfc2;
  p.bfc2 = static_cast<const float*>(bfc2);
  p.relbias = static_cast<const float*>(relbias);
  p.out = out;
  p.C = C;
  p.heads = heads;
  p.hidden = hidden;
  p.ws = ws;
  p.shift = shift;
  p.chunk = chunk;
  p.scale = scale;
  return p;
}

int launch_swin(int dtype, const SwinArgs& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDtypeBF16  ? launch_swin_bf16(p, s)
                    : dtype == kDtypeF32 ? launch_swin_f32(p, s)
                                         : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
}  // namespace nunif

extern "C" int nunif_swin_block_image(int dtype, const void* x, const void* skip,
                                      const void* wqkv, const void* bqkv, const void* wproj,
                                      const void* bproj, const void* wfc1, const void* bfc1,
                                      const void* wfc2, const void* bfc2, const void* relbias,
                                      void* out, int B, int H, int W, int C, int heads,
                                      int hidden, int ws, int shift, int chunk, float scale,
                                      void* stream) {
  using namespace nunif;
  SwinArgs p = swin_args(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, relbias, out, C,
                         heads, hidden, ws, shift, chunk, scale);
  p.skip = skip;
  p.B = B;
  p.H = H;
  p.W = W;
  p.n_wh = H / ws;
  p.n_ww = W / ws;
  p.n_windows = B * p.n_wh * p.n_ww;
  return launch_swin(dtype, p, stream);
}

// K5: x and out are (nw, N, C), nw a multiple of n_wh * n_ww; pad_mode
// selects shift_mode "pad" (else "roll").
extern "C" int nunif_swin_block_windows(int dtype, const void* x, const void* wqkv,
                                        const void* bqkv, const void* wproj, const void* bproj,
                                        const void* wfc1, const void* bfc1, const void* wfc2,
                                        const void* bfc2, const void* relbias, void* out, int nw,
                                        int C, int heads, int hidden, int ws, int shift,
                                        int pad_mode, int n_wh, int n_ww, int chunk,
                                        float scale, void* stream) {
  using namespace nunif;
  if (n_wh < 1 || n_ww < 1 || nw < 1 || nw % (n_wh * n_ww) || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  SwinArgs p = swin_args(x, wqkv, bqkv, wproj, bproj, wfc1, bfc1, wfc2, bfc2, relbias, out, C,
                         heads, hidden, ws, shift, chunk, scale);
  p.windowed = 1;
  p.pad_mode = pad_mode != 0;
  p.B = nw / (n_wh * n_ww);
  p.H = n_wh * ws;
  p.W = n_ww * ws;
  p.n_wh = n_wh;
  p.n_ww = n_ww;
  p.n_windows = nw;
  return launch_swin(dtype, p, stream);
}

// The bf16 kernel's plan for a block of width C, MLP width hidden, window
// ws and weight chunks of `chunk` columns: out[0..4] = tile rows, windows a
// tile, k16 steps a weight piece, ring stages, shared-memory bytes.
extern "C" int nunif_swin_block_plan(int C, int hidden, int ws, int chunk, int* out) {
  using namespace nunif;
  BlockPlan P;
  if (C < 16 || hidden < 16 || ws < 1 || !plan_bf16(C, hidden, ws * ws, chunk, &P))
    return (int)cudaErrorInvalidConfiguration;
  out[0] = P.rows;
  out[1] = P.windows;
  out[2] = P.kper;
  out[3] = P.stages;
  out[4] = (int)P.total;
  return 0;
}
