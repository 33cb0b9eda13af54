// T4: a Hopper probe of the per-window attention dot pair
//   (N, C) . (C, P)  then  (N, P) . (P, C')
// in bf16 (mma.sync m16n8k16, fp32 accumulation) and int8 (mma.sync
// m16n8k32, int32 accumulation), repeated on resident operands.  (T3, the
// same pair streamed, is probe_window_ring.cu.)
//
// T4 replaces tools/microbench_mxu_dots.py:bench (Pallas kernel _mk_kernel):
// the dot pair repeated REPS times on resident operands with a data
// dependency,
//   e = T(s + carry)                   (bf16)
//   e = int8 wrap((s + int(carry)) >> 7)   (int8: the int32 -> int8 cast wraps)
//   carry = carry * 0 + o[0, 0] * 1e-30  with o = e vhat of the block's
//   first window,
// and writes the last block's carry into an (8, 128) fill.  What bounds it:
// operations (the operands are read once, the products run REPS times).
// The TPU kernel keeps a grid step's 16 windows in VMEM; 16 windows of
// 89 KB (bf16, N 36, C 96, P 216) exceed the 227 KB of a block's shared
// memory, and one window of the pack-3 shape (N 108, P 648) alone needs
// 248 KB.  So a block owns 16 windows and walks them one at a time: q and
// e live in shared memory, khat and vhat are read in MMA-fragment form
// (transposed and zero-padded once by the wrapper) from the L1 / L2 caches,
// where they stay across the repetitions.  The block's first window records
// the carry of every repetition for the others, so each repetition of every
// window uses the same carry as on the TPU.  One block per 16 windows
// leaves most SMs idle at the tool's 1024 windows.
#include "common.cuh"

namespace nunif {
namespace {

constexpr int kDotThreads = 256;
constexpr int kDotWarps = kDotThreads / 32;
constexpr int kNChunk = 4;  // 8-column MMA tiles a warp accumulates at once

// A B for A in shared memory (m_tiles x 16 rows of k_words words, row stride
// lda words) and B given as B^T (n_tiles x 8 rows of k_words words, stride
// ldb); epi(r, c, v_c, v_c+1) for every row r and even column c.  Strides
// that are 4 mod 8 words make every fragment load conflict-free.
template <typename T, typename Epi>
__device__ __forceinline__ void block_dot(const uint32_t* A, int lda, const uint32_t* Bt, int ldb,
                                          int m_tiles, int n_tiles, int k_words, Epi epi) {
  using Acc = typename DotMma<T>::Acc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (n_tiles + kNChunk - 1) / kNChunk;
  for (int it = warp; it < m_tiles * chunks; it += kDotWarps) {
    const int m = it / chunks, n0 = (it % chunks) * kNChunk;
    Acc acc[kNChunk][4] = {};
    const uint32_t* a0 = A + (size_t)(m * 16 + g) * lda + t;
    const uint32_t* a1 = a0 + (size_t)8 * lda;
    for (int k = 0; k < k_words; k += 8) {
      const uint32_t a[4] = {a0[k], a1[k], a0[k + 4], a1[k + 4]};
#pragma unroll
      for (int j = 0; j < kNChunk; ++j) {
        if (n0 + j < n_tiles) {
          const uint32_t* b = Bt + (size_t)((n0 + j) * 8 + g) * ldb + k + t;
          DotMma<T>::mma(acc[j], a, b[0], b[4]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNChunk; ++j) {
      if (n0 + j < n_tiles) {
        const int r = m * 16 + g, c = (n0 + j) * 8 + 2 * t;
        epi(r, c, acc[j][0], acc[j][1]);
        epi(r + 8, c, acc[j][2], acc[j][3]);
      }
    }
  }
}

struct DotArgs {
  const void* q;     // (nw, N, C)
  const void* khat;  // khat^T zero-padded (nw, p_pad, c_pad)
  const void* vhat;  // vhat^T zero-padded (nw, C, p_pad)
  void* out;         // (8, 128) fp32
  int nw, N, C, P, Cv, Cout;
  int n_pad, c_pad, p_pad;  // N to 16 rows, C and P to 32 elements
  int lq, le;               // shared-memory row strides in words
  int reps, bw;
};

// Shared memory, in words: q (n_pad x lq), e (n_pad x le), then the
// carries (reps + 1).
struct DotSmem {
  size_t q, e, extra, total;
};

__host__ __device__ inline DotSmem dot_smem(const DotArgs& p) {
  DotSmem s;
  s.q = 0;
  s.e = s.q + (size_t)p.n_pad * p.lq;
  s.extra = s.e + (size_t)p.n_pad * p.le;
  s.total = s.extra + (size_t)p.reps + 1;
  return s;
}

template <typename T>
__device__ __forceinline__ T elem_zero() {
  if constexpr (std::is_same<T, int8_t>::value) {
    return 0;
  } else {
    return __float2bfloat16_rn(0.f);
  }
}

// Stage q of window w as rows of C (zero padding).
template <typename T>
__device__ void stage_q(const DotArgs& p, const DotSmem& L, uint32_t* sm, int w) {
  constexpr int epw = 4 / sizeof(T);  // elements a word
  T* Q = reinterpret_cast<T*>(sm + L.q);
  const T* q = static_cast<const T*>(p.q) + (size_t)w * p.N * p.C;
  const T zero = elem_zero<T>();
  for (int e = threadIdx.x; e < p.n_pad * p.c_pad; e += kDotThreads) {
    const int r = e / p.c_pad, c = e % p.c_pad;
    Q[(size_t)r * p.lq * epw + c] = (r < p.N && c < p.C) ? q[(size_t)r * p.C + c] : zero;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDotThreads) window_dots_repeat_kernel(DotArgs p) {
  extern __shared__ __align__(128) uint32_t sm[];
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int epw = 4 / sizeof(T);
  const DotSmem L = dot_smem(p);
  float* carry = reinterpret_cast<float*>(sm + L.extra);  // carry before rep i
  T* E = reinterpret_cast<T*>(sm + L.e);
  const int kw = p.c_pad / epw, pw = p.p_pad / epw;  // global row strides, words
  if (threadIdx.x == 0) carry[0] = 0.f;
  for (int wi = 0; wi < p.bw; ++wi) {
    const int w = blockIdx.x * p.bw + wi;
    const uint32_t* kt = static_cast<const uint32_t*>(p.khat) + (size_t)w * p.p_pad * kw;
    const uint32_t* vt = static_cast<const uint32_t*>(p.vhat) + (size_t)w * p.C * pw;
    stage_q<T>(p, L, sm, w);
    __syncthreads();
    for (int rep = 0; rep < p.reps; ++rep) {
      const float cin = carry[rep];
      block_dot<T>(sm + L.q, p.lq, kt, kw, p.n_pad / 16, p.p_pad / 8, kw,
                   [&](int r, int c, auto v0, auto v1) {
                     T* er = E + (size_t)r * p.le * epw + c;
                     if constexpr (kInt8) {
                       // arithmetic shift, then the wrapping int32 -> int8 cast
                       const int ci = (int)cin;
                       er[0] = (int8_t)(uint8_t)(((int)v0 + ci) >> 7);
                       er[1] = (int8_t)(uint8_t)(((int)v1 + ci) >> 7);
                     } else {
                       store2(er, (float)v0 + cin, (float)v1 + cin);
                     }
                   });
      __syncthreads();
      block_dot<T>(sm + L.e, p.le, vt, pw, p.n_pad / 16, p.Cout / 8, pw,
                   [&](int r, int c, auto v0, auto /*v1*/) {
                     if (wi == 0 && r == 0 && c == 0) carry[rep + 1] = cin * 0.f + (float)v0 * 1e-30f;
                   });
      __syncthreads();
    }
  }
  if (blockIdx.x == gridDim.x - 1) {  // the last grid step's value stands
    float* out = static_cast<float*>(p.out);
    for (int i = threadIdx.x; i < 8 * 128; i += kDotThreads) out[i] = carry[p.reps];
  }
}

// Paddings and strides (4 mod 8 words) for element type T.
template <typename T>
cudaError_t dot_layout(DotArgs& p) {
  constexpr int epw = 4 / sizeof(T);
  if (p.nw < 1 || p.N < 1 || p.C < 1 || p.P < 1 || p.Cout < 8 || p.Cout % 8 || p.Cout > p.Cv)
    return cudaErrorInvalidValue;
  p.n_pad = (int)align_up(p.N, 16);
  p.c_pad = (int)align_up(p.C, 32);
  p.p_pad = (int)align_up(p.P, 32);
  p.lq = p.c_pad / epw + 4;
  p.le = p.p_pad / epw + 4;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dots(DotArgs p, cudaStream_t stream) {
  cudaError_t err = dot_layout<T>(p);
  if (err != cudaSuccess) return err;
  const size_t smem = dot_smem(p).total * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  if (p.reps < 1 || p.bw < 1 || p.nw % p.bw) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(window_dots_repeat_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_dots_repeat_kernel<T><<<p.nw / p.bw, kDotThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kDotBF16 = 1;
constexpr int kDotInt8 = 2;

int dots(int dtype, const DotArgs& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == kDotBF16  ? launch_dots<__nv_bfloat16>(p, s)
                    : dtype == kDotInt8 ? launch_dots<int8_t>(p, s)
                                        : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace
}  // namespace nunif

// T4.  kt: khat^T zero-padded to (nw, roundup(P, 32), roundup(C, 32)); vt:
// vhat^T zero-padded to (nw, C, roundup(P, 32)); out (8, 128) fp32; nw a
// multiple of bw; C a multiple of 8.
extern "C" int nunif_window_dots_repeat(int dtype, const void* q, const void* kt, const void* vt,
                                        void* out, int nw, int N, int C, int P, int reps, int bw,
                                        void* stream) {
  nunif::DotArgs p{q, kt, vt, out, nw, N, C, P, C, C};
  p.reps = reps;
  p.bw = bw;
  return nunif::dots(dtype, p, stream);
}
