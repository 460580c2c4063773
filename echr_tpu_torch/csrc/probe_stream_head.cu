// Kernels 7 and 8: the streaming greedy head of the head probes, for sm_90a.
//
// For each row r of out [R, C] (bf16), over the pre-padded vocab of w [C, VP]
// (bf16; VP a multiple of the vocab tile, the pad columns zero) and b [VP]
// (f32; -1e30 in the pad lanes, so a pad never wins or adds to the sum):
//   tok[r] = argmax_v logit[r, v], mx[r] = max_v logit[r, v],
//   lse[r] = log sum_v exp(logit[r, v]),  logit = out @ w + b,
// without the [R, VP] logits reaching global memory.  Kernel 7 replaces the
// Pallas TPU kernel experiments/probe_greedy_head.py::_greedy_head_kernel
// (pallas_call at :79), the fixed plan; kernel 8 replaces
// experiments/probe_streaming_head2.py::_kernel (pallas_call at :78), the same
// function with the tiling as a parameter.  Both are this one template over
// (TR rows per block, TV vocab columns per tile).
//
// Bound on an H100 by tensor-core throughput: 75.5 GFLOP bf16 per step at
// R=4096, C=1536, VP=6144, against 31.5 MB of inputs and outputs; w (18.9 MB)
// stays in the 50 MB L2.  The design is the probes' own: one block owns TR
// rows and walks every vocab tile in order (the TPU grid's sequential j
// axis), with no vocab split and no combine pass.  Each logit tile comes from
// nvcuda::wmma bf16 16x16x16 products with f32 accumulation, the whole
// [TR, TV] tile in the 8 warps' registers while the depth C streams through
// shared memory in BK=64 stages that cp.async double-buffers (the TPU kept a
// [TILE_R, C] row block resident in VMEM; a 1.5 MB block has no place in 227
// KB, so A streams like w).  The tile is then stored over the stages and
// folded into a running (max, argmax, sumexp) per row with accurate expf.
//
// Tilings instantiated (the H100's corner): TR in {32, 64, 128} x TV in {128,
// 256, 512} but (128, 512), whose f32 tile is 264 KB of shared memory (over
// 227 KB) and 256 accumulators a thread.  The trade-off: without a split
// there are R/TR blocks (128, 64, 32 at R=4096 against 132 SMs), and every
// block reads all of w from L2 (R/TR x 18.9 MB).  Kernel 7's plan is TV=512
// and the largest TR that fits: (64, 512).
//
// Ties, as the probes: within a tile the lowest index of the tile's max wins;
// a later tile takes over only on a strictly greater max.  The running max
// starts at -1e30 and the argmax at 0, as the probes' scratch does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 64;        // depth of one stage
constexpr int LDA = BK + 8;   // A stage row stride: 144 bytes, a wmma ldm

template <int TR, int TV>
struct Plan {
  static constexpr int WM = TR >= 64 ? 32 : 16;  // rows of one warp's tile
  static constexpr int WR = TR / WM;             // warps along the rows
  static constexpr int WC = 8 / WR;              // warps along the columns
  static constexpr int WN = TV / WC;             // columns of one warp's tile
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int LDW = TV + 8;              // w stage row stride
  static constexpr int TPR = THREADS / TR;        // fold threads per row
  static constexpr int LDL = TV + (TPR >= 8 ? 8 : 4);  // logit row stride
  static constexpr size_t STAGE = sizeof(bf16) * (TR * LDA + BK * LDW);
  static constexpr size_t SMEM = std::max(2 * STAGE, sizeof(float) * TR * LDL);
  static_assert(WR * WC == 8 && WN % 16 == 0 && TPR >= 1 && 32 % TPR == 0, "tiling");
  static_assert(FM * FN <= 16, "at most 128 accumulators a thread");
  static_assert(SMEM <= 227 * 1024, "the tile must fit one block's shared memory");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + TR) x depth [k0, k0 + BK) of out, and depth [k0, k0 + BK)
// x columns [v0, v0 + TV) of w, into one stage; zero outside R and C (C is a
// multiple of 8, so a 16-byte vector lies wholly inside or outside)
template <int TR, int TV>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sw, const bf16* __restrict__ a,
                                           const bf16* __restrict__ w, int row0, int R, int C,
                                           int VP, int v0, int k0) {
  using P = Plan<TR, TV>;
  constexpr int AV = BK / 8;  // 16-byte vectors of one A row
  for (int i = threadIdx.x; i < TR * AV; i += THREADS) {
    const int r = i / AV, c = (i % AV) * 8, k = k0 + c;
    const bool ok = row0 + r < R && k < C;
    cp_async16(sa + r * LDA + c, ok ? a + (size_t)(row0 + r) * C + k : a, ok);
  }
  constexpr int WV = TV / 8;  // 16-byte vectors of one w row
  for (int i = threadIdx.x; i < BK * WV; i += THREADS) {
    const int k = i / WV, c = (i % WV) * 8;
    const bool ok = k0 + k < C;
    cp_async16(sw + k * P::LDW + c, ok ? w + (size_t)(k0 + k) * VP + v0 + c : w, ok);
  }
}

template <int TR, int TV>
__global__ void __launch_bounds__(THREADS, 1)
stream_head_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias, int R, int C, int VP,
                   int* __restrict__ tok, float* __restrict__ mx, float* __restrict__ lse) {
  using P = Plan<TR, TV>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* logits = reinterpret_cast<float*>(smem);  // over the two stages
  bf16* const a0 = reinterpret_cast<bf16*>(smem);
  bf16* const a1 = reinterpret_cast<bf16*>(smem + P::STAGE);

  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / P::WC) * P::WM, wc = (warp % P::WC) * P::WN;
  const int r = threadIdx.x / P::TPR;  // the fold: TPR threads per row,
  const int j = threadIdx.x % P::TPR;  // thread j takes columns j, j + TPR, ...
  const int nk = (C + BK - 1) / BK;

  float m_run = -1e30f, l_run = 0.f;
  int a_run = 0;
  for (int v0 = 0; v0 < VP; v0 += TV) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[P::FM][P::FN];
#pragma unroll
    for (int i = 0; i < P::FM; ++i)
#pragma unroll
      for (int n = 0; n < P::FN; ++n) wmma::fill_fragment(acc[i][n], 0.f);
    load_stage<TR, TV>(a0, a0 + TR * LDA, a, w, row0, R, C, VP, v0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        bf16* next = (kt & 1) ? a0 : a1;
        load_stage<TR, TV>(next, next + TR * LDA, a, w, row0, R, C, VP, v0, (kt + 1) * BK);
      }
      cp_async_commit();
      cp_async_wait<1>();  // stage kt has landed; stage kt + 1 may be in flight
      __syncthreads();
      const bf16* sa = (kt & 1) ? a1 : a0;
      const bf16* sw = sa + TR * LDA;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[P::FM];
#pragma unroll
        for (int i = 0; i < P::FM; ++i)
          wmma::load_matrix_sync(fa[i], sa + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int n = 0; n < P::FN; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sw + kk * P::LDW + wc + 16 * n, P::LDW);
#pragma unroll
          for (int i = 0; i < P::FM; ++i) wmma::mma_sync(acc[i][n], fa[i], fb, acc[i][n]);
        }
      }
      __syncthreads();  // everyone is done with stage kt before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < P::FM; ++i)
#pragma unroll
      for (int n = 0; n < P::FN; ++n)
        wmma::store_matrix_sync(logits + (wr + 16 * i) * P::LDL + wc + 16 * n, acc[i][n], P::LDL,
                                wmma::mem_row_major);
    __syncthreads();

    float* lr = logits + r * P::LDL;
    float best = -INFINITY;
    int best_i = INT32_MAX;
    for (int c = j; c < TV; c += P::TPR) {  // ascending: strict > keeps the lower index
      const float x = lr[c] + bias[v0 + c];
      lr[c] = x;
      if (x > best) {
        best = x;
        best_i = v0 + c;
      }
    }
#pragma unroll
    for (int o = P::TPR / 2; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    const float m_new = fmaxf(m_run, best);
    float s = 0.f;
    for (int c = j; c < TV; c += P::TPR) s += expf(lr[c] - m_new);
#pragma unroll
    for (int o = P::TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    l_run = l_run * expf(m_run - m_new) + s;
    if (best > m_run) a_run = best_i;  // strict: an earlier tile keeps a tie
    m_run = m_new;
    __syncthreads();  // the next tile's loads overwrite the logit tile
  }
  const int row = row0 + r;
  if (j == 0 && row < R) {
    tok[row] = a_run;
    mx[row] = m_run;
    lse[row] = m_run + logf(l_run);
  }
}

template <int TR, int TV>
cudaError_t launch(cudaStream_t s, const void* out, const void* w, const void* b, int R, int C,
                   int VP, void* tok, void* mx, void* lse) {
  constexpr size_t smem = Plan<TR, TV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(stream_head_kernel<TR, TV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stream_head_kernel<TR, TV><<<(R + TR - 1) / TR, THREADS, smem, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(w), static_cast<const float*>(b),
      R, C, VP, static_cast<int*>(tok), static_cast<float*>(mx), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace

// out [R, C] bf16, w [C, VP] bf16, b [VP] f32 -> tok [R] int32, mx [R] f32,
// lse [R] f32.  C a multiple of 8, VP a multiple of tv, 16-byte aligned
// bases; (tr, tv) one of the instantiated tilings, else cudaErrorInvalidValue.
extern "C" int echr_probe_stream_head(const void* out, const void* w, const void* b, int R,
                                      int C, int VP, int tr, int tv, void* tok, void* mx,
                                      void* lse, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define ECHR_TILING(TR, TV) \
  if (tr == TR && tv == TV) err = launch<TR, TV>(s, out, w, b, R, C, VP, tok, mx, lse);
  ECHR_TILING(32, 128)
  ECHR_TILING(32, 256)
  ECHR_TILING(32, 512)
  ECHR_TILING(64, 128)
  ECHR_TILING(64, 256)
  ECHR_TILING(64, 512)
  ECHR_TILING(128, 128)
  ECHR_TILING(128, 256)
#undef ECHR_TILING
  return static_cast<int>(err);
}
