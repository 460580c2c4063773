// Kernels 1 and 3: additive-attention scores, for sm_90a.
//
//   s[b, n, t] = w . tanh(pre[b, t, :] + q[b, n, :]) + bias   where mask != 0
//
// Kernel 1 replaces the Pallas TPU kernel
// echr_tpu/ops/pallas_attention.py::_kernel_skip (pallas_call at :153), the
// no-grad decode scores; kernel 3 replaces ::_kernel (pallas_call at :52),
// the forward of the differentiable training scores.  Both run the one
// masked body below under their own C entry points: the masked softmax that
// reads the scores ignores every entry where mask == 0 (and passes a zero
// cotangent there in training), so the tanh is evaluated only at live
// (n, t).  Both are bound on an H100 by the throughput of that tanh, not by
// their 2-4 MB of output; it is echr_tanh (tanh.cuh), 7 instructions against
// CUDA tanhf's 15 at the same accuracy gate.  Built without fast math.
#include <cuda_runtime.h>

#include "attention_body.cuh"

namespace {

using namespace attention_body;

// ---------------------------------------------------------------------------
// The masked body: work in proportion to the live (n, t) pairs.  A
// proposal's window covers only part of the video, so the tanh is evaluated
// only where mask != 0: B * N * T * H = 537M tanh per greedy step before the
// mask, ~1.06 G at the beam path's N * k = 512 rows after it, 268M per
// teacher-forced step (N = 64 sampled proposals) before it.
//
// Lanes run over hidden units, so a (row, frame) pair is uniform across a
// warp and a dead pair costs one bit test.  One block per (video b, 32-frame
// tile, 32 rows) stages pre[b, tile, :] in shared memory, CH = 32 * KH hidden
// units at a time (64 KB at H = 512, so three blocks share an SM, and the
// launch bounds hold a thread to 80 registers to match); each warp owns two
// pairs of adjacent rows (the k beams of a proposal are adjacent and share a
// window).  For each pair the warp ballots the mask over the tile's frames,
// holds both rows' q and w in registers (KH a lane) and walks only the
// frames where either row is live (attention_body.cuh's pair_scores, which
// kernel 5 runs too).  Masked entries are written as 0.  Any mask is exact:
// the rows need not be sorted.  Ragged N, T and H are masked in the block.
// ---------------------------------------------------------------------------
constexpr int MF = 32;                    // frames per block: one mask bit per lane
constexpr int MWARPS = 8;
constexpr int MTHREADS = MWARPS * 32;
constexpr int PAIRS = 2;                  // row pairs per warp
constexpr int MROWS = 2 * PAIRS * MWARPS; // rows per block

template <int KH>
__global__ void __launch_bounds__(MTHREADS, 3)
masked_scores_kernel(const float* __restrict__ pre, const float* __restrict__ q,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int N, int T, int H) {
  constexpr int CH = 32 * KH;  // hidden units staged per pass
  extern __shared__ float4 pre_s4[];  // [MF][CH / 4]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * MF;
  const int n0 = blockIdx.y * MROWS;
  const int b = blockIdx.z;
  const int t = t0 + lane;
  const size_t nt = (size_t)N * T;
  const float* m = mask + (size_t)b * nt;
  float* o = out + (size_t)b * nt;

  // live[p][r]: bit f set where row (pair p, member r) sees frame t0 + f
  unsigned live[PAIRS][2];
  int any = 0;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 2 * (warp + MWARPS * p) + r;
      live[p][r] = __ballot_sync(FULL, n < N && t < T && m[(size_t)n * T + t] != 0.f);
      any |= live[p][r] != 0u;
    }
  float res[PAIRS][2] = {};  // lane f: the score of frame t0 + f, without the bias

  if (__syncthreads_or(any)) {  // else no row of this block sees any of its frames
    const float* pb = pre + (size_t)b * T * H;
    const float* qb = q + (size_t)b * N * H;
    float* pre_s = reinterpret_cast<float*>(pre_s4);
    for (int h0 = 0; h0 < H; h0 += CH) {
      if (h0 > 0) __syncthreads();  // every warp is done with the last chunk
      for (int i = threadIdx.x; i < MF * CH; i += MTHREADS) {
        const int r = i / CH, c = i % CH;
        const int tt = t0 + r, hh = h0 + c;
        pre_s[i] = (tt < T && hh < H) ? pb[(size_t)tt * H + hh] : 0.f;
      }
      __syncthreads();
      float wv[KH];
      load_lane_units<KH>(w, h0, H, lane, wv);
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const unsigned la = live[p][0], lb = live[p][1];
        if (!(la | lb)) continue;
        pair_scores<KH>(pre_s4, 0, qb, n0 + 2 * (warp + MWARPS * p), N, h0, H, lane, wv, la,
                        lb, res[p][0], res[p][1]);
      }
    }
  }

  const float bb = bias[0];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 2 * (warp + MWARPS * p) + r;
      if (n < N && t < T)
        o[(size_t)n * T + t] = ((live[p][r] >> lane) & 1u) ? res[p][r] + bb : 0.f;
    }
}

template <int KH>
int launch_masked(const float* pre, const float* q, const float* w, const float* b,
                  const float* mask, float* out, int B, int N, int T, int H, cudaStream_t s) {
  const int smem = MF * 32 * KH * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(masked_scores_kernel<KH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + MF - 1) / MF, (N + MROWS - 1) / MROWS, B);
  masked_scores_kernel<KH><<<grid, MTHREADS, smem, s>>>(pre, q, w, b, mask, out, N, T, H);
  return static_cast<int>(cudaGetLastError());
}

// The chunk of hidden units is the smallest of 128, 256 and 512 that holds
// H; a larger H takes several 512-unit chunks.
int launch_scores(const void* pre, const void* q, const void* w, const void* b,
                  const void* mask, void* out, int B, int N, int T, int H, void* stream) {
  const auto* p = static_cast<const float*>(pre);
  const auto* qq = static_cast<const float*>(q);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 128) return launch_masked<4>(p, qq, ww, bb, m, o, B, N, T, H, s);
  if (H <= 256) return launch_masked<8>(p, qq, ww, bb, m, o, B, N, T, H, s);
  return launch_masked<16>(p, qq, ww, bb, m, o, B, N, T, H, s);
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T] -> out [B, N, T];
// all f32, contiguous, on the device of `stream`.  Exact wherever mask != 0;
// 0 elsewhere.
// Kernel 1: the no-grad decode scores.
extern "C" int echr_attention_scores(const void* pre, const void* q, const void* w,
                                     const void* b, const void* mask, void* out,
                                     int B, int N, int T, int H, void* stream) {
  return launch_scores(pre, q, w, b, mask, out, B, N, T, H, stream);
}

// Kernel 3: the forward of the differentiable training scores, the same
// arguments and body.
extern "C" int echr_attention_scores_dense(const void* pre, const void* q, const void* w,
                                           const void* b, const void* mask, void* out,
                                           int B, int N, int T, int H, void* stream) {
  return launch_scores(pre, q, w, b, mask, out, B, N, T, H, stream);
}
