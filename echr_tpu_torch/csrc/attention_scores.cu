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

#include "tanh.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

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
// window).  For each pair the warp
// ballots the mask over the tile's frames, holds both rows' q and w in
// registers (KH a lane), and walks only the frames where either row is live:
// one shared load of pre[t] feeds both rows' tanh.  The sum over H is a lane
// partial in a fixed order, then a butterfly over the warp; lane t keeps the
// score of frame t.  Masked entries are written as 0.  Any mask is exact:
// the rows need not be sorted.  Ragged N, T and H are masked in the block
// (padded hidden units have q = w = pre = 0 and add w * tanh(0) = 0).
// ---------------------------------------------------------------------------
constexpr int MF = 32;                    // frames per block: one mask bit per lane
constexpr int MWARPS = 8;
constexpr int MTHREADS = MWARPS * 32;
constexpr int PAIRS = 2;                  // row pairs per warp
constexpr int MROWS = 2 * PAIRS * MWARPS; // rows per block

// Lane `lane` holds hidden units h0 + 4 * (lane + 32 * j) + c of a chunk, for
// j < KH / 4 and c < 4, so a warp reads a staged row of pre as float4s
// without bank conflicts.
template <int KH>
__device__ __forceinline__ void load_lane_units(const float* __restrict__ src, int h0, int H,
                                                int lane, float (&dst)[KH]) {
#pragma unroll
  for (int j = 0; j < KH / 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = h0 + 4 * (lane + 32 * j) + c;
      dst[4 * j + c] = h < H ? src[h] : 0.f;
    }
}

template <int KH>
__device__ __forceinline__ float lane_dot_tanh(const float4* __restrict__ pr,
                                               const float (&qv)[KH], const float (&wv)[KH]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KH / 4; ++j) {
    const float4 p = pr[32 * j];
    s = fmaf(wv[4 * j + 0], echr_tanh(qv[4 * j + 0] + p.x), s);
    s = fmaf(wv[4 * j + 1], echr_tanh(qv[4 * j + 1] + p.y), s);
    s = fmaf(wv[4 * j + 2], echr_tanh(qv[4 * j + 2] + p.z), s);
    s = fmaf(wv[4 * j + 3], echr_tanh(qv[4 * j + 3] + p.w), s);
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

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
        const int na = n0 + 2 * (warp + MWARPS * p);
        float qa[KH], qc[KH];
        if (na < N) load_lane_units<KH>(qb + (size_t)na * H, h0, H, lane, qa);
        if (na + 1 < N) load_lane_units<KH>(qb + (size_t)(na + 1) * H, h0, H, lane, qc);
        for (unsigned todo = la | lb; todo; todo &= todo - 1) {
          const int f = __ffs(todo) - 1;
          const float4* pr = pre_s4 + f * (CH / 4) + lane;
          const bool ra = (la >> f) & 1u, rc = (lb >> f) & 1u;
          float sa, sc;
          if (ra && rc) {
            sa = lane_dot_tanh<KH>(pr, qa, wv);
            sc = lane_dot_tanh<KH>(pr, qc, wv);
            // both sums in one butterfly: after the first exchange lanes 0-15
            // carry row a's partials and lanes 16-31 row c's
            const bool hi = lane & 16;
            float v = (hi ? sc : sa) + __shfl_xor_sync(FULL, hi ? sa : sc, 16);
#pragma unroll
            for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
            const float other = __shfl_xor_sync(FULL, v, 16);
            sa = hi ? other : v;
            sc = hi ? v : other;
          } else if (ra) {
            sa = warp_sum(lane_dot_tanh<KH>(pr, qa, wv));
            sc = 0.f;
          } else {
            sa = 0.f;
            sc = warp_sum(lane_dot_tanh<KH>(pr, qc, wv));
          }
          if (lane == f) {
            res[p][0] += sa;
            res[p][1] += sc;
          }
        }
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
