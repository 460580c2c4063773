// Kernel 1's masked body, shared by kernels 1 and 3 (attention_scores.cu)
// and kernel 5 (attention_fused.cu): the additive score
//
//   s[n, t] = w . tanh(pre[t, :] + q[n, :])        (the bias is the caller's)
//
// of a warp's pair of adjacent rows (na, na + 1) over a 32-frame tile whose
// pre rows are staged in shared memory, 32 * KH hidden units at a time.
// Lanes run over hidden units, so a (row, frame) pair is uniform across the
// warp and a dead pair costs one bit test.  The warp has balloted the mask
// of both rows over the tile's frames (la, lb: bit f set where the row sees
// frame f) and walks only the frames where either row is live: one shared
// load of pre[t] feeds both rows' tanh (tanh.cuh).  The sum over H is a lane
// partial in a fixed order, then a butterfly over the warp; lane f keeps
// the score of frame f.  Padded hidden units have q = w = pre = 0 and add
// w * tanh(0) = 0.
#pragma once

#include "tanh.cuh"

namespace attention_body {

constexpr unsigned FULL = 0xffffffffu;

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

// Adds to res_a / res_c (lane f: frame f of the tile) rows na and na + 1's
// partial scores over the staged chunk [h0, h0 + 32 KH) of hidden units:
// pre_s4 holds the tile's frames from f0 on as [.][32 KH / 4] float4s, qb
// the video's q rows, wv this lane's units of w.  Only frames of la | lb
// are read.  Rows at or past N must have no live bit.
template <int KH>
__device__ __forceinline__ void pair_scores(const float4* __restrict__ pre_s4, int f0,
                                            const float* __restrict__ qb, int na, int N, int h0,
                                            int H, int lane, const float (&wv)[KH], unsigned la,
                                            unsigned lb, float& res_a, float& res_c) {
  constexpr int CH = 32 * KH;
  float qa[KH], qc[KH];
  if (na < N) load_lane_units<KH>(qb + (size_t)na * H, h0, H, lane, qa);
  if (na + 1 < N) load_lane_units<KH>(qb + (size_t)(na + 1) * H, h0, H, lane, qc);
  for (unsigned todo = la | lb; todo; todo &= todo - 1) {
    const int f = __ffs(todo) - 1;
    const float4* pr = pre_s4 + (f - f0) * (CH / 4) + lane;
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
      res_a += sa;
      res_c += sc;
    }
  }
}

}  // namespace attention_body
