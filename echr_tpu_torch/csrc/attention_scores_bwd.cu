// Kernel 4: the backward of the differentiable additive-attention scores
// (kernel 3), for sm_90a.
//
//   y = tanh(pre[b, t, :] + q[b, n, :]),  dz = g[b, n, t] * w * (1 - y^2)
//   d_pre[b, t, :] = sum_n dz,  d_q[b, n, :] = sum_t dz,
//   d_w = sum_{b, n, t} g[b, n, t] * y
//
// Replaces the Pallas TPU kernel echr_tpu/ops/pallas_attention.py::_bwd_kernel
// (pallas_call at :344), the custom VJP of the training scores.  Like it, this
// recomputes y tile by tile, so the [B, N, T, H] tanh never reaches device
// memory.  Bound on an H100 by the throughput of its tanh and the
// FMAs around it: B*N*T*H = 268M tanh per teacher-forced step at training
// dims (B=32, N=64, T=256, H=512), plus ~7 FMA-class operations each, against
// 21 MB of gradients out.
//
// The TPU kernel carried d_pre and d_w across a sequential grid.  Blocks on
// Hopper run in no order, so the design is:
//   * one block per (video b, 64-frame tile, 32-unit hidden chunk) loops over
//     all N proposals, NT at a time, and keeps d_pre of its 64 x 32 outputs in
//     registers (each of the 256 threads owns hidden unit `lane` at 8 frames);
//   * d_q is summed over the block's frames through shared memory in a fixed
//     warp order and written as per-frame-tile partials [B, T/64, N, H];
//   * d_w is summed per block into partials [B * T/64, H];
//   * a second kernel sums both partials in a fixed order.
// No float atomics: two runs give identical bits.  Ragged N, T and H are
// masked in the block (zero g and w contribute nothing).  Built without fast
// math; the tanh is echr_tanh (tanh.cuh).
//
// Zero cotangents are skipped.  On the training path g comes through the
// masked softmax, so g == 0 exactly wherever the window mask is 0, and such
// an (n, t) adds +-0 to d_pre, d_q and d_w.  Each warp loads the 16 x 8
// entries of g at its own frames (ty + WARPS * k) and ballots them, which
// gives one byte of liveness per proposal.  An (n, t) is uniform across the
// warp's lanes (they are hidden units), so a zero g skips its tanh and FMAs
// without divergence.  A warp whose 16 x 8 entries are all live runs the
// dense loop with no test at all, and a pass whose whole 16 x 64 tile of g
// is zero computes nothing and writes zero d_q partials.  Frames stay
// interleaved over the warps, so a short window still spreads over all
// eight.  The outputs are those of the dense loop up to the sign of zeros.
#include <cuda_runtime.h>

#include "tanh.cuh"

namespace {

constexpr int BT = 64;               // frames per block
constexpr int BH = 32;               // hidden units per block, one per lane
constexpr int NT = 16;               // proposals staged per pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FPT = BT / WARPS;      // frames per thread: ty + WARPS * k
static_assert(FPT == 8 && NT % 4 == 0, "a ballot of g covers 4 proposals x 8 frames");

// One (n, t) term at this thread's hidden unit: y = tanh(pre + q),
// dz = g w (1 - y^2) into d_pre and d_q, g y into d_w.
__device__ __forceinline__ void bwd_term(float gv, float pv, float qv, float wv, float& dp,
                                         float& dq, float& dw) {
  const float y = echr_tanh(pv + qv);
  const float gw = gv * wv;
  const float dz = fmaf(-gw * y, y, gw);  // g w (1 - y^2)
  dp += dz;
  dq += dz;
  dw = fmaf(gv, y, dw);
}

__global__ void __launch_bounds__(THREADS)
scores_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ q,
                  const float* __restrict__ w, const float* __restrict__ g,
                  float* __restrict__ d_pre, float* __restrict__ dq_part,
                  float* __restrict__ dw_part, int N, int T, int H) {
  // each warp's own cotangents: g_s[ty][i * FPT + k] = g[n0 + i, t0 + ty + WARPS * k],
  // byte i of live_s[ty] has bit k set where that entry is nonzero, and
  // q_s[ty][i][lane] = q[n0 + i, h] (a copy per warp: no block barrier)
  __shared__ float g_s[WARPS][NT * FPT];
  __shared__ unsigned live_s[WARPS][NT * FPT / 32];
  __shared__ float q_s[WARPS][NT][BH];
  __shared__ float red_s[WARPS][NT][BH];
  __shared__ float dw_s[WARPS][BH];

  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int h0 = blockIdx.x * BH;
  const int h = h0 + lane;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int t0 = tile * BT;
  const int b = blockIdx.z;
  const bool hv = h < H;

  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  const float* gb = g + (size_t)b * N * T;
  const float wv = hv ? w[h] : 0.f;

  float p[FPT], dp[FPT];
#pragma unroll
  for (int k = 0; k < FPT; ++k) {
    const int t = t0 + ty + WARPS * k;
    p[k] = (hv && t < T) ? pb[(size_t)t * H + h] : 0.f;
    dp[k] = 0.f;
  }
  float dw = 0.f;

  for (int n0 = 0; n0 < N; n0 += NT) {
    // lane l holds entry (i, k) = (4 r + l / 8, l % 8) in gr[r]; the ballot of
    // gr[r] != 0 is then the live bytes of rows 4 r .. 4 r + 3
    constexpr int R = NT * FPT / 32;
    float gr[R];
    unsigned lv[R];
    unsigned any = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + 4 * r + (lane >> 3), t = t0 + ty + WARPS * (lane & 7);
      gr[r] = (n < N && t < T) ? gb[(size_t)n * T + t] : 0.f;
      lv[r] = __ballot_sync(0xffffffffu, gr[r] != 0.f);
      any |= lv[r];
    }
    if (!__syncthreads_or(any != 0u)) {
      // a zero tile of g: no d_pre or d_w term, and zero d_q partials
      for (int j = threadIdx.x; j < NT * BH; j += THREADS) {
        const int n = n0 + j / BH, hh = h0 + j % BH;
        if (n < N && hh < H) dq_part[(((size_t)b * n_tiles + tile) * N + n) * H + hh] = 0.f;
      }
      continue;
    }
    unsigned all = 0xffffffffu;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g_s[ty][32 * r + lane] = gr[r];
      if (lane == 0) live_s[ty][r] = lv[r];
      all &= lv[r];
    }
    if (any) {
      for (int i = 0; i < NT; ++i)
        q_s[ty][i][lane] = (hv && n0 + i < N) ? qb[(size_t)(n0 + i) * H + h] : 0.f;
    }
    __syncwarp();
    if (all == 0xffffffffu) {  // every entry of this warp's frames is live
      for (int i = 0; i < NT; ++i) {
        const float qv = q_s[ty][i][lane];
        const float* gi = g_s[ty] + i * FPT;
        float dq = 0.f;
#pragma unroll
        for (int k = 0; k < FPT; ++k) bwd_term(gi[k], p[k], qv, wv, dp[k], dq, dw);
        red_s[ty][i][lane] = dq;
      }
    } else {
      const unsigned char* live_i = reinterpret_cast<const unsigned char*>(live_s[ty]);
      for (int i = 0; i < NT; ++i) {
        const unsigned live = live_i[i];
        float dq = 0.f;
        if (live) {
          const float qv = q_s[ty][i][lane];
          const float* gi = g_s[ty] + i * FPT;
#pragma unroll
          for (int k = 0; k < FPT; ++k)
            if ((live >> k) & 1u) bwd_term(gi[k], p[k], qv, wv, dp[k], dq, dw);
        }
        red_s[ty][i][lane] = dq;
      }
    }
    __syncthreads();
    // d_q over this block's frames: the 8 warps' sums in a fixed order
    for (int j = threadIdx.x; j < NT * BH; j += THREADS) {
      const int i = j / BH, c = j % BH;
      const int n = n0 + i, hh = h0 + c;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) s += red_s[k][i][c];
      if (n < N && hh < H) dq_part[(((size_t)b * n_tiles + tile) * N + n) * H + hh] = s;
    }
    // the next pass writes red_s only after its __syncthreads_or
  }

#pragma unroll
  for (int k = 0; k < FPT; ++k) {
    const int t = t0 + ty + WARPS * k;
    if (hv && t < T) d_pre[((size_t)b * T + t) * H + h] = dp[k];
  }
  dw_s[ty][lane] = dw;
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < BH && h0 + tid < H) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += dw_s[k][tid];
    dw_part[((size_t)b * n_tiles + tile) * H + h0 + tid] = s;
  }
}

// d_q[b, n, h] = sum over frame tiles of dq_part, and d_w[h] = sum over
// (video, frame tile) of dw_part, each in a fixed order.
__global__ void scores_bwd_reduce(const float* __restrict__ dq_part,
                                  const float* __restrict__ dw_part, float* __restrict__ d_q,
                                  float* __restrict__ d_w, int B, int n_tiles, int N, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nh = (size_t)N * H;
  const size_t total_q = (size_t)B * nh;
  if (i < total_q) {
    const size_t b = i / nh, r = i % nh;
    const float* src = dq_part + b * n_tiles * nh + r;
    float s = 0.f;
    for (int j = 0; j < n_tiles; ++j) s += src[j * nh];
    d_q[i] = s;
  } else if (i < total_q + H) {
    const size_t hh = i - total_q;
    float s = 0.f;
    for (int j = 0; j < B * n_tiles; ++j) s += dw_part[(size_t)j * H + hh];
    d_w[hh] = s;
  }
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H], g [B, N, T] -> d_pre [B, T, H],
// d_q [B, N, H], d_w [H]; scratch dq_part [B, ceil(T/64), N, H] and
// dw_part [B * ceil(T/64), H].  All f32, contiguous, on the device of
// `stream`; B, N, T and H are positive.
extern "C" int echr_attention_scores_bwd(const void* pre, const void* q, const void* w,
                                         const void* g, void* d_pre, void* d_q, void* d_w,
                                         void* dq_part, void* dw_part, int B, int N, int T,
                                         int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (T + BT - 1) / BT;
  dim3 grid((H + BH - 1) / BH, n_tiles, B);
  scores_bwd_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(pre), static_cast<const float*>(q),
      static_cast<const float*>(w), static_cast<const float*>(g), static_cast<float*>(d_pre),
      static_cast<float*>(dq_part), static_cast<float*>(dw_part), N, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = (size_t)B * N * H + H;
  const int threads = 256;
  scores_bwd_reduce<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(dq_part), static_cast<const float*>(dw_part),
      static_cast<float*>(d_q), static_cast<float*>(d_w), B, n_tiles, N, H);
  return static_cast<int>(cudaGetLastError());
}
