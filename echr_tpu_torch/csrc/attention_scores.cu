// Kernels 1 and 3: additive-attention scores, for sm_90a.
//
//   s[b, n, t] = w . tanh(pre[b, t, :] + q[b, n, :]) + bias
//
// Kernel 1 (masked) replaces the Pallas TPU kernel
// echr_tpu/ops/pallas_attention.py::_kernel_skip (pallas_call at :153), the
// no-grad decode scores; kernel 3 (dense) replaces ::_kernel (pallas_call at
// :52), the forward of the differentiable training scores.  Both share one
// device body, a template on MASKED.  Bound on an H100 by the throughput of
// the accurate tanhf: B*N*T*H = 537M tanh per decode step at serving dims and
// 268M per teacher-forced step at training dims, against 2-4 MB of output.
// One block per (video b, 16-proposal tile, 32-frame tile) stages the tile's q
// rows and pre rows in shared memory, HC hidden units at a time, and each of
// its 256 threads reduces over H for two outputs (proposals ty and ty + 8 at
// frame tx).  Masked: a block whose tile of the window mask holds no 1 writes
// zeros and computes no tanh.  Dense: every tile is computed.  Ragged N, T and
// H are masked in the block.  Built without fast math: tanhf is the accurate
// one.
#include <cuda_runtime.h>

namespace {

constexpr int TN = 16;        // proposals per block
constexpr int TT = 32;        // frames per block (one per lane)
constexpr int HC = 64;        // hidden units staged per pass
constexpr int THREADS = 256;  // 8 warps: warp ty owns proposals ty, ty + 8

template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const float* __restrict__ pre, const float* __restrict__ q,
              const float* __restrict__ w, const float* __restrict__ bias,
              const float* __restrict__ mask, float* __restrict__ out,
              int N, int T, int H) {
  __shared__ float pre_s[TT][HC + 1];  // +1: lanes read distinct banks
  __shared__ float q_s[TN][HC];        // one row per warp: a broadcast read
  __shared__ float w_s[HC];

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * TN;
  const int t0 = blockIdx.x * TT;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int t = t0 + tx;
  const int na = n0 + ty;
  const int nb = n0 + ty + 8;
  const bool ta = t < T && na < N;
  const bool tb = t < T && nb < N;

  const size_t nt = (size_t)N * T;
  float* o = out + (size_t)b * nt;
  if constexpr (MASKED) {
    const float* m = mask + (size_t)b * nt;
    int any = 0;
    if (ta) any |= m[(size_t)na * T + t] != 0.f;
    if (tb) any |= m[(size_t)nb * T + t] != 0.f;
    if (!__syncthreads_or(any)) {
      // no proposal of this tile sees any of its frames: the caller's
      // masked softmax reads none of these scores
      if (ta) o[(size_t)na * T + t] = 0.f;
      if (tb) o[(size_t)nb * T + t] = 0.f;
      return;
    }
  }

  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  float acc_a = 0.f, acc_b = 0.f;
  for (int h0 = 0; h0 < H; h0 += HC) {
    for (int i = threadIdx.x; i < TT * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const int tt = t0 + r, hh = h0 + c;
      pre_s[r][c] = (tt < T && hh < H) ? pb[(size_t)tt * H + hh] : 0.f;
    }
    for (int i = threadIdx.x; i < TN * HC; i += THREADS) {
      const int r = i / HC, c = i % HC;
      const int nn = n0 + r, hh = h0 + c;
      q_s[r][c] = (nn < N && hh < H) ? qb[(size_t)nn * H + hh] : 0.f;
    }
    if (threadIdx.x < HC) {
      const int hh = h0 + threadIdx.x;
      w_s[threadIdx.x] = hh < H ? w[hh] : 0.f;
    }
    __syncthreads();
    const int hn = min(HC, H - h0);
    for (int c = 0; c < hn; ++c) {
      const float p = pre_s[tx][c];
      const float wc = w_s[c];
      acc_a = fmaf(wc, tanhf(q_s[ty][c] + p), acc_a);
      acc_b = fmaf(wc, tanhf(q_s[ty + 8][c] + p), acc_b);
    }
    __syncthreads();
  }
  const float bb = bias[0];
  if (ta) o[(size_t)na * T + t] = acc_a + bb;
  if (tb) o[(size_t)nb * T + t] = acc_b + bb;
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T] -> out [B, N, T];
// all f32, contiguous, on the device of `stream`.
extern "C" int echr_attention_scores(const void* pre, const void* q, const void* w,
                                     const void* b, const void* mask, void* out,
                                     int B, int N, int T, int H, void* stream) {
  dim3 grid((T + TT - 1) / TT, (N + TN - 1) / TN, B);
  scores_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(q),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<float*>(out), N, T, H);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3: the same scores at every (n, t), no mask.
// pre [B, T, H], q [B, N, H], w [H], b [1] -> out [B, N, T]; all f32,
// contiguous, on the device of `stream`.
extern "C" int echr_attention_scores_dense(const void* pre, const void* q, const void* w,
                                           const void* b, void* out, int B, int N, int T,
                                           int H, void* stream) {
  dim3 grid((T + TT - 1) / TT, (N + TN - 1) / TN, B);
  scores_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(q),
      static_cast<const float*>(w), static_cast<const float*>(b), nullptr,
      static_cast<float*>(out), N, T, H);
  return static_cast<int>(cudaGetLastError());
}
