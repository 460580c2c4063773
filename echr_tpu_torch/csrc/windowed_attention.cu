// Kernel 6: windowed additive attention, for sm_90a.
//
//   s[n, t]   = w . tanh(pre[t, :] + q[n, :]) + bias          for s_n <= t < e_n
//   att[n, :] = sum_{s_n <= t < e_n} softmax_t(s[n, t]) feats[t, :]
//
// for every proposal n of every video b, all in f32: only the frames of
// each proposal's window [s_n, e_n) are scored, so the tanh count falls
// from N*T*H to sum_n (e_n - s_n) * H.  A zero-length window gives zeros.
// Replaces the Pallas TPU kernel
// echr_tpu/ops/pallas_windowed_attention.py::_kernel (pallas_call at :96,
// wrapper windowed_attention :137).  The TPU kernel's 8-aligned DMA
// starts, its W + 8 margin and its end clamp with a shift are sublane
// rules and are gone: a block reads pre[s:e] and feats[s:e] directly,
// coalesced along H and D.  The window is streamed in 32-frame chunks
// with an online softmax, so every window length is exact, also past the
// W that echr_tpu's contract (e - s <= W) bounds.
//
// What bounds it on an H100: bytes, counting each input once (~100 MB at
// the beam path's shapes, ~30 us at 3.35 TB/s); the tanh of the windows
// comes next.  The design: one block of 4 warps per (video, proposal)
// stages the proposal's q row and w in shared memory; warp i scores frames
// i, i + 4, ... of a chunk, its lanes splitting H (coalesced pre rows) and
// a shuffle reducing the sum; each thread then rescales and accumulates
// its own columns of the [D] accumulator in shared memory, reading its
// column of the feats chunk once.  The k beam copies of a proposal read
// the same window rows, which L2 serves.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 32;  // frames per chunk
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dynamic shared memory: q_s[H], w_s[H], acc_s[D]
__global__ void __launch_bounds__(THREADS)
windowed_kernel(const float* __restrict__ pre, const float* __restrict__ feats,
                const float* __restrict__ q, const float* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ soi,
                float* __restrict__ out, int N, int T, int H, int D) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* w_s = smem + H;
  float* acc_s = smem + 2 * H;
  __shared__ float sc_s[CH];
  __shared__ float p_s[CH];

  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)b * N + n;
  const int s = max(soi[2 * row], 0);
  const int e = min(soi[2 * row + 1], T);

  const float* pb = pre + (size_t)b * T * H;
  const float* fb = feats + (size_t)b * T * D;
  const float* qr = q + row * H;
  for (int h = threadIdx.x; h < H; h += THREADS) {
    q_s[h] = qr[h];
    w_s[h] = w[h];
  }
  for (int d = threadIdx.x; d < D; d += THREADS) acc_s[d] = 0.f;
  __syncthreads();

  const float bb = bias[0];
  float m = NEG, l = 0.f;  // running max and sum (equal in every thread)
  for (int c0 = s; c0 < e; c0 += CH) {
    const int cn = min(CH, e - c0);
    for (int i = warp; i < cn; i += WARPS) {
      const float* pt = pb + (size_t)(c0 + i) * H;
      float part = 0.f;
      for (int h = lane; h < H; h += 32) part = fmaf(w_s[h], tanhf(pt[h] + q_s[h]), part);
      part = warp_sum(part);
      if (lane == 0) sc_s[i] = part + bb;
    }
    __syncthreads();
    float cm = NEG;
    for (int i = 0; i < cn; ++i) cm = fmaxf(cm, sc_s[i]);
    const float m_new = fmaxf(m, cm);
    const float alpha = expf(m - m_new);
    if (threadIdx.x < cn) p_s[threadIdx.x] = expf(sc_s[threadIdx.x] - m_new);
    __syncthreads();
    float csum = 0.f;
    for (int i = 0; i < cn; ++i) csum += p_s[i];
    l = l * alpha + csum;
    m = m_new;
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float a = acc_s[d] * alpha;
      for (int i = 0; i < cn; ++i) a = fmaf(p_s[i], fb[(size_t)(c0 + i) * D + d], a);
      acc_s[d] = a;
    }
    __syncthreads();  // sc_s and p_s are rewritten by the next chunk
  }

  float* o = out + row * D;
  for (int d = threadIdx.x; d < D; d += THREADS) o[d] = l > 0.f ? acc_s[d] / l : 0.f;
}

}  // namespace

// pre [B, T, H], feats [B, T, D], q [B, N, H], w [H], b [1] f32; soi [B, N, 2]
// int32 windows [s, e) -> out [B, N, D] f32; all contiguous, on the device
// of `stream`.
extern "C" int echr_windowed_attention(const void* pre, const void* feats, const void* q,
                                       const void* w, const void* b, const void* soi,
                                       void* out, int B, int N, int T, int H, int D,
                                       void* stream) {
  const size_t smem = (size_t)(2 * H + D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(windowed_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  dim3 grid(N, B);
  windowed_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(feats),
      static_cast<const float*>(q), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const int*>(soi), static_cast<float*>(out),
      N, T, H, D);
  return static_cast<int>(cudaGetLastError());
}
