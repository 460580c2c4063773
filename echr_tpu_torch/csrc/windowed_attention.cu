// Kernel 6: windowed additive attention, for sm_90a.
//
//   s[n, t]   = w . tanh(pre[t, :] + q[n, :]) + bias          for s_n <= t < e_n
//   att[n, :] = sum_{s_n <= t < e_n} softmax_t(s[n, t]) feats[t, :]
//
// for every proposal n of every video b, all in f32 (no TF32): only the
// frames of each proposal's window [s_n, e_n) are scored, so the tanh count
// falls from N*T*H to sum_n (e_n - s_n) * H.  A zero-length window gives
// zeros.  Replaces the Pallas TPU kernel
// echr_tpu/ops/pallas_windowed_attention.py::_kernel (pallas_call at :96,
// wrapper windowed_attention :137).  The TPU kernel's 8-aligned DMA
// starts, its W + 8 margin and its end clamp with a shift are sublane
// rules and are gone: a block reads pre[s:e] and feats[s:e] directly.  The
// window is streamed in 8-frame chunks with an online softmax, so every
// window length is exact, also past the W that echr_tpu's contract
// (e - s <= W) bounds.
//
// What bounds it on an H100: the tanh, as kernel 1.  At the beam path's
// shapes (B=32, N=512 rows, T=256, H=512, D=500, windows of half the video)
// the windows need ~1.06 G tanh, ~0.65 ms at tanh.cuh's measured rate;
// the bytes, counting each input once (~100 MB, ~30 us at 3.35 TB/s), and
// the f32 AV (~1 GFLOP) come far below.  The design:
//
//   * tanh.cuh's 7-instruction tanh in place of CUDA's tanhf.
//   * One block of 8 warps serves G adjacent rows (the k beam copies of a
//     proposal are adjacent and share a window): it stages the union of
//     their windows, chunk by chunk, and warp f scores frame c0 + f of a
//     chunk for every row whose own [s, e) holds it, its lanes over hidden
//     units (float4s of pre, q and w in shared memory, conflict-free) and
//     a butterfly for the sum.  One staged pre row feeds all G rows' tanh;
//     rows with equal windows stage nothing twice.  G is 4, 2 or 1: the
//     most that still gives B * ceil(N / G) >= 2 blocks an SM
//     (ops/kernel_attention_step.windowed_rows), so a per-video step
//     (B = 1, N = 128) takes one row a block and 128 blocks.
//   * pre[c0:c0+8] and feats[c0:c0+8] are staged by cp.async, double
//     buffered: chunk k + 1 lands while chunk k is scored (zeros past the
//     union's end and past D).
//   * A chunk's max and sum are warp-shuffle reductions, warp r for row r.
//   * The accumulator lives in registers: each thread owns columns
//     d0 + tid + 256 j of each of its block's rows, j < DJ (D = 500: 2); a D
//     past 2048 takes more column chunks, each rescoring its windows.
//
// 3 blocks share an SM at H = 512, D = 500 (~74 KB of shared memory each).
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tanh.cuh"

namespace {

using namespace cpa;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CH = WARPS;          // frames a chunk: one a warp
constexpr int MAX_G = 4;           // rows a block
constexpr int MAX_DJ = 8;          // columns a thread: a block covers 256 DJ <= 2048 columns
constexpr int MAX_SMEM = 232448;   // 227 KB
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float dot_tanh(float s, const float4 wv, const float4 qv,
                                          const float4 p) {
  s = fmaf(wv.x, echr_tanh(qv.x + p.x), s);
  s = fmaf(wv.y, echr_tanh(qv.y + p.y), s);
  s = fmaf(wv.z, echr_tanh(qv.z + p.z), s);
  return fmaf(wv.w, echr_tanh(qv.w + p.w), s);
}

// H padded to the 128 units a warp reads in one float4 pass
int padded_h(int H) { return (H + 127) / 128 * 128; }

size_t smem_bytes(int G, int DJ, int H) {
  return sizeof(float) * ((size_t)(G + 1 + 2 * CH) * padded_h(H) + 2 * CH * THREADS * DJ);
}

// dynamic shared memory: q_s [G][HP], w_s [HP], pre_s [2][CH][HP], f_s [2][CH][DCP]
template <int G, int DJ>
__global__ void __launch_bounds__(THREADS)
windowed_kernel(const float* __restrict__ pre, const float* __restrict__ feats,
                const float* __restrict__ q, const float* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ soi,
                float* __restrict__ out, int N, int T, int H, int D, int HP, bool vec_h,
                bool vec_d) {
  constexpr int DCP = THREADS * DJ;  // columns a block
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* w_s = q_s + G * HP;
  float* pre_s = w_s + HP;
  float* f_s = pre_s + 2 * CH * HP;
  __shared__ float sc_s[G][CH];  // a chunk's scores (NEG outside a row's window)
  __shared__ float p_s[G][CH];   // and weights
  __shared__ float alpha_s[G];
  __shared__ float l_s[G];

  const int n0 = blockIdx.x * G;
  const int d0 = blockIdx.y * DCP;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dv = min(DCP, D - d0);

  // the rows' windows clamped to [0, T) (empty: [0, 0)) and their union [S, E)
  int ws[G], we[G];
  int S = T, E = 0;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int n = n0 + r;
    int s = 0, e = 0;
    if (n < N) {
      s = max(soi[2 * ((size_t)b * N + n)], 0);
      e = min(soi[2 * ((size_t)b * N + n) + 1], T);
    }
    if (e <= s) s = e = 0;
    ws[r] = s;
    we[r] = e;
    if (e > s) {
      S = min(S, s);
      E = max(E, e);
    }
  }

  const float* pb = pre + (size_t)b * T * H;
  const float* fb = feats + (size_t)b * T * D + d0;
  auto stage = [&](int c0, int buf) {
    const int rows = min(CH, E - c0);
    stage_tile(pre_s + buf * CH * HP, HP, pb + (size_t)c0 * H, H, CH, HP, rows, H, vec_h,
               THREADS);
    stage_tile(f_s + buf * CH * DCP, DCP, fb + (size_t)c0 * D, D, CH, DCP, rows, dv, vec_d,
               THREADS);
  };
  // q rows (zeros past N) and w, then the first chunk, in one group
  stage_tile(q_s, HP, q + ((size_t)b * N + n0) * H, H, G, HP, min(G, N - n0), H, vec_h, THREADS);
  stage_tile(w_s, HP, w, H, 1, HP, 1, H, vec_h, THREADS);
  if (S < E) stage(S, 0);
  cp_async_commit();

  float acc[G][DJ];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  float m = NEG, l = 0.f;  // warp r < G: row r's running max and sum (equal in its lanes)
  const float bb = bias[0];

  for (int c0 = S, k = 0; c0 < E; c0 += CH, ++k) {
    const int buf = k & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk k has landed; every warp is past chunk k - 1
    if (c0 + CH < E) stage(c0 + CH, buf ^ 1);
    cp_async_commit();

    // warp f: frame c0 + f, for every row whose window holds it
    const int t = c0 + warp;
    bool in[G];
    bool any = false;
    float s[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      in[r] = t >= ws[r] && t < we[r];
      any |= in[r];
      s[r] = 0.f;
    }
    if (any) {
      const float4* pr = reinterpret_cast<const float4*>(pre_s + (buf * CH + warp) * HP) + lane;
      const float4* wr = reinterpret_cast<const float4*>(w_s) + lane;
      for (int j = 0; j < HP / 128; ++j) {
        const float4 p = pr[32 * j], wv = wr[32 * j];
#pragma unroll
        for (int r = 0; r < G; ++r)
          if (in[r])
            s[r] = dot_tanh(s[r], wv, reinterpret_cast<const float4*>(q_s + r * HP)[lane + 32 * j],
                            p);
      }
#pragma unroll
      for (int r = 0; r < G; ++r)
        if (in[r]) s[r] = warp_sum(s[r]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < G; ++r) sc_s[r][warp] = in[r] ? s[r] + bb : NEG;
    }
    __syncthreads();

    // the chunk's online softmax, warp r for row r, frame f on lane f
    if (warp < G) {
      const float v = lane < CH ? sc_s[warp][lane] : NEG;
      const bool live = v != NEG;
      const float m_new = fmaxf(m, warp_max(v));
      const float p = live ? expf(v - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
      if (lane < CH) p_s[warp][lane] = p;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    const int cn = min(CH, E - c0);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= a;
    }
    const float* fr = f_s + buf * CH * DCP + threadIdx.x;
    for (int f = 0; f < cn; ++f) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float x = fr[f * DCP + THREADS * j];
#pragma unroll
        for (int r = 0; r < G; ++r) acc[r][j] = fmaf(p_s[r][f], x, acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();

  if (warp < G && lane == 0) l_s[warp] = l;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (n0 + r >= N) break;
    const float lr = l_s[r];
    float* o = out + ((size_t)b * N + n0 + r) * D + d0;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = threadIdx.x + THREADS * j;
      if (d < dv) o[d] = lr > 0.f ? acc[r][j] / lr : 0.f;
    }
  }
}

template <int G, int DJ>
int launch_windowed(const float* pre, const float* feats, const float* q, const float* w,
                    const float* b, const int* soi, float* out, int B, int N, int T, int H, int D,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(G, DJ, H);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(windowed_kernel<G, DJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_h = H % 4 == 0 && aligned(pre) && aligned(q) && aligned(w);
  const bool vec_d = D % 4 == 0 && aligned(feats);
  const int DCP = THREADS * DJ;
  dim3 grid((N + G - 1) / G, (D + DCP - 1) / DCP, B);
  windowed_kernel<G, DJ><<<grid, THREADS, smem, stream>>>(pre, feats, q, w, b, soi, out, N, T, H,
                                                          D, padded_h(H), vec_h, vec_d);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_rows(const float* pre, const float* feats, const float* q, const float* w,
                const float* b, const int* soi, float* out, int B, int N, int T, int H, int D,
                cudaStream_t s) {
  const int cols = ((D < THREADS * MAX_DJ ? D : THREADS * MAX_DJ) + THREADS - 1) / THREADS;
  if (cols <= 1) return launch_windowed<G, 1>(pre, feats, q, w, b, soi, out, B, N, T, H, D, s);
  if (cols <= 2) return launch_windowed<G, 2>(pre, feats, q, w, b, soi, out, B, N, T, H, D, s);
  if (cols <= 4) return launch_windowed<G, 4>(pre, feats, q, w, b, soi, out, B, N, T, H, D, s);
  return launch_windowed<G, 8>(pre, feats, q, w, b, soi, out, B, N, T, H, D, s);
}

}  // namespace

// pre [B, T, H], feats [B, T, D], q [B, N, H], w [H], b [1] f32; soi [B, N, 2]
// int32 windows [s, e) -> out [B, N, D] f32; all contiguous, on the device
// of `stream`.  `rows` (1, 2 or 4) adjacent rows a block.
extern "C" int echr_windowed_attention_rows(const void* pre, const void* feats, const void* q,
                                            const void* w, const void* b, const void* soi,
                                            void* out, int B, int N, int T, int H, int D,
                                            int rows, void* stream) {
  const auto* p = static_cast<const float*>(pre);
  const auto* f = static_cast<const float*>(feats);
  const auto* qq = static_cast<const float*>(q);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* so = static_cast<const int*>(soi);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1) return launch_rows<1>(p, f, qq, ww, bb, so, o, B, N, T, H, D, s);
  if (rows == 2) return launch_rows<2>(p, f, qq, ww, bb, so, o, B, N, T, H, D, s);
  if (rows == MAX_G) return launch_rows<MAX_G>(p, f, qq, ww, bb, so, o, B, N, T, H, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
