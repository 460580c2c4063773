// Kernel 5: the fused additive-attention step, for sm_90a.
//
//   s[n, t]   = w . tanh(pre[t, :] + q[n, :]) + bias
//   att[n, :] = sum_t softmax_{t: mask[n, t] == 1}(s[n, t]) feats[t, :]
//
// for every proposal row n of every video b, in one launch; the [N, T]
// scores and weights never reach global memory.  Replaces the Pallas TPU
// kernel echr_tpu/ops/pallas_attention.py::_fused_kernel (pallas_call at
// :260, wrapper attention_fused :284).  AV numerics follow it: the running
// weights p = exp(s - m_running) and the feats are rounded to bf16, the
// products summed in f32, and the result is acc / l with l the f32 sum of
// the unrounded p.  A row with no mask == 1 entry gives zeros.
//
// What bounds it on an H100: bytes.  At the beam path's shapes (B=32,
// N=512 rows, T=256, H=512, D=500) the inputs and the output are ~116 MB
// (~35 us at 3.35 TB/s) against ~1 GFLOP of live work; the accurate tanhf
// of the live tiles is the next limit.  The design: one block per (video,
// 16-row tile, 512-column chunk of D) walks the T axis in 32-frame tiles,
// the loop taking the place of the TPU's sequential grid axis.  A tile
// whose window-mask tile holds no 1 is skipped (exact: it leaves the
// running max m and sum l unchanged and adds nothing).  A live tile's
// scores are kernel 1's body (q and pre rows staged in shared memory, 64
// hidden units at a time); each warp owns two rows and keeps their m and l
// in registers (warp-shuffle max and sum); the bf16 p tile goes through
// shared memory to the AV loop, where each thread owns two columns of the
// [16, 512] f32 accumulator in registers and reads its column of the
// feats tile once, coalesced.  D is masked at its ragged edge (D = 500 at
// flagship); D > 512 takes more column chunks, each recomputing the
// scores.  The AV is a SIMT loop: tensor-core mma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 16;        // rows per block
constexpr int TT = 32;        // frames per tile (one per lane)
constexpr int HC = 64;        // hidden units staged per pass
constexpr int THREADS = 256;  // 8 warps: warp ty owns rows ty, ty + 8
constexpr int DCHUNK = 512;   // columns of D per block
constexpr int DJ = DCHUNK / THREADS;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
fused_kernel(const float* __restrict__ pre, const float* __restrict__ q,
             const float* __restrict__ w, const float* __restrict__ bias,
             const float* __restrict__ mask, const float* __restrict__ feats,
             float* __restrict__ out, int N, int T, int H, int D) {
  __shared__ float pre_s[TT][HC + 1];  // +1: lanes read distinct banks
  __shared__ float q_s[TN][HC];
  __shared__ float w_s[HC];
  __shared__ float p_s[TN][TT];        // this tile's bf16-rounded weights
  __shared__ float row_s[TN];          // alpha per row, then l per row

  const int b = blockIdx.z;
  const int d0 = blockIdx.y * DCHUNK;
  const int n0 = blockIdx.x * TN;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int na = n0 + ty;
  const int nb = n0 + ty + 8;

  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  const float* mb = mask + (size_t)b * N * T;
  const float* fb = feats + (size_t)b * T * D;
  const float bb = bias[0];

  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // rows na, nb (equal in all lanes)
  float acc[TN][DJ];
#pragma unroll
  for (int r = 0; r < TN; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int t = t0 + tx;
    const bool ia = t < T && na < N && mb[(size_t)na * T + t] != 0.f;
    const bool ib = t < T && nb < N && mb[(size_t)nb * T + t] != 0.f;
    if (!__syncthreads_or(ia || ib)) continue;  // an empty tile changes nothing

    float sa = 0.f, sb = 0.f;
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
        sa = fmaf(wc, tanhf(q_s[ty][c] + p), sa);
        sb = fmaf(wc, tanhf(q_s[ty + 8][c] + p), sb);
      }
      __syncthreads();
    }
    sa = ia ? sa + bb : NEG;
    sb = ib ? sb + bb : NEG;

    // online softmax over the tile, rows na (sa) and nb (sb) of warp ty
    const float mna = fmaxf(m_a, warp_max(sa));
    const float mnb = fmaxf(m_b, warp_max(sb));
    const float pa = ia ? expf(sa - mna) : 0.f;
    const float pbv = ib ? expf(sb - mnb) : 0.f;
    const float alpha_a = expf(m_a - mna);
    const float alpha_b = expf(m_b - mnb);
    l_a = l_a * alpha_a + warp_sum(pa);
    l_b = l_b * alpha_b + warp_sum(pbv);
    m_a = mna;
    m_b = mnb;
    p_s[ty][tx] = bf16_round(pa);
    p_s[ty + 8][tx] = bf16_round(pbv);
    if (tx == 0) {
      row_s[ty] = alpha_a;
      row_s[ty + 8] = alpha_b;
    }
    __syncthreads();

    const int tn = min(TT, T - t0);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = d0 + threadIdx.x + THREADS * j;
#pragma unroll
      for (int r = 0; r < TN; ++r) acc[r][j] *= row_s[r];
      if (d < D) {
        for (int tt = 0; tt < tn; ++tt) {
          const float f = bf16_round(fb[(size_t)(t0 + tt) * D + d]);
#pragma unroll
          for (int r = 0; r < TN; ++r) acc[r][j] = fmaf(p_s[r][tt], f, acc[r][j]);
        }
      }
    }
    __syncthreads();  // p_s and row_s are rewritten by the next live tile
  }

  if (tx == 0) {
    row_s[ty] = l_a;
    row_s[ty + 8] = l_b;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int d = d0 + threadIdx.x + THREADS * j;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      const int n = n0 + r;
      if (n < N) {
        const float l = row_s[r];
        out[((size_t)b * N + n) * D + d] = l > 0.f ? acc[r][j] / l : 0.f;
      }
    }
  }
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T], feats [B, T, D]
// -> out [B, N, D]; all f32, contiguous, on the device of `stream`.
extern "C" int echr_attention_fused(const void* pre, const void* q, const void* w,
                                    const void* b, const void* mask, const void* feats,
                                    void* out, int B, int N, int T, int H, int D,
                                    void* stream) {
  dim3 grid((N + TN - 1) / TN, (D + DCHUNK - 1) / DCHUNK, B);
  fused_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(q),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(feats),
      static_cast<float*>(out), N, T, H, D);
  return static_cast<int>(cudaGetLastError());
}
