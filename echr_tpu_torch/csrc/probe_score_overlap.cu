// Kernels 9 and 10: the overlap probe's additive scores, alone and with an
// independent tensor-core product, for sm_90a.
//
//   s[b, n, t]      = sum_h tanh(q[b, n, h] + pre[b, t, h]) * w[h]         (f32)
//   dot[b, j, n, k] = sum_h bf16(q[b, n, h]) * wd[h, k], j < ceil(T / 128)  (f32 sums)
//
// Kernel 9 (scores only) replaces the Pallas TPU kernel
// experiments/probe_mxu_vpu_overlap.py::_score_kernel (pallas_call at :88);
// kernel 10 (scores and product) replaces ::_score_plus_dot_kernel (pallas_call
// at :95).  As in the probe, every 128-frame block of a video computes the
// product of its proposals' q rows with wd again and writes it to its own copy
// j: dot has ceil(T/128) copies of the product.  Both are one template on DOT,
// so the score tile, its tanh loop and its warps are the same in both and
// kernel 10 - kernel 9 is the product alone.
//
// Bound on an H100: kernel 9 by the accurate tanhf (B*N*T*H = 537M a step at
// B=32, N=128, T=256, H=512; 2.15 GFLOP f32 at 4 per element against 29 MB),
// kernel 10 by the same plus 17.2 GFLOP of bf16 products at KD=2048 and 67 MB
// more output.  A block owns (video b, TN=32 proposals, TT=128 frames):
// eight score warps stage pre and q in HC=32-wide slices and each thread
// reduces over H for 16 outputs (16 proposals at one frame), with accurate
// tanhf (no fast math).
//
// The overlap design is warp-specialised.  Kernel 10 adds four dot warps to
// the block; they never wait on the score warps (each group syncs on its own
// named barrier, never __syncthreads), so while the score warps keep the FMA
// and SFU pipes busy the scheduler can issue the dot warps' mma to the tensor
// pipe.  Interleaving the two in the same warps would tie each mma to a point
// in the tanh loop and let one stall the other; separate warps let each run
// at its own pace and let the tanh work hide the product's L2 latency.  The
// dot warps put the block's 32 q rows in shared memory in bf16 once; then
// each streams its own 32-column slices of wd through a private DS-stage
// cp.async ring (no block barrier) into nvcuda::wmma bf16 16x16x16 products
// with f32 accumulators, which it stores straight to dot.  Ragged N and T are masked; the product needs H a
// multiple of 16 and KD a multiple of 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TN = 32;             // proposals per block
constexpr int TT = 128;            // frames per block: the probe's TILE_T, one dot copy
constexpr int HC = 32;             // hidden units of pre and q staged per pass
constexpr int SCORE_THREADS = 256; // 8 warps: thread (g, t) owns proposals 16g.. at frame t
constexpr int ROWS = TN * TT / SCORE_THREADS;  // 16 outputs a thread
constexpr int DOT_WARPS = 4;
constexpr int DOT_THREADS = 32 * DOT_WARPS;
constexpr int DN = 32;             // columns of one dot warp's pass: 2 fragments
constexpr int DS = 8;              // stages of a dot warp's cp.async ring
constexpr int LDB = DN + 8;        // ring row stride: 80 bytes, a wmma ldm
constexpr int SCORE_BAR = 1, DOT_BAR = 2;  // named barriers (0 is __syncthreads)

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the dynamic shared memory of kernel 10: q rows in bf16, then per dot warp
// its ring and a 16 x 16 f32 scratch for a ragged edge
__host__ __device__ constexpr int ldq(int H) { return H + 8; }
constexpr size_t kRingBytes = sizeof(bf16) * DS * 16 * LDB;
constexpr size_t kScratchBytes = sizeof(float) * 16 * 16;
size_t dot_smem(int H) {
  return sizeof(bf16) * TN * ldq(H) + DOT_WARPS * (kRingBytes + kScratchBytes);
}

__device__ __forceinline__ void score_warps(const float* __restrict__ pre,
                                            const float* __restrict__ q,
                                            const float* __restrict__ w, float* __restrict__ s,
                                            int b, int n0, int t0, int N, int T, int H) {
  __shared__ float pre_s[TT][HC + 1];  // +1: the frame's lanes read distinct banks
  __shared__ float q_s[TN][HC];        // a warp reads one row: a broadcast
  __shared__ float w_s[HC];
  const int t = threadIdx.x % TT;
  const int g = threadIdx.x / TT;
  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
  for (int h0 = 0; h0 < H; h0 += HC) {
    for (int i = threadIdx.x; i < TT * HC; i += SCORE_THREADS) {
      const int r = i / HC, c = i % HC;
      pre_s[r][c] = (t0 + r < T && h0 + c < H) ? pb[(size_t)(t0 + r) * H + h0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < TN * HC; i += SCORE_THREADS) {
      const int r = i / HC, c = i % HC;
      q_s[r][c] = (n0 + r < N && h0 + c < H) ? qb[(size_t)(n0 + r) * H + h0 + c] : 0.f;
    }
    if (threadIdx.x < HC) w_s[threadIdx.x] = h0 + threadIdx.x < H ? w[h0 + threadIdx.x] : 0.f;
    named_barrier(SCORE_BAR, SCORE_THREADS);
    const int hn = min(HC, H - h0);
    for (int c = 0; c < hn; ++c) {
      const float p = pre_s[t][c];
      const float wc = w_s[c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(wc, tanhf(q_s[g * ROWS + i][c] + p), acc[i]);
    }
    named_barrier(SCORE_BAR, SCORE_THREADS);  // the next pass overwrites the slices
  }
  if (t0 + t < T) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = n0 + g * ROWS + i;
      if (n < N) s[((size_t)b * N + n) * T + t0 + t] = acc[i];
    }
  }
}

__device__ __forceinline__ void dot_warps(const float* __restrict__ q, const bf16* __restrict__ wd,
                                          float* __restrict__ dot, unsigned char* smem, int b,
                                          int n0, int N, int H, int KD) {
  const int lt = threadIdx.x - SCORE_THREADS;
  const int dw = lt >> 5, lane = lt & 31;
  const int LDQ = ldq(H);
  bf16* qa = reinterpret_cast<bf16*>(smem);
  unsigned char* own = smem + sizeof(bf16) * TN * LDQ + dw * (kRingBytes + kScratchBytes);
  bf16* ring = reinterpret_cast<bf16*>(own);
  float* scratch = reinterpret_cast<float*>(own + kRingBytes);

  const float* qb = q + (size_t)b * N * H;
  for (int i = lt; i < TN * H; i += DOT_THREADS) {
    const int r = i / H, c = i % H;
    qa[r * LDQ + c] = __float2bfloat16(n0 + r < N ? qb[(size_t)(n0 + r) * H + c] : 0.f);
  }
  named_barrier(DOT_BAR, DOT_THREADS);

  // the warp's stream of stages: pass p (columns (p * DOT_WARPS + dw) * DN),
  // depth slice k (rows 16k .. 16k + 15 of wd)
  const int KS = H / 16;
  const int total = (KD / (DN * DOT_WARPS)) * KS;
  auto issue = [&](int idx) {
    if (idx < total) {
      const int p = idx / KS, k = idx % KS;
      const int col = (p * DOT_WARPS + dw) * DN;
      bf16* slot = ring + (idx % DS) * 16 * LDB;
#pragma unroll
      for (int v = lane; v < 16 * DN / 8; v += 32) {  // 16 rows x 4 vectors of 16 bytes
        const int row = v / (DN / 8), c = (v % (DN / 8)) * 8;
        cp_async16(slot + row * LDB + c, wd + (size_t)(16 * k + row) * KD + col + c);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  for (int idx = 0; idx < DS - 1; ++idx) issue(idx);

  const size_t copy = (size_t)b * gridDim.x + blockIdx.x;  // this block's copy j
  float* out = dot + (copy * N + n0) * KD;
  const int live = min(TN, N - n0);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int idx = 0; idx < total; ++idx) {
    cp_async_wait<DS - 2>();  // stage idx has landed
    __syncwarp();             // and every lane is done with stage idx - 1's slot
    issue(idx + DS - 1);      // into that slot
    const int p = idx / KS, k = idx % KS;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[i][n], 0.f);
    }
    const bf16* slot = ring + (idx % DS) * 16 * LDB;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], qa + 16 * i * LDQ + 16 * k, LDQ);
#pragma unroll
    for (int n = 0; n < 2; ++n) wmma::load_matrix_sync(fb[n], slot + 16 * n, LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) wmma::mma_sync(acc[i][n], fa[i], fb[n], acc[i][n]);
    if (k == KS - 1) {
      const int col = (p * DOT_WARPS + dw) * DN;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* o = out + (size_t)(16 * i) * KD + col + 16 * n;
          if (16 * i + 16 <= live) {
            wmma::store_matrix_sync(o, acc[i][n], KD, wmma::mem_row_major);
          } else if (16 * i < live) {  // ragged N: only the live rows
            wmma::store_matrix_sync(scratch, acc[i][n], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 16 * 16; e += 32)
              if (16 * i + e / 16 < live) o[(size_t)(e / 16) * KD + e % 16] = scratch[e];
            __syncwarp();
          }
        }
    }
  }
  cp_async_wait<0>();
}

template <bool DOT>
__global__ void __launch_bounds__(SCORE_THREADS + DOT_THREADS, 2)
probe_scores_kernel(const float* __restrict__ pre, const float* __restrict__ q,
                    const float* __restrict__ w, const bf16* __restrict__ wd,
                    float* __restrict__ s, float* __restrict__ dot, int N, int T, int H, int KD,
                    bool scores) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, n0 = blockIdx.y * TN, t0 = blockIdx.x * TT;
  if (!DOT || threadIdx.x < SCORE_THREADS) {
    if (scores) score_warps(pre, q, w, s, b, n0, t0, N, T, H);
  } else if constexpr (DOT) {
    dot_warps(q, wd, dot, smem, b, n0, N, H, KD);
  }
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H] f32 -> s [B, N, T] f32 (kernel 9, wd and
// dot null); with wd [H, KD] bf16 also dot [B, ceil(T/128), N, KD] f32
// (kernel 10; H a multiple of 16, KD of 128).  scores = 0 runs kernel 10's
// dot warps alone, s untouched: the product's own time in the same kernel.
extern "C" int echr_probe_scores(const void* pre, const void* q, const void* w, const void* wd,
                                 void* s, void* dot, int B, int N, int T, int H, int KD,
                                 int scores, void* stream) {
  const dim3 grid((T + TT - 1) / TT, (N + TN - 1) / TN, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pre);
  const auto* qq = static_cast<const float*>(q);
  const auto* ww = static_cast<const float*>(w);
  auto* ss = static_cast<float*>(s);
  if (wd == nullptr) {
    probe_scores_kernel<false><<<grid, SCORE_THREADS, 0, st>>>(p, qq, ww, nullptr, ss, nullptr,
                                                              N, T, H, 0, true);
    return static_cast<int>(cudaGetLastError());
  }
  if (H % 16 != 0 || KD % (DN * DOT_WARPS) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dot_smem(H);
  cudaError_t err = cudaFuncSetAttribute(probe_scores_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_scores_kernel<true><<<grid, SCORE_THREADS + DOT_THREADS, smem, st>>>(
      p, qq, ww, static_cast<const bf16*>(wd), ss, static_cast<float*>(dot), N, T, H, KD,
      scores != 0);
  return static_cast<int>(cudaGetLastError());
}
