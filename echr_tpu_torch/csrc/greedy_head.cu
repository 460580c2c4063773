// Kernel 2: streaming greedy head, for sm_90a.
//
// For each row r of out [R, C]: the argmax, max and logsumexp over v < V1 of
//   logit[r, v] = sum_c out[r, c] * w[v, c] + b[v]
// without the [R, V1] logits reaching global memory.  Replaces the Pallas TPU
// kernel echr_tpu/ops/pallas_head.py::_head_kernel (pallas_call at :146).
//
// Bound on an H100 by tensor-core throughput: 75.5 GFLOP per decode step at
// R=4096, C=1536, V1=6001, with w (18.4 MB in bf16) resident in the 50 MB L2.
// A block of 8 warps owns BR=128 rows and walks its split's BV=128-wide vocab
// tiles in order.  For bf16 weights each logit tile is computed with
// nvcuda::wmma bf16 16x16x16 and f32 accumulation (each warp 32 x 64) from
// BK=64-deep shared-memory stages that cp.async double-buffers, so the next
// stage's loads overlap this stage's matrix work; for f32 weights (the parity
// runs) with f32 FMAs from single-buffered stages.  The tile then lives in
// shared memory only (over the operand stages) and is folded into a running
// (max, argmax, sumexp) per row with accurate expf.  R/128 row tiles alone
// give 32 blocks at serving dims against 132 SMs, so the vocab is split over
// gridDim.y as well and head_combine_kernel merges the splits in vocab order.
// The ragged vocab edge is masked here, so no padded column wins or adds to
// the sum.
//
// Ties: the lowest index wins (torch.argmax / jnp.argmax).  Within a tile the
// (value, index) reduction keeps the lower index; a later tile, or a later
// split in the combine, takes over only on a strictly greater value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BR = 128;       // rows per block
constexpr int BV = 128;       // vocab columns per tile
constexpr int THREADS = 256;  // 8 warps: 4 (rows) x 2 (columns) for wmma
constexpr int BKH = 64;       // depth of one bf16 stage
constexpr int BKF = 32;       // depth of one f32 stage
constexpr int LDH = BKH + 8;  // bf16 stage row stride: 144 bytes, a wmma ldm
constexpr int LDF = BKF + 1;  // f32 stage row stride: lanes on distinct banks
constexpr int LDL = BV + 4;   // logit tile row stride (wmma float ldm)

struct Bf16Stage {
  bf16 a[BR][LDH];
  bf16 w[BV][LDH];
};
struct F32Stage {
  float a[BR][LDF];
  float w[BV][LDF];
};
constexpr size_t kLogitBytes = sizeof(float) * BR * LDL;

// dynamic shared memory: the operand stages, and the logit tile over them
template <bool BF16>
constexpr size_t smem_bytes() {
  return BF16 ? std::max(2 * sizeof(Bf16Stage), kLogitBytes)
              : std::max(sizeof(F32Stage), kLogitBytes);
}

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

// rows [row0, row0 + 128) x depth [k0, k0 + BK) of the row-major [rows, C]
// matrices a and w into a stage, zero outside them.  vec (C a multiple of the
// 16-byte vector, 16-byte aligned bases): bf16 issues cp.async, f32 loads
// uint4s; otherwise element by element.
template <typename T, int BK, int LD>
__device__ __forceinline__ void load_stage(T (*sa)[LD], T (*sw)[LD], const T* __restrict__ a,
                                           const T* __restrict__ w, int row0, int R, int v0,
                                           int V1, int k0, int C, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = BK / PER;
    for (int i = threadIdx.x; i < BR * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * PER, k = k0 + c;
      const bool oa = row0 + r < R && k < C;
      const bool ow = v0 + r < V1 && k < C;
      const T* pa = oa ? a + (size_t)(row0 + r) * C + k : a;
      const T* pw = ow ? w + (size_t)(v0 + r) * C + k : w;
      if constexpr (std::is_same_v<T, bf16>) {
        cp_async16(&sa[r][c], pa, oa);
        cp_async16(&sw[r][c], pw, ow);
      } else {
        const uint4 za = make_uint4(0u, 0u, 0u, 0u);
        const uint4 va = oa ? *reinterpret_cast<const uint4*>(pa) : za;
        const uint4 vw = ow ? *reinterpret_cast<const uint4*>(pw) : za;
        const T* ea = reinterpret_cast<const T*>(&va);
        const T* ew = reinterpret_cast<const T*>(&vw);
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          sa[r][c + j] = ea[j];
          sw[r][c + j] = ew[j];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < BR * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, k = k0 + c;
      sa[r][c] = (row0 + r < R && k < C) ? a[(size_t)(row0 + r) * C + k] : T(0.f);
      sw[r][c] = (v0 + r < V1 && k < C) ? w[(size_t)(v0 + r) * C + k] : T(0.f);
    }
  }
}

// logits[r][v] = sum_k a[row0 + r][k] * w[v0 + v][k] for the 128 x 128 tile,
// written over the stages; ends synchronised
template <bool BF16>
__device__ __forceinline__ void logit_tile(unsigned char* smem, float (*logits)[LDL],
                                           const void* A, const void* W, int row0, int R,
                                           int v0, int V1, int C, bool vec) {
  if constexpr (BF16) {
    const auto* a = static_cast<const bf16*>(A);
    const auto* w = static_cast<const bf16*>(W);
    auto* stage = reinterpret_cast<Bf16Stage*>(smem);
    const int warp = threadIdx.x >> 5;
    const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int nk = (C + BKH - 1) / BKH;
    load_stage<bf16, BKH, LDH>(stage[0].a, stage[0].w, a, w, row0, R, v0, V1, 0, C, vec);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk)
        load_stage<bf16, BKH, LDH>(stage[(kt + 1) & 1].a, stage[(kt + 1) & 1].w, a, w, row0, R,
                                   v0, V1, (kt + 1) * BKH, C, vec);
      cp_async_commit();
      cp_async_wait<1>();  // stage kt has landed; stage kt + 1 may be in flight
      __syncthreads();
      const Bf16Stage& st = stage[kt & 1];
#pragma unroll
      for (int kk = 0; kk < BKH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &st.a[wr + 16 * i][kk], LDH);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &st.w[wc + 16 * j][kk], LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();  // everyone is done with stage kt before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(&logits[wr + 16 * i][wc + 16 * j], acc[i][j], LDL,
                                wmma::mem_row_major);
  } else {
    const auto* a = static_cast<const float*>(A);
    const auto* w = static_cast<const float*>(W);
    auto& st = *reinterpret_cast<F32Stage*>(smem);
    const int tr = threadIdx.x >> 4;  // rows tr + 16i
    const int tc = threadIdx.x & 15;  // columns tc + 16j
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += BKF) {
      load_stage<float, BKF, LDF>(st.a, st.w, a, w, row0, R, v0, V1, k0, C, vec);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BKF; ++k) {
        float av[8], wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = st.a[tr + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = st.w[tc + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) logits[tr + 16 * i][tc + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
head_partial_kernel(const void* __restrict__ A, const void* __restrict__ W,
                    const float* __restrict__ bias, int R, int C, int V1, int tiles_per_split,
                    bool vec, float* __restrict__ part_m, float* __restrict__ part_l,
                    int* __restrict__ part_a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float(*logits)[LDL] = reinterpret_cast<float(*)[LDL]>(smem);

  const int row0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int n_tiles = (V1 + BV - 1) / BV;
  const int tile_end = min(n_tiles, (split + 1) * tiles_per_split);
  // two threads per row, each folding one half of the tile's columns
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (BV / 2);

  float m_run = -INFINITY, l_run = 0.f;
  int a_run = 0;
  for (int tile = split * tiles_per_split; tile < tile_end; ++tile) {
    const int v0 = tile * BV;
    logit_tile<BF16>(smem, logits, A, W, row0, R, v0, V1, C, vec);

    float best = -INFINITY;
    int best_i = INT32_MAX;
    for (int c = c0; c < c0 + BV / 2; ++c) {
      const int v = v0 + c;
      if (v < V1) {
        const float x = logits[r][c] + bias[v];
        logits[r][c] = x;
        if (x > best) {  // ascending scan: strict > keeps the lower index
          best = x;
          best_i = v;
        }
      }
    }
    const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, 1);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
    const float m_new = fmaxf(m_run, best);
    float s = 0.f;
    for (int c = c0; c < c0 + BV / 2; ++c)
      if (v0 + c < V1) s += expf(logits[r][c] - m_new);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    l_run = l_run * expf(m_run - m_new) + s;
    if (best > m_run) a_run = best_i;  // strict: an earlier tile keeps a tie
    m_run = m_new;
    __syncthreads();  // the next tile's loads overwrite the logit tile
  }
  const int row = row0 + r;
  if ((threadIdx.x & 1) == 0 && row < R) {
    const size_t o = (size_t)split * R + row;
    part_m[o] = m_run;
    part_l[o] = l_run;
    part_a[o] = a_run;
  }
}

// fold the vocab splits of each row in vocab order
__global__ void head_combine_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const int* __restrict__ part_a, int splits, int R,
                                    int* __restrict__ tok, float* __restrict__ mx,
                                    float* __restrict__ lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float m = part_m[row], l = part_l[row];
  int a = part_a[row];
  for (int s = 1; s < splits; ++s) {
    const size_t o = (size_t)s * R + row;
    const float ms = part_m[o];
    const float m_new = fmaxf(m, ms);
    l = l * expf(m - m_new) + part_l[o] * expf(ms - m_new);
    if (ms > m) a = part_a[o];  // strict: the earlier split keeps a tie
    m = m_new;
  }
  tok[row] = a;
  mx[row] = m;
  lse[row] = m + logf(l);
}

template <bool BF16>
cudaError_t launch_partial(dim3 grid, cudaStream_t s, const void* out, const void* w,
                           const float* bias, int R, int C, int V1, int per, bool vec,
                           float* pm, float* pl, int* pa) {
  constexpr size_t smem = smem_bytes<BF16>();
  cudaError_t err = cudaFuncSetAttribute(head_partial_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  head_partial_kernel<BF16><<<grid, THREADS, smem, s>>>(out, w, bias, R, C, V1, per, vec, pm,
                                                        pl, pa);
  return cudaGetLastError();
}

}  // namespace

// out [R, C] and w [V1, C] (bf16 if `bf16`, else f32), b [V1] f32 ->
// tok [R] int32, mx [R] f32, lse [R] f32.  part_* are [splits, R] scratch.
extern "C" int echr_greedy_head(const void* out, const void* w, const void* b, int bf16,
                                int R, int C, int V1, int splits, void* part_m, void* part_l,
                                void* part_a, void* tok, void* mx, void* lse, void* stream) {
  const int n_tiles = (V1 + BV - 1) / BV;
  splits = std::max(1, std::min(splits, n_tiles));
  const int per = (n_tiles + splits - 1) / splits;
  const int used = (n_tiles + per - 1) / per;  // every used split has >= 1 tile
  const dim3 grid((R + BR - 1) / BR, used);
  const int elem = bf16 ? 2 : 4;
  const bool vec = (C * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bias = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<int*>(part_a);
  const cudaError_t err =
      bf16 ? launch_partial<true>(grid, s, out, w, bias, R, C, V1, per, vec, pm, pl, pa)
           : launch_partial<false>(grid, s, out, w, bias, R, C, V1, per, vec, pm, pl, pa);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(pm, pl, pa, used, R, static_cast<int*>(tok),
                                                     static_cast<float*>(mx),
                                                     static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
