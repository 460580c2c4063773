// Kernel 2: streaming greedy head, for sm_90a.
//
// For each row r of out [R, C]: the argmax, max and logsumexp over v < V1 of
//   logit[r, v] = sum_c out[r, c] * w[v, c] + b[v]
// without the [R, V1] logits reaching global memory.  Replaces the Pallas TPU
// kernel echr_tpu/ops/pallas_head.py::_head_kernel (pallas_call at :146).
//
// Bound on an H100 by tensor-core throughput: 75.5 GFLOP per decode step at
// R=4096, C=1536, V1=6001, with w (18.4 MB in bf16) resident in the 50 MB L2.
//
// bf16, the serving path: a warp-specialised block of three warpgroups owns
// BR=128 rows and walks its split's BV=256-wide vocab tiles in order.  One
// thread of the third warpgroup keeps TMA loads (128-byte swizzle) of the
// A [128 x 64] and W [256 x 64] tiles in flight in a ring of 4 stages with
// full / empty mbarriers; each of the two consumer warpgroups runs
// wgmma.mma_async m64n256k16 (bf16 operands from shared memory, f32
// accumulators in registers) for its 64 rows.  At the end of a vocab tile's
// K loop each consumer folds its accumulators in registers into a running
// (max, argmax, sumexp) per row, while the producer already loads the next
// tile's stages: the logit tile never goes through shared memory.  A 128 x
// 256 tile re-reads A once per vocab tile and W once per row tile from L2,
// 0.89 GB a call at serving dims against 1.18 GB at 128 x 128; a wider tile
// does not fit the accumulators of two warpgroups.  TMA needs 16-byte row
// strides, so C is a multiple of 8 (the wrapper pads it with zeros); rows
// past R and vocab rows past V1 arrive as zeros.
//
// f32, the parity runs: a block of 8 warps computes 128 x 128 logit tiles
// with f32 FMAs from single-buffered shared-memory stages, stores each tile
// in shared memory and folds it there with accurate expf.
//
// Both split the vocab over gridDim.y, by the wrapper's plan
// (ops/kernel_head.split_plan), and head_combine_kernel merges the splits in
// vocab order.  The ragged vocab edge is masked in the fold, so no padded
// column wins or adds to the sum; rows past R are not written.
//
// Ties: the lowest index wins (torch.argmax / jnp.argmax).  Within a tile a
// thread scans its columns in ascending order with a strict >, and the
// threads that share a row combine by (value, lower index); a later tile, or
// a later split in the combine, takes over only on a strictly greater value.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BR = 128;  // rows per block, both paths

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int BV = 256;        // vocab columns per tile: the wgmma n
constexpr int BK = SW;         // depth of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int A_BYTES = BR * BK * 2;
constexpr int W_BYTES = BV * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;  // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment

// The consumers' accumulator layout and its fold: hopper.cuh, fold_tile.
__global__ void __launch_bounds__(THREADS, 1)
head_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                  int R, int C, int V1, int tiles_per_split, float* __restrict__ part_m,
                  float* __restrict__ part_l, int* __restrict__ part_a) {
  extern __shared__ unsigned char smem_raw[];
  // stage s: A at base + s * STAGE_BYTES, W after it (1024-byte aligned, as
  // the 128-byte swizzle needs); then the full and the empty barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int row0 = blockIdx.x * BR;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile_end = min((V1 + BV - 1) / BV, tile0 + tiles_per_split);
  const int nk = (C + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival, then the bytes
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer; the paths never meet again
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile0; tile < tile_end; ++tile)
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t dst = base + stage * STAGE_BYTES;
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load(dst, &map_a, full, kt * BK, row0);
          tma_load(dst + A_BYTES, &map_w, full, kt * BK, tile * BV);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int quad = lane & 3;
    const int row_lo = row0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t a_off = wg * (64 * BK * 2);  // this warpgroup's 64 rows of the A tile
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    int a_run[2] = {0, 0};
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = tile0; tile < tile_end; ++tile) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = base + stage * STAGE_BYTES + a_off;
        const uint32_t w = base + stage * STAGE_BYTES + A_BYTES;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // 16 bf16 = 32 bytes deeper each
          wgmma<0>(acc, sw128_desc(a + 32 * k), sw128_desc(w + 32 * k), kt > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      fold_tile<BV>(acc, bias, tile * BV, V1, quad, m_run, l_run, a_run);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (quad == 0 && row < R) {
        const size_t o = (size_t)blockIdx.y * R + row;
        part_m[o] = m_run[h];
        part_l[o] = l_run[h];
        part_a[o] = a_run[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA tiles folded in shared memory
// ---------------------------------------------------------------------------
constexpr int FV = 128;        // vocab columns per tile
constexpr int FTHREADS = 256;  // 8 warps
constexpr int FK = 32;         // depth of one stage
constexpr int LDF = FK + 1;    // stage row stride: lanes on distinct banks
constexpr int LDL = FV + 4;    // logit tile row stride

struct F32Stage {
  float a[BR][LDF];
  float w[FV][LDF];
};
// dynamic shared memory: the operand stage, and the logit tile over it
constexpr size_t F32_SMEM = sizeof(F32Stage) > sizeof(float) * BR * LDL
                                ? sizeof(F32Stage)
                                : sizeof(float) * BR * LDL;

// rows [row0, row0 + 128) x depth [k0, k0 + FK) of the row-major [rows, C]
// matrices a and w into the stage, zero outside them.  vec (C a multiple of
// 4, 16-byte aligned bases): uint4 loads; otherwise element by element.
__device__ __forceinline__ void load_stage(F32Stage& st, const float* __restrict__ a,
                                           const float* __restrict__ w, int row0, int R, int v0,
                                           int V1, int k0, int C, bool vec) {
  if (vec) {
    constexpr int VPR = FK / 4;
    for (int i = threadIdx.x; i < BR * VPR; i += FTHREADS) {
      const int r = i / VPR, c = (i % VPR) * 4, k = k0 + c;
      const bool oa = row0 + r < R && k < C;
      const bool ow = v0 + r < V1 && k < C;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 va = oa ? *reinterpret_cast<const float4*>(a + (size_t)(row0 + r) * C + k) : z;
      const float4 vw = ow ? *reinterpret_cast<const float4*>(w + (size_t)(v0 + r) * C + k) : z;
      st.a[r][c] = va.x, st.a[r][c + 1] = va.y, st.a[r][c + 2] = va.z, st.a[r][c + 3] = va.w;
      st.w[r][c] = vw.x, st.w[r][c + 1] = vw.y, st.w[r][c + 2] = vw.z, st.w[r][c + 3] = vw.w;
    }
  } else {
    for (int i = threadIdx.x; i < BR * FK; i += FTHREADS) {
      const int r = i / FK, c = i % FK, k = k0 + c;
      st.a[r][c] = (row0 + r < R && k < C) ? a[(size_t)(row0 + r) * C + k] : 0.f;
      st.w[r][c] = (v0 + r < V1 && k < C) ? w[(size_t)(v0 + r) * C + k] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(FTHREADS)
head_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                const float* __restrict__ bias, int R, int C, int V1, int tiles_per_split,
                bool vec, float* __restrict__ part_m, float* __restrict__ part_l,
                int* __restrict__ part_a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& st = *reinterpret_cast<F32Stage*>(smem);
  float(*logits)[LDL] = reinterpret_cast<float(*)[LDL]>(smem);

  const int row0 = blockIdx.x * BR;
  const int split = blockIdx.y;
  const int tile_end = min((V1 + FV - 1) / FV, (split + 1) * tiles_per_split);
  // two threads per row, each folding one half of the tile's columns
  const int r = threadIdx.x >> 1;
  const int c0 = (threadIdx.x & 1) * (FV / 2);
  const int tr = threadIdx.x >> 4;  // products: rows tr + 16i
  const int tc = threadIdx.x & 15;  // columns tc + 16j

  float m_run = -INFINITY, l_run = 0.f;
  int a_run = 0;
  for (int tile = split * tiles_per_split; tile < tile_end; ++tile) {
    const int v0 = tile * FV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += FK) {
      load_stage(st, a, w, row0, R, v0, V1, k0, C, vec);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < FK; ++k) {
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
    __syncthreads();

    float best = -INFINITY;
    int best_i = INT32_MAX;
    for (int c = c0; c < c0 + FV / 2; ++c) {
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
    const float ob = __shfl_xor_sync(FULL, best, 1);
    const int oi = __shfl_xor_sync(FULL, best_i, 1);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
    const float m_new = fmaxf(m_run, best);
    float s = 0.f;
    for (int c = c0; c < c0 + FV / 2; ++c)
      if (v0 + c < V1) s += expf(logits[r][c] - m_new);
    s += __shfl_xor_sync(FULL, s, 1);
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

cudaError_t launch_bf16(dim3 grid, cudaStream_t s, const void* out, const void* w,
                        const float* bias, int R, int C, int V1, int per, float* pm, float* pl,
                        int* pa) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // TMA: 16-byte aligned bases and row strides
  if (C % 8 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  if (!encode_rows(encode, &map_a, out, R, C, BR) || !encode_rows(encode, &map_w, w, V1, C, BV))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      head_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  head_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(map_a, map_w, bias, R, C, V1, per, pm, pl,
                                                      pa);
  return cudaGetLastError();
}

cudaError_t launch_f32(dim3 grid, cudaStream_t s, const float* out, const float* w,
                       const float* bias, int R, int C, int V1, int per, float* pm, float* pl,
                       int* pa) {
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  if (err != cudaSuccess) return err;
  head_f32_kernel<<<grid, FTHREADS, F32_SMEM, s>>>(out, w, bias, R, C, V1, per, vec, pm, pl, pa);
  return cudaGetLastError();
}

}  // namespace

// out [R, C] and w [V1, C] (bf16 if `bf16`, else f32), b [V1] f32 ->
// tok [R] int32, mx [R] f32, lse [R] f32.  The vocab tiles (256 columns in
// bf16, 128 in f32) are cut into `splits` runs of `tiles_per_split`, each
// with at least one tile; part_* are [splits, R] scratch.
extern "C" int echr_greedy_head(const void* out, const void* w, const void* b, int bf16, int R,
                                int C, int V1, int tiles_per_split, int splits, void* part_m,
                                void* part_l, void* part_a, void* tok, void* mx, void* lse,
                                void* stream) {
  const int n_tiles = (V1 + (bf16 ? BV : FV) - 1) / (bf16 ? BV : FV);
  if (tiles_per_split < 1 || splits < 1 || (splits - 1) * tiles_per_split >= n_tiles ||
      splits * tiles_per_split < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + BR - 1) / BR, splits);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bias = static_cast<const float*>(b);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<int*>(part_a);
  const cudaError_t err =
      bf16 ? launch_bf16(grid, s, out, w, bias, R, C, V1, tiles_per_split, pm, pl, pa)
           : launch_f32(grid, s, static_cast<const float*>(out), static_cast<const float*>(w),
                        bias, R, C, V1, tiles_per_split, pm, pl, pa);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_combine_kernel<<<(R + 255) / 256, 256, 0, s>>>(pm, pl, pa, splits, R,
                                                     static_cast<int*>(tok),
                                                     static_cast<float*>(mx),
                                                     static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}
