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
#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BR = 128;  // rows per block, both paths

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int BV = 256;        // vocab columns per tile: the wgmma n
constexpr int BK = 64;         // depth of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr int A_BYTES = BR * BK * 2;
constexpr int W_BYTES = BV * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;  // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box at (c0 along C, c1 along rows) of `map` into shared memory at dst;
// completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major bf16 tile in the 128-byte swizzle TMA writes:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// the accumulators are not read or written across this point
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a [64 x 16] . w [256 x 16]^T, both K-major in shared memory;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t dw,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      " %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(dw), "r"(scale_d));
}

// The consumers' accumulator layout (wgmma m64nN, f32): thread t of a
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 h, h < 2, and register
// 4 j + 2 h + e holds column 8 j + 2 (t % 4) + e, j < 32, e < 2.
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
          wgmma_256(acc, sw128_desc(a + 32 * k), sw128_desc(w + 32 * k), kt > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // fold the tile: bias, mask v >= V1, (max, argmax) by an ascending
      // scan with strict >, then over the 4 threads of each row
      const int v0 = tile * BV;
      float best[2] = {-INFINITY, -INFINITY};
      int best_i[2] = {INT32_MAX, INT32_MAX};
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + 8 * j + 2 * quad + e;
          const bool live = v < V1;
          const float bv = live ? __ldg(bias + v) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& x = acc[4 * j + 2 * h + e];
            x = live ? x + bv : -INFINITY;
            if (x > best[h]) {
              best[h] = x;
              best_i[h] = v;
            }
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ob = __shfl_xor_sync(FULL, best[h], o);
          const int oi = __shfl_xor_sync(FULL, best_i[h], o);
          if (ob > best[h] || (ob == best[h] && oi < best_i[h])) {
            best[h] = ob;
            best_i[h] = oi;
          }
        }
      }
      float m_new[2], s[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m_run[h], best[h]);
#pragma unroll
      for (int i = 0; i < 128; ++i) {  // exp(x - m) as 2^(x log2e - m log2e); masked: 0
        const int h = (i >> 1) & 1;
        s[h] += exp2f(fmaf(acc[i], LOG2E, -m_new[h] * LOG2E));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(FULL, s[h], 1);
        s[h] += __shfl_xor_sync(FULL, s[h], 2);
        l_run[h] = l_run[h] * exp2f((m_run[h] - m_new[h]) * LOG2E) + s[h];
        if (best[h] > m_run[h]) a_run[h] = best_i[h];  // strict: an earlier tile keeps a tie
        m_run[h] = m_new[h];
      }
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

// cuTensorMapEncodeTiled, from the CUDA driver library the runtime has loaded
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major bf16 [rows, C] matrix in boxes of box_rows x 64,
// 128-byte swizzled; out-of-bounds elements read as zero
bool encode_rows(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int C,
                 int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
