// Kernel 11: an LSTM layer's recurrence over T in one persistent launch, for
// sm_90a.
//
//   pre    = pre_x[t] + bf16_rn(h) . W_hh^T       (products exact, sums in f32)
//   i, f, o = 1 / (1 + expf(-pre_{i,f,o})),  g = tanhf(pre_g)
//   c'     = f * c + i * g,   h' = o * tanhf(c')  (h and c kept in f32)
//
// for t = 0 .. T-1, writing every h' to hs[t].  It replaces no Pallas kernel:
// echr_tpu runs this loop as a lax.scan, and the port ran it as a Python loop
// over T of ~11 launches a step (ops/kernel_recurrence.py's plain version),
// so the host issuing ~5,600 launches a chunk set the SST's pace.
//
// What bounds it on an H100: the chain of T dependent steps.  The work is
// small (a [B, H] x [H, 4H] product a step, 0.14 GFLOP at B = 128, H = 512)
// and so are the bytes (pre_x read once, hs written once), so a step costs a
// grid barrier, an L2 round trip for h and the product's latency.
//
// The persistent-RNN design: one block per 4 hidden units (H = 512: 128
// blocks, one an SM), launched cooperatively, so every block is resident at
// once.  A block holds its 16 gate columns of W_hh in shared memory for all T
// steps (column n = 4 * unit + gate, rows padded so that the 16-byte fragment
// loads meet no bank conflict) and its units' c in shared memory.  Each step:
//   1. each warp loads its 16-row tiles of h_{t-1} (bf16, [B, H]) straight
//      from the exchange buffer into registers with ld.global.cg (L2 only: the
//      buffer is rewritten every second step, so L1 would hold stale lines);
//   2. mma.sync m16n8k16 (bf16 in, f32 out) against the shared W columns.  A
//      thread's 16-byte load covers two k-steps: the k axis is permuted
//      within each 32-wide block, the same way for A and W, which changes only
//      the order of the sums;
//   3. the gate epilogue in registers: lanes 2j and 2j + 1 hold gates (i, f)
//      and (g, o) of one unit for rows r and r + 8, swap one pair by shuffle,
//      and each finishes one (row, unit), with pre_x[t]'s slice from shared
//      memory (cp.async, fetched through the previous step);
//   4. h' goes to hs[t] (f32) and, rounded to bf16, to the other half of the
//      double-buffered exchange buffer;
//   5. the blocks meet at a grid barrier (a counter in global memory: release
//      by red.release.gpu, acquire by ld.acquire.gpu).
// Rows adapt to B inside the block: B >= 128 gives each of the 8 warps whole
// 16-row tiles; a smaller B splits the k axis over the warps that would
// otherwise idle (B = 32: 2 row tiles x 4 k-quarters; B = 1: 1 x 8), their
// partial sums added in shared memory in a fixed order.  Blocks of 8 units
// (64 blocks, half the L2 reads of h) measured slower at B = 128, 32 and 1,
// and so did 16 k blocks of loads in flight a warp in place of 8 at B = 32 and
// 1 (faster by 5% at 128).
//
// No fast math: expf and tanhf are the accurate ones, and c' and h' use
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA: the
// kernel differs from the loop only in the order of the product's sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 2;      // n-tiles of 8 gate columns a block
constexpr int U = 2 * NT;  // hidden units a block
constexpr int N = 4 * U;   // its gate columns
constexpr int KB = 32;  // k values a thread's 16-byte load of a row covers: two k-steps
constexpr int CH = 8;   // k blocks whose loads a warp keeps in flight at once
constexpr unsigned FULL = 0xffffffffu;

// W_s's row stride in bf16: 2H bytes rounded up to 128, plus 64, so that the
// eight lanes of a quarter-warp (two rows, four 16-byte columns) hit
// distinct banks
__host__ __device__ inline int w_stride(int H) { return ((2 * H + 127) / 128 * 128 + 64) / 2; }

__host__ __device__ inline size_t smem_bytes(int B, int H) {
  return 4 * U * w_stride(H) * 2          // W_s
         + 2 * static_cast<size_t>(B) * 4 * U * 4  // px_s, two steps
         + static_cast<size_t>(B) * U * 4         // c_s
         + WARPS * 32 * 2 * U * 4;                // red_s: a warp's partial sums
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Returns once every block has arrived `target / gridDim.x` times and this
// thread's cp.async copies have landed.  The block's writes before it are
// released to the grid by thread 0's red.release after the block barrier,
// and acquired by its ld.acquire before the next.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    while (ld_acquire(count) < target) {
    }
  }
  cpa::cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// pre_x[t]'s columns of the block's units into dst [B][4 gates][U], 16 bytes a copy
__device__ __forceinline__ void fetch_px(float* dst, const float* pre_x, int t, int B, int H,
                                         int u0) {
  constexpr int C = U / 4;  // 16-byte copies a (row, gate)
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < B * 4 * C; i += THREADS) {
    const int c = i % C, q = (i / C) % 4, b = i / (4 * C);
    const float* src = pre_x + (static_cast<size_t>(t) * B + b) * 4 * H + q * H + u0 + 4 * c;
    cpa::cp_async16(base + 16u * ((b * 4 + q) * C + c), src, true);
  }
  cpa::cp_async_commit();
}

// acc[nt] += h rows [16 mt, 16 mt + 16) . the block's n-tile nt, over the k
// blocks ks, ks + KS, ... of H / 32
__device__ __forceinline__ void tile_product(float (&acc)[NT][4], const __nv_bfloat16* hx,
                                             const __nv_bfloat16* W_s, int SK, int mt, int ks,
                                             int KS, int B, int H) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  const uint4* a0p = reinterpret_cast<const uint4*>(hx + static_cast<size_t>(r0) * H) + tg;
  const uint4* a1p = reinterpret_cast<const uint4*>(hx + static_cast<size_t>(r1) * H) + tg;
  const __nv_bfloat16* wp = W_s + g * SK + 8 * tg;
  const int nkb = H / KB;
  float part[2][NT][4] = {};  // even and odd k-steps: two chains of half the depth
  for (int base = ks; base < nkb; base += KS * CH) {
    uint4 ra[CH], rb[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int kb = base + i * KS;
      ra[i] = kb < nkb && r0 < B ? __ldcg(a0p + kb * 4) : make_uint4(0, 0, 0, 0);
      rb[i] = kb < nkb && r1 < B ? __ldcg(a1p + kb * 4) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int kb = base + i * KS;
      if (kb < nkb) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 w = *reinterpret_cast<const uint4*>(wp + nt * 8 * SK + kb * KB);
          mma_bf16(part[0][nt], ra[i].x, rb[i].x, ra[i].y, rb[i].y, w.x, w.y);
          mma_bf16(part[1][nt], ra[i].z, rb[i].z, ra[i].w, rb[i].w, w.z, w.w);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = part[0][nt][j] + part[1][nt][j];
  }
}

// The gates of row tile mt from the finished sums: lane (g, tg) holds, for
// n-tile nt, columns 2 tg, 2 tg + 1 of rows g and g + 8, that is gates (i, f)
// (tg even) or (g, o) (tg odd) of unit 2 nt + tg / 2.  The even lane finishes
// row g, the odd lane row g + 8.
__device__ __forceinline__ void gate_epilogue(float (&acc)[NT][4], const float* px, float* c_s,
                                              float* hs_t, __nv_bfloat16* hn, float* c_out,
                                              int mt, int B, int H, int u0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const bool odd = tg & 1;
  const int row = mt * 16 + g + (odd ? 8 : 0);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* a = acc[nt];
    const float r0 = __shfl_xor_sync(FULL, odd ? a[0] : a[2], 1);
    const float r1 = __shfl_xor_sync(FULL, odd ? a[1] : a[3], 1);
    const int ul = 2 * nt + (tg >> 1);
    if (row < B) {
      const float* p = px + row * 4 * U + ul;
      const float pi = p[0] + (odd ? r0 : a[0]);
      const float pf = p[U] + (odd ? r1 : a[1]);
      const float pg = p[2 * U] + (odd ? a[2] : r0);
      const float po = p[3 * U] + (odd ? a[3] : r1);
      float* c = c_s + row * U + ul;
      const float cn = __fadd_rn(__fmul_rn(sigmoid(pf), *c), __fmul_rn(sigmoid(pi), tanhf(pg)));
      const float h = __fmul_rn(sigmoid(po), tanhf(cn));
      *c = cn;
      const size_t at = static_cast<size_t>(row) * H + u0 + ul;
      hs_t[at] = h;
      hn[at] = __float2bfloat16_rn(h);
      if (c_out) c_out[at] = cn;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_recurrence_kernel(const float* __restrict__ pre_x, const __nv_bfloat16* __restrict__ w_hh,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* __restrict__ hs, float* __restrict__ c_out, __nv_bfloat16* xbuf,
                       unsigned* count, int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SK = w_stride(H);
  auto* W_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* px_s = reinterpret_cast<float*>(smem + static_cast<size_t>(N) * SK * 2);
  float* c_s = px_s + 2 * B * N;
  float* red_s = c_s + B * U;
  const int u0 = blockIdx.x * U;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // W's rows for column n = 4 * unit + gate: w_hh[gate * H + u0 + unit]
  const int H8 = H / 8;
  for (int i = threadIdx.x; i < N * H8; i += THREADS) {
    const int n = i / H8, k8 = i - n * H8;
    const size_t src = static_cast<size_t>((n & 3) * H + u0 + (n >> 2)) * H + k8 * 8;
    *reinterpret_cast<uint4*>(W_s + n * SK + k8 * 8) =
        *reinterpret_cast<const uint4*>(w_hh + src);
  }
  // c0 and bf16(h0) of the block's units, zeros without them
  for (int i = threadIdx.x; i < B * U; i += THREADS) {
    const int b = i / U, u = i - b * U;
    const size_t at = static_cast<size_t>(b) * H + u0 + u;
    c_s[i] = c0 ? c0[at] : 0.f;
    xbuf[at] = __float2bfloat16_rn(h0 ? h0[at] : 0.f);
  }
  fetch_px(px_s, pre_x, 0, B, H, u0);
  grid_barrier(count, gridDim.x);

  const int MT = (B + 15) / 16;
  const int KS = MT >= WARPS ? 1 : WARPS / MT;  // warps a row tile's k axis is split over
  const int ks = MT >= WARPS ? 0 : warp / MT;
  const size_t BH = static_cast<size_t>(B) * H;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hx = xbuf + (t & 1) * BH;
    __nv_bfloat16* hn = xbuf + ((t + 1) & 1) * BH;
    const float* px = px_s + (t & 1) * B * N;
    float* hs_t = hs + t * BH;
    float* c_t = t == T - 1 ? c_out : nullptr;
    // the next step's pre_x, in flight through this step and its barrier
    if (t + 1 < T) fetch_px(px_s + ((t + 1) & 1) * B * N, pre_x, t + 1, B, H, u0);
    float acc[NT][4];
    if (KS == 1) {
      for (int mt = warp; mt < MT; mt += WARPS) {
        tile_product(acc, hx, W_s, SK, mt, 0, 1, B, H);
        gate_epilogue(acc, px, c_s, hs_t, hn, c_t, mt, B, H, u0);
      }
    } else {
      const int mt = warp % MT;
      float* mine = red_s + (warp * 32 + lane) * 4 * NT;
      if (ks < KS) tile_product(acc, hx, W_s, SK, mt, ks, KS, B, H);
      if (ks > 0 && ks < KS) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mine[nt * 4 + j] = acc[nt][j];
        }
      }
      __syncthreads();
      if (ks == 0) {
        for (int s = 1; s < KS; ++s) {
          const float* other = red_s + ((warp + s * MT) * 32 + lane) * 4 * NT;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[nt][j] += other[nt * 4 + j];
          }
        }
        gate_epilogue(acc, px, c_s, hs_t, hn, c_t, mt, B, H, u0);
      }
    }
    if (t + 1 < T) grid_barrier(count, (t + 2) * gridDim.x);
  }
}

}  // namespace

// hs [T, B, H] and c_out [B, H] f32 from pre_x [T, B, 4H] f32 and w_hh
// [4H, H] bf16; h0, c0 [B, H] f32 or null (zeros).  xbuf: scratch of 2 B H
// bf16, count: one unsigned.  H a multiple of 32; its H / 4 blocks must be
// co-resident, or the cooperative launch refuses.
extern "C" int echr_lstm_recurrence(const void* pre_x, const void* w_hh, const void* h0,
                                    const void* c0, void* hs, void* c_out, void* xbuf,
                                    void* count, int T, int B, int H, void* stream) {
  const size_t smem = smem_bytes(B, H);
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&pre_x, &w_hh, &h0, &c0, &hs, &c_out, &xbuf, &count, &T, &B, &H};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_recurrence_kernel),
                                    dim3(H / U), dim3(THREADS), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
