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
// j: dot has ceil(T/128) copies of the product (17.2 GFLOP a call at B=32,
// N=128, T=256, H=512, KD=2048).  Both are one template on DOT: the score warps
// and their code are the same in both, so kernel 10 - kernel 9 is what the
// product adds.
//
// What bounds them on an H100.  Kernel 9 is B*N*T*H = 537M tanh at the
// probe's shapes (2.15 GFLOP f32 at 4 per element against 29 MB).  Each tanh
// is echr_tanh (tanh.cuh): 7 instructions, two of them special-function-unit
// (SFU) ops, ex2 and rcp, of the SM's 16 a clock, so the SFU floor is 0.26 ms
// at 1980 MHz.  With the add of q and pre and the multiply-add by w a tanh
// takes 9 issue slots a warp (the score loop: ~1140 instructions for 128
// tanh) against the SFU's 16 cycles, so the score warps are bound by the SFU
// and leave ~7 of every 16 issue slots free.  Kernel 10
// adds 17.2 GFLOP of bf16 products (0.017 ms at the card's 989 TFLOP/s), 67 MB
// of f32 output and wd [H, KD] read once a block from L2 (256 MiB at the
// probe's shapes): tensor-core, memory and L2 work that needs few issue slots
// if it is issued as warpgroup mma.  The question the pair answers is whether
// that work hides in the score warps' free slots.
//
// A block owns (video b, TN=64 proposals, TT=128 frames): one copy of the
// product is 64 rows, wgmma's M, and the probe's grid is 2 x 2 x 32 = 128
// blocks, one wave on 132 SMs.
//
// Score warps (SCORE_WARPS = 8, both kernels).  Warp g owns proposals
// 8g .. 8g + 7, lane l frames l + 32 j (j < 4): 32 independent accumulators a
// thread.  pre, q and w are staged HC=16 hidden units at a time by 16-byte
// cp.async into a ring of three buffers, one named barrier a chunk, so the
// copy of chunk c + 2 runs under the tanh of chunk c.  A thread reads its 4
// frames' pre as float4 (rows 80 bytes apart: no bank conflict) and its
// warp's 8 proposals' q as float4 broadcasts, 13 shared loads for 128 tanh.
//
// Product warps (kernel 10 only): a producer warp and a consumer warpgroup,
// on hopper.cuh.  The producer's one thread streams wd through a ring of
// STAGES [64 x 128] stages by TMA (two [64 x 64] boxes a stage, 128-byte
// swizzle), full / empty mbarriers.  The consumer converts the block's 64 q
// rows to bf16 into a K-major A in shared memory, written by hand in the
// 128-byte swizzle that sw128_desc reads (16-byte chunk c of row r at
// c ^ (r % 8)), then for each 128-column tile of KD runs wgmma m64n128k16
// over H, A and wd's stages both from shared memory (wd MN-major, as it lies:
// sw128_mn_desc), and stores the f32 accumulators straight to dot, the rows
// past N masked.  The score warps and the product warps share only the
// barrier after the mbarriers' init; the score warps sync on named barrier 1,
// the consumer on 2.  The product warps are a function of their own, not
// inlined, so ptxas schedules the score loop in kernel 10 as in kernel 9.
// 13 warps at one block an SM leave 128 registers a thread, enough for both
// roles without a spill (ptxas: PERF.md), so no setmaxnreg.
//
// Ragged N, T and H are masked: cp.async zero-fills rows past N or T and
// hidden units past H, A is zero past H and TMA reads wd's rows past H as
// zero.  Both kernels need H a multiple of 4 and 16-byte aligned pre, q and
// w; kernel 10 also KD a multiple of 128, wd 16-byte aligned, and H <= 896
// (A, 64 x H bf16, shares the 227 KB with the ring and the staged chunks).
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "tanh.cuh"

namespace {

using namespace hopper;

constexpr int TN = 64;   // proposals per block: wgmma's M
constexpr int TT = 128;  // frames per block: the probe's TILE_T, one copy of the product
constexpr int SCORE_WARPS = 8;
constexpr int SCORE_THREADS = 32 * SCORE_WARPS;
constexpr int RN = TN / SCORE_WARPS;  // proposals of a score thread: its warp's
constexpr int RT = TT / 32;           // frames of a score thread: lane + 32 j
constexpr int HC = 16;                // hidden units of a staged chunk
constexpr int V4 = HC / 4;            // float4 a staged row
constexpr int BUFS = 3;               // staged chunks in flight
constexpr int PRE_LD = HC + 4;        // a staged pre row, floats: 80 bytes
constexpr int BUF_FLOATS = TT * PRE_LD + TN * HC + HC;  // pre, q, w of a chunk
constexpr int SCORE_BYTES = BUFS * BUF_FLOATS * 4;

constexpr int KN = 128;                  // columns of a product tile: wgmma's n
constexpr int BK = SW;                   // hidden units of a ring stage
constexpr int STAGES = 4;
constexpr int CHUNK_BYTES = BK * SW * 2;     // one [64 x 64] box of wd
constexpr int STAGE_BYTES = BK * KN * 2;
constexpr int A_ATOM = TN * 128;             // 64 rows x 64 hidden units of A, bf16
constexpr int DOT_THREADS = 128 + 32;        // the consumer warpgroup, the producer warp
constexpr int SMEM_LIMIT = 232448;           // 227 KB: what one block may use
constexpr int SCORE_BAR = 1, DOT_BAR = 2;    // named barriers (0 is __syncthreads)

static_assert(TN % SCORE_WARPS == 0 && TT % 32 == 0 && HC % 4 == 0, "score tiling");
static_assert((PRE_LD / 4) % 2 == 1, "pre rows an odd number of 16-byte chunks apart");
static_assert(TN == 64 && KN % SW == 0 && KN / 2 <= 128, "one m64nKNk16 consumer");
static_assert(SCORE_BYTES % 16 == 0, "the barriers follow the staged chunks");

__host__ __device__ constexpr int padded_h(int H) { return (H + SW - 1) / SW * SW; }

// kernel 10: 1024 bytes of alignment slack, the ring, A, the staged chunks,
// then the full and the empty barriers; kernel 9: the staged chunks
__host__ __device__ constexpr int smem_bytes(bool dot, int H) {
  return dot ? 1024 + STAGES * STAGE_BYTES + A_ATOM * (padded_h(H) / SW) + SCORE_BYTES +
                   16 * STAGES
             : SCORE_BYTES;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// 16 bytes from global to shared; zeros, and no read, where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void score_warps(const float* __restrict__ pre,
                                            const float* __restrict__ q,
                                            const float* __restrict__ w, float* __restrict__ s,
                                            float* buf, int b, int n0, int t0, int N, int T,
                                            int H) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  const uint32_t buf0 = smem_u32(buf);
  const int chunks = (H + HC - 1) / HC;

  // chunk c into buffer c % BUFS: TT rows of pre, TN rows of q, then w, V4
  // 16-byte copies a row; an empty group past the last chunk keeps the count
  auto stage = [&](int c) {
    if (c < chunks) {
      const uint32_t dst = buf0 + (c % BUFS) * (BUF_FLOATS * 4);
      for (int i = threadIdx.x; i < (TT + TN + 1) * V4; i += SCORE_THREADS) {
        const int r = i / V4, v = i % V4, h = c * HC + 4 * v;
        const float* src = w + h;
        uint32_t d = dst + (TT * PRE_LD + TN * HC + 4 * v) * 4;
        bool ok = h < H;
        if (r < TT) {
          src = pb + (size_t)(t0 + r) * H + h;
          d = dst + (r * PRE_LD + 4 * v) * 4;
          ok = ok && t0 + r < T;
        } else if (r < TT + TN) {
          src = qb + (size_t)(n0 + r - TT) * H + h;
          d = dst + (TT * PRE_LD + (r - TT) * HC + 4 * v) * 4;
          ok = ok && n0 + r - TT < N;
        }
        cp_async16(d, ok ? src : w, ok);
      }
    }
    cp_async_commit();
  };

  float acc[RN][RT];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  stage(0);
  stage(1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<1>();                       // this thread's copies of chunk c landed
    named_barrier(SCORE_BAR, SCORE_THREADS);  // everyone's; and chunk c - 1 is read
    stage(c + 2);                             // into chunk c - 1's buffer
    const float* cur = buf + (c % BUFS) * BUF_FLOATS;
    const float4* p4 = reinterpret_cast<const float4*>(cur) + lane * (PRE_LD / 4);
    const float4* q4 = reinterpret_cast<const float4*>(cur + TT * PRE_LD) + warp * RN * V4;
    const float4* w4 = reinterpret_cast<const float4*>(cur + TT * PRE_LD + TN * HC);
#pragma unroll 1
    for (int v = 0; v < V4; ++v) {
      const float4 wv = w4[v];
      float4 pv[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) pv[j] = p4[32 * j * (PRE_LD / 4) + v];
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float4 qv = q4[i * V4 + v];  // the warp's row: a broadcast
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          float a = acc[i][j];
          a = fmaf(wv.x, echr_tanh(qv.x + pv[j].x), a);
          a = fmaf(wv.y, echr_tanh(qv.y + pv[j].y), a);
          a = fmaf(wv.z, echr_tanh(qv.z + pv[j].z), a);
          a = fmaf(wv.w, echr_tanh(qv.w + pv[j].w), a);
          acc[i][j] = a;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int n = n0 + warp * RN + i;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int t = t0 + lane + 32 * j;
        if (t < T) s[((size_t)b * N + n) * T + t] = acc[i][j];
      }
    }
  }
}

// kernel 10's product warps: warps SCORE_WARPS .. + 3 the consumer
// warpgroup, the next the producer.  Not inlined: inlined into the kernel,
// this code led ptxas to schedule the score loop with its tanh chains one
// after another (the same instructions), and kernel 10 took 1.5x as long
// (kernel_turns.py's docstring gives the sed that builds the inlined copy).
__device__ __noinline__ void product_warps(const CUtensorMap* map_wd,
                                              const float* __restrict__ q,
                                              float* __restrict__ dot, uint32_t ring,
                                              uint32_t a_base, uint32_t full0, uint32_t empty0,
                                              int b, int n0, int N, int H, int KD) {
  const int lt = threadIdx.x - SCORE_THREADS;
  const int nk = padded_h(H) / BK;
  const int tiles = KD / KN;
  if (lt >= 128) {  // the producer
    if (lt == 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < tiles; ++tile)
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, STAGE_BYTES);  // rows past H count: TMA writes them as zeros
#pragma unroll
          for (int c = 0; c < KN / SW; ++c)
            tma_load(ring + stage * STAGE_BYTES + c * CHUNK_BYTES, map_wd, full,
                     tile * KN + c * SW, kt * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // A: the block's q rows in bf16, K-major, one [64 x 64] swizzle atom per 64
  // hidden units; thread i writes 16-byte chunk c8 (8 hidden units) of row r
  const int row_chunks = nk * (SW / 8);
  const float* qb = q + ((size_t)b * N + n0) * H;
  for (int i = lt; i < TN * row_chunks; i += 128) {
    const int r = i / row_chunks, c8 = i % row_chunks, h = 8 * c8;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (n0 + r < N) {
      const float4* src = reinterpret_cast<const float4*>(qb + (size_t)r * H + h);
      if (h < H) lo = __ldg(src);
      if (h + 4 < H) hi = __ldg(src + 1);
    }
    const uint32_t dst = a_base + (c8 / 8) * A_ATOM + r * 128 + (((c8 % 8) ^ (r & 7)) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(bf16x2(lo.x, lo.y)), "r"(bf16x2(lo.z, lo.w)), "r"(bf16x2(hi.x, hi.y)),
                 "r"(bf16x2(hi.z, hi.w))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  named_barrier(DOT_BAR, 128);

  // thread lt holds rows 16 (lt / 32) + (lt % 32) / 4 + 8 h, h < 2; register
  // 4 jj + 2 h + e column 8 jj + 2 (lt % 4) + e (hopper.cuh, fold_tile)
  const int lane = lt & 31;
  const int r0 = 16 * (lt >> 5) + (lane >> 2);
  float* out = dot + (((size_t)b * gridDim.x + blockIdx.x) * N + n0) * KD + 2 * (lane & 3);
  float acc[KN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = a_base + kt * A_ATOM;
      const uint32_t bw = ring + stage * STAGE_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // 16 deeper: 32 bytes along A's rows, 16 rows of wd
        wgmma<1>(acc, sw128_desc(a + 32 * k), sw128_mn_desc(bw + 16 * 128 * k, CHUNK_BYTES),
                 kt > 0 || k > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lt == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (n0 + r < N) {
        float* o = out + (size_t)r * KD + tile * KN;
#pragma unroll
        for (int jj = 0; jj < KN / 8; ++jj)
          __stcs(reinterpret_cast<float2*>(o + 8 * jj),
                 make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]));
      }
    }
  }
}

template <bool DOT>
__global__ void __launch_bounds__(DOT ? SCORE_THREADS + DOT_THREADS : SCORE_THREADS, 1)
probe_scores_kernel(const __grid_constant__ CUtensorMap map_wd, const float* __restrict__ pre,
                    const float* __restrict__ q, const float* __restrict__ w,
                    float* __restrict__ s, float* __restrict__ dot, int N, int T, int H, int KD,
                    bool scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, n0 = blockIdx.y * TN, t0 = blockIdx.x * TT;
  if constexpr (!DOT) {
    score_warps(pre, q, w, s, reinterpret_cast<float*>(smem), b, n0, t0, N, T, H);
  } else {
    const uint32_t raw = smem_u32(smem);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    const uint32_t a_base = ring + STAGES * STAGE_BYTES;
    const uint32_t staged = a_base + A_ATOM * (padded_h(H) / SW);
    const uint32_t full0 = staged + SCORE_BYTES, empty0 = full0 + 8 * STAGES;
    if (threadIdx.x == 0) {
      for (int st = 0; st < STAGES; ++st) {
        mbar_init(full0 + 8 * st, 1);   // the producer's arrival, then the bytes
        mbar_init(empty0 + 8 * st, 1);  // the consumer warpgroup
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the only barrier the two groups share
    if (threadIdx.x < SCORE_THREADS) {
      if (scores)
        score_warps(pre, q, w, s, reinterpret_cast<float*>(smem + (staged - raw)), b, n0, t0,
                    N, T, H);
    } else {
      product_warps(&map_wd, q, dot, ring, a_base, full0, empty0, b, n0, N, H, KD);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// pre [B, T, H], q [B, N, H], w [H] f32 -> s [B, N, T] f32 (kernel 9, wd and
// dot null); with wd [H, KD] bf16 also dot [B, ceil(T/128), N, KD] f32
// (kernel 10).  H a multiple of 4, pre, q, w (and wd) 16-byte aligned; kernel
// 10 also KD a multiple of 128 and H <= 896; else cudaErrorInvalidValue.
// scores = 0 runs kernel 10's product warps alone, s untouched: the product's
// own time in the same kernel.
extern "C" int echr_probe_scores(const void* pre, const void* q, const void* w, const void* wd,
                                 void* s, void* dot, int B, int N, int T, int H, int KD,
                                 int scores, void* stream) {
  if (H < 1 || H % 4 != 0 || !aligned16(pre) || !aligned16(q) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + TT - 1) / TT, (N + TN - 1) / TN, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(pre);
  const auto* qq = static_cast<const float*>(q);
  const auto* ww = static_cast<const float*>(w);
  auto* ss = static_cast<float*>(s);
  const bool with_dot = wd != nullptr;
  const int smem = smem_bytes(with_dot, H);
  CUtensorMap map{};
  if (with_dot) {
    if (KD < KN || KD % KN != 0 || smem > SMEM_LIMIT || !aligned16(wd))
      return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (!encode_rows(encode, &map, wd, H, KD, BK)) return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = with_dot ? probe_scores_kernel<true> : probe_scores_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, with_dot ? SCORE_THREADS + DOT_THREADS : SCORE_THREADS, smem, st>>>(
      map, p, qq, ww, ss, static_cast<float*>(dot), N, T, H, KD, with_dot ? scores != 0 : true);
  return static_cast<int>(cudaGetLastError());
}
