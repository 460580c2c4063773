// Kernels 7 and 8: the streaming greedy head of the head probes, for sm_90a.
//
// For each row r of out [R, C] (bf16), over the pre-padded vocab of w [C, VP]
// (bf16; VP a multiple of the vocab tile, the pad columns zero) and b [VP]
// (f32; -1e30 in the pad lanes, so a pad never wins or adds to the sum):
//   tok[r] = argmax_v logit[r, v], mx[r] = max_v logit[r, v],
//   lse[r] = log sum_v exp(logit[r, v]),  logit = out @ w + b,
// without the [R, VP] logits reaching global memory.  Kernel 7 replaces the
// Pallas TPU kernel experiments/probe_greedy_head.py::_greedy_head_kernel
// (pallas_call at :79), the fixed plan; kernel 8 replaces
// experiments/probe_streaming_head2.py::_kernel (pallas_call at :78), the same
// function with the tiling as a parameter.  Both are this one template over
// (TR rows per block, TV vocab columns per tile).
//
// Bound on an H100 by tensor-core throughput: 75.5 GFLOP bf16 per step at
// R=4096, C=1536, V1=6001 (VP=6144), against 31.5 MB of inputs and outputs.
// The probes' contract: one block owns TR rows and walks every vocab tile in
// order (the TPU grid's sequential j axis), with no vocab split and no
// combine pass, so the grid is ceil(R / TR) row blocks.  What bounds such a
// head on this card is occupancy, not the product's rate: R / TR blocks (128,
// 64, 32 at R=4096 against 132 SMs), each a 64-row wgmma slice or two walking
// all of VP on one SM, so no tiling runs below one such block's time (0.161
// ms at TR <= 64 here, twice that at TR=128).  Every block also reads all of
// w from L2 (R / TR x 18.9 MB) and A once per vocab tile; that L2 traffic
// was measured not to bind.
//
// The block is kernel 2's machinery (hopper.cuh): three warpgroups, the third
// a producer whose one thread keeps TMA loads (128-byte swizzle) in flight in
// a ring of as many stages as fit 227 KB (Plan::STAGES), with full / empty
// mbarriers; each stage holds the A box [TR x 64] (K-major) and w's [64 x TV]
// box as TV / 64 chunks of 64 vocab columns (MN-major: wgmma reads B
// "transposed", so w is loaded as it lies, vocab contiguous).  The two
// consumer warpgroups run wgmma m64nNk16 with f32 accumulators in registers
// and fold each finished vocab tile in registers into a running (max, argmax,
// sumexp) per row (fold_tile); setmaxnreg gives them 232 registers and the
// producer 40.  wgmma's M is 64 rows, so the two consumers split the tile by
// rows at TR=128 (N=TV) and by columns at TR<=64 (N=TV/2; at the end the
// upper half's (max, argmax, sumexp) merges into the lower's, a tie taking
// the lower index); at TR=32
// each wgmma computes 64 rows of which 32 are kept: half the tensor-core work
// is waste, the price of that tiling.  (128, 512) is not instantiated: N=512
// is 256 accumulators a thread.
//
// Neither of Hopper's answers to the L2 traffic is taken: the A row block
// does not stay resident (at TR=64, C=1536 it is 192 KB, which leaves no
// room for w's ring), and no thread-block cluster shares w's tiles by TMA
// multicast: on an H100 clusters of 2 and 4 row blocks gained a few percent
// at one tiling at most and lost at others (PERF.md), which did not pay for
// the multicast, the cluster-wide barriers and the drain they need.
//
// Ties, as the probes: within a tile the lowest index of the tile's max wins;
// a later tile takes over only on a strictly greater max.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int BK = SW;        // depth of a stage: one 128-byte swizzle row of A
constexpr int CHUNK_BYTES = BK * SW * 2;  // one [BK x 64] box of w
constexpr int SMEM_LIMIT = 232448;        // 227 KB: what one block may use
constexpr int MERGE_BYTES = 64 * 12;      // the column halves' merge: (m, l, a) per row

template <int TR, int TV>
struct Plan {
  static constexpr int MG = TR > 64 ? 2 : 1;  // 64-row wgmma slices of the block
  static constexpr int CG = 2 / MG;           // column groups of a vocab tile
  static constexpr int N = TV / CG;           // wgmma n: one consumer's columns
  static constexpr int A_SLOT = MG * 64 * BK * 2;  // TR=32: the upper 32 rows unused
  static constexpr int A_BOX = TR * BK * 2;
  static constexpr int W_BYTES = TV * BK * 2;
  static constexpr int STAGE = A_SLOT + W_BYTES;
  static constexpr int CHUNKS = TV / SW;
  // as many stages as fit: 1024 bytes of alignment slack, then each stage
  // with its two barriers, then the merge rows
  static constexpr int STAGES = (SMEM_LIMIT - 1024 - MERGE_BYTES) / (STAGE + 16);
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 16) + MERGE_BYTES;
  static_assert(TR % 32 == 0 && TR <= MG * 64 && N % SW == 0, "tiling");
  static_assert(MG * CG == 2, "two consumer warpgroups: row slices x column groups");
  static_assert(CG * N == TV, "the column groups cover the vocab tile once, in order");
  static_assert(N / 2 <= 128, "at most 128 f32 accumulators a consumer thread");
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "a ring of two stages or more in 227 KB");
};

template <int TR, int TV>
__global__ void __launch_bounds__(THREADS, 1)
stream_head_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                   int R, int C, int VP, int* __restrict__ tok, float* __restrict__ mx,
                   float* __restrict__ lse) {
  using P = Plan<TR, TV>;
  extern __shared__ unsigned char smem_raw[];
  // stage s: the A slot at base + s * STAGE, w's chunks after it (each
  // 1024-byte aligned, as the 128-byte swizzle needs); then the full and the
  // empty barriers, then the merge rows
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + P::STAGES * P::STAGE;
  const uint32_t empty0 = full0 + 8 * P::STAGES;
  unsigned char* merge = smem_raw + (empty0 + 8 * P::STAGES - smem_u32(smem_raw));
  float* merge_m = reinterpret_cast<float*>(merge);
  float* merge_l = merge_m + 64;
  int* merge_a = reinterpret_cast<int*>(merge_l + 64);

  const int row0 = blockIdx.x * TR;
  const int nk = (C + BK - 1) / BK;
  const int tiles = VP / TV;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival, then the bytes
      mbar_init(empty0 + 8 * s, 2);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer; the paths never meet again
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < tiles; ++tile)
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t dst = base + stage * P::STAGE;
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, P::A_BOX + P::W_BYTES);
          tma_load(dst, &map_a, full, kt * BK, row0);
          for (int c = 0; c < P::CHUNKS; ++c)
            tma_load(dst + P::A_SLOT + c * CHUNK_BYTES, &map_w, full, tile * TV + c * SW,
                     kt * BK);
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int mg = P::MG == 2 ? wg : 0;  // this consumer's 64-row slice
    const int cg = P::MG == 2 ? 0 : wg;  // and column group
    const int lane = threadIdx.x & 31;
    const int quad = lane & 3;
    const int warp = (threadIdx.x >> 5) & 3;
    const int r_blk = 64 * mg + 16 * warp + (lane >> 2);  // rows r_blk and r_blk + 8
    const bool live = 64 * mg + 16 * warp < TR;  // TR=32: warps 2 and 3 hold unused rows
    const uint32_t a_off = mg * (64 * BK * 2);
    const uint32_t w_off = P::A_SLOT + cg * (P::N / SW) * CHUNK_BYTES;
    float acc[P::N / 2];
#pragma unroll
    for (int i = 0; i < P::N / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    int a_run[2] = {0, 0};
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = base + stage * P::STAGE + a_off;
        const uint32_t w = base + stage * P::STAGE + w_off;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // 16 deeper: 32 bytes along A's rows, 16 rows of w
          wgmma<1>(acc, sw128_desc(a + 32 * k), sw128_mn_desc(w + 16 * 128 * k, CHUNK_BYTES),
                   kt > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if ((threadIdx.x & 127) == 0) mbar_arrive(empty0 + 8 * stage);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (live) fold_tile<P::N>(acc, bias, tile * TV + cg * P::N, VP, quad, m_run, l_run, a_run);
    }
    if (P::CG == 2) {  // the upper column half merges into the lower
      if (cg == 1 && live && quad == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          merge_m[r_blk + 8 * h] = m_run[h];
          merge_l[r_blk + 8 * h] = l_run[h];
          merge_a[r_blk + 8 * h] = a_run[h];
        }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
      if (cg == 0 && live && quad == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m1 = merge_m[r_blk + 8 * h];
          const int a1 = merge_a[r_blk + 8 * h];
          const float m = fmaxf(m_run[h], m1);
          l_run[h] = l_run[h] * exp2f((m_run[h] - m) * LOG2E) +
                     merge_l[r_blk + 8 * h] * exp2f((m1 - m) * LOG2E);
          // each half's argmax is its first index of its max: on a tie the
          // lower of the two is the first overall
          if (m1 > m_run[h] || (m1 == m_run[h] && a1 < a_run[h])) a_run[h] = a1;
          m_run[h] = m;
        }
    }
    if (cg == 0 && live && quad == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r_blk + 8 * h;
        if (row < R) {
          tok[row] = a_run[h];
          mx[row] = m_run[h];
          lse[row] = m_run[h] + logf(l_run[h]);
        }
      }
  }
}

template <int TR, int TV>
cudaError_t launch(cudaStream_t s, const void* out, const void* w, const void* b, int R, int C,
                   int VP, void* tok, void* mx, void* lse) {
  using P = Plan<TR, TV>;
  if (VP % TV != 0) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_a, map_w;
  if (!encode_rows(encode, &map_a, out, R, C, TR) || !encode_rows(encode, &map_w, w, C, VP, BK))
    return cudaErrorInvalidValue;
  auto kernel = stream_head_kernel<TR, TV>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  stream_head_kernel<TR, TV><<<(R + TR - 1) / TR, THREADS, P::SMEM, s>>>(
      map_a, map_w, static_cast<const float*>(b), R, C, VP, static_cast<int*>(tok),
      static_cast<float*>(mx), static_cast<float*>(lse));
  return cudaGetLastError();
}

}  // namespace

#define ECHR_TILINGS(X) \
  X(32, 128)            \
  X(32, 256)            \
  X(32, 512)            \
  X(64, 128)            \
  X(64, 256)            \
  X(64, 512)            \
  X(128, 128)           \
  X(128, 256)

// out [R, C] bf16, w [C, VP] bf16, b [VP] f32 -> tok [R] int32, mx [R] f32,
// lse [R] f32.  C a multiple of 8, VP a multiple of tv, 16-byte aligned
// bases; (tr, tv) one of the instantiated tilings, else
// cudaErrorInvalidValue.
extern "C" int echr_probe_stream_head(const void* out, const void* w, const void* b, int R,
                                      int C, int VP, int tr, int tv, void* tok, void* mx,
                                      void* lse, void* stream) {
  if (R < 1 || C < 1 || C % 8 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define ECHR_LAUNCH(TR, TV) \
  if (tr == TR && tv == TV) err = launch<TR, TV>(s, out, w, b, R, C, VP, tok, mx, lse);
  ECHR_TILINGS(ECHR_LAUNCH)
#undef ECHR_LAUNCH
  return static_cast<int>(err);
}
