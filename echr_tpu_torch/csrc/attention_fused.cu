// Kernel 5: the fused additive-attention step, for sm_90a.
//
//   s[n, t]   = w . tanh(pre[t, :] + q[n, :]) + bias
//   att[n, :] = sum_t softmax_{t: mask[n, t] == 1}(s[n, t]) feats[t, :]
//
// for every proposal row n of every video b, in one launch; the [N, T]
// scores and weights never reach global memory.  Replaces the Pallas TPU
// kernel echr_tpu/ops/pallas_attention.py::_fused_kernel (pallas_call at
// :260, wrapper attention_fused :284).  AV numerics: the weights
// p = exp(s - m) and the feats are rounded to bf16, the products summed in
// f32, and the result is acc / l with l the f32 sum of the unrounded p.  A
// row with no mask == 1 entry gives zeros.  m is the row's max, as in the
// plain version, not _fused_kernel's running max: rounding each tile's p
// against the max seen so far moved the output up to 2.8e-3 from the plain
// version at a per-video decode step (B = 1, N = 128, windows that cross
// tile boundaries; H100 chip run), past the 2e-3 gate.
//
// What bounds it on an H100: the tanh.  At the beam path's shapes (B=32,
// N=512 rows, T=256, H=512, D=500, mask density 0.49) the live (n, t)
// need ~1.06 G tanh, whose floor at tanh.cuh's measured rate is ~0.65 ms;
// the bytes (~116 MB, ~35 us at 3.35 TB/s) and the AV (~1 GFLOP bf16 on
// tensor cores) come far below.  So the design is kernel 1's: the tanh only
// at live (n, t), on tanh.cuh, and the rest kept small beside it.
//
//   * One block of 16 warps per (video, 32-row tile, 512-column chunk of
//     D); a D > 512 takes more chunks, each recomputing the scores.  The
//     block first ballots the mask of its rows over every 32-frame tile
//     into shared memory and lists the tiles where any row is live; only
//     those are visited.
//   * Pass 1, the scores: kernel 1's masked body (attention_body.cuh,
//     pair_scores): warp w owns rows 2w and 2w + 1, holds their q and w in
//     registers (16 hidden units a lane: H = 512 in one pass, as kernel 1),
//     walks only the frames where either row is live, and one shared load
//     of pre[t] feeds both rows' tanh.  pre is staged by cp.async a tile
//     (512 hidden units of it) at a time into two buffers, the next stage
//     in flight while this one is scored.  The scores stay in shared memory
//     (128 B a frame of the row tile); each row's max stays in its warp's
//     registers (warp-shuffle max).
//   * Pass 2, the AV on tensor cores, once per (row tile, frame tile) for
//     all 512 columns: mma.sync.m16n8k16 bf16 with f32 accumulators, warp
//     w on rows 16 (w / 8).. and columns 64 (w % 8)..: 32 accumulators a
//     thread (the 16 x 512 of one warp would need 256, more than a thread
//     has).  Each thread builds its A fragment, bf16(p) with p =
//     exp(s - m), from the staged scores, and sums the unrounded p into l;
//     the feats tile [32 frames x 512] is staged by cp.async (zeros past T
//     and D) and read into B fragments, rounded to bf16 on the way.
//   * D is masked at its ragged edge on the store (D = 500 at flagship).
//   * Sixteen warps in one block an SM (~166 KB of shared memory at
//     T = 256, at most 128 registers a thread): the tanh body wants many
//     warps an SM (kernel 1's runs 2x slower at one 8-warp block an SM
//     than at three), and a block keeps a row tile's scores and two whole
//     tiles of pre.  Splitting pre into half tiles or 256-unit passes to
//     fit three 8-warp blocks an SM ran slower on the H100.
//   * Filling the card: at the beam step the grid has B * N / 32 = 512
//     blocks, but a per-video decode step (B = 1, N = 128) has 4 for 132
//     SMs.  So the wrapper splits each row tile's live frame tiles over
//     `splits` blocks (flash-decoding), one thread-block cluster a row
//     tile: splits = min(8, ceil(T / 32), SMs // (blocks without a
//     split)), at least 1, and at least ceil(T / 512) so that a block
//     keeps the scores of at most 16 tiles (ops/kernel_attention_step
//     .fused_splits).  Split s takes the live tiles of rank
//     [s L / S, (s + 1) L / S) of the L.  Between the passes the blocks of a
//     cluster take each row's max over all of them through distributed
//     shared memory; after pass 2 each block finishes every S-th row of
//     the tile from all blocks' partial sums, out = sum_s acc_s /
//     sum_s l_s, in the same launch.  With one split, out = acc / l from
//     the registers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_body.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attention_body;
using namespace cpa;

constexpr int TR = 32;             // rows per block: 16 row pairs, two m16 tiles of the AV
constexpr int TF = 32;             // frames per tile: one mask bit per lane, the AV's K
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int PAIRS = 1;           // row pairs per warp in pass 1
constexpr int DC = 512;            // columns of D per block
constexpr int FSTR = DC + 4;       // f32 row stride of the staged feats: B reads conflict-free
constexpr int CGROUPS = WARPS / 2; // pass 2: warps a 16-row half of the block
constexpr int NTILES = DC / 8 / CGROUPS;  // n8 tiles of a warp in pass 2: 64 columns
constexpr int MAX_SPLITS = 8;      // a portable cluster
constexpr int MAX_TILES = 16;      // frame tiles whose scores a block keeps
constexpr int MAX_SMEM = 232448 - 1024;  // 227 KB, less the static arrays
constexpr float NEG = -1e30f;
static_assert(2 * PAIRS * WARPS == TR, "pass 1's warps cover the rows");
static_assert(CGROUPS * NTILES * 8 == DC, "pass 2's warps cover the block");

// dynamic shared memory: a region for pass 1's two pre buffers [2][TF][32 KH],
// then pass 2's feats [TF][FSTR] (and for a split the partial acc [TR][FSTR]);
// the scores [TR][32 tiles + 8] (tiles: a split's share, at most 16); the
// mask bits [TR][nT]; the live tiles [nT]
__host__ __device__ constexpr size_t region_bytes(int KH) {
  return 2 * sizeof(float) * TF * 32 * KH > sizeof(float) * TF * FSTR
             ? 2 * sizeof(float) * TF * 32 * KH
             : sizeof(float) * TF * FSTR;
}
__host__ __device__ constexpr int score_stride(int tiles) { return tiles * TF + 8; }
size_t smem_bytes(int KH, int nT, int tiles) {
  return region_bytes(KH) + sizeof(float) * TR * score_stride(tiles) +
         sizeof(unsigned) * TR * nT + sizeof(int) * nT;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b: a 16 x 16 bf16 (row-major fragment), b 16 x 8 bf16, c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// p = exp(s - m) of two staged scores, 0 where the frame is dead (s == NEG)
__device__ __forceinline__ float2 weights(float2 s, float m) {
  return make_float2(s.x == NEG ? 0.f : expf(s.x - m), s.y == NEG ? 0.f : expf(s.y - m));
}

template <int KH>
__global__ void __launch_bounds__(THREADS, 1)
fused_kernel(const float* __restrict__ pre, const float* __restrict__ q,
             const float* __restrict__ w, const float* __restrict__ bias,
             const float* __restrict__ mask, const float* __restrict__ feats,
             float* __restrict__ out, int N, int T, int H, int D, int splits, int tiles,
             bool vec_h, bool vec_d) {
  constexpr int CH = 32 * KH;  // hidden units staged per pass-1 stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* region = reinterpret_cast<float*>(smem);
  float* sc_s = region + region_bytes(KH) / sizeof(float);  // [TR][SCS]
  const int SCS = score_stride(tiles);
  const int nT = (T + TF - 1) / TF;
  unsigned* bits_s = reinterpret_cast<unsigned*>(sc_s + TR * SCS);  // [TR][nT]
  int* list_s = reinterpret_cast<int*>(bits_s + TR * nT);           // [nT]
  __shared__ float m_s[TR];  // this block's row max, then the cluster's
  __shared__ float l_s[TR];  // this block's row sums, for the combine
  __shared__ int nlive_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / splits * TR;
  const int d0 = blockIdx.y * DC;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* pb = pre + (size_t)b * T * H;
  const float* qb = q + (size_t)b * N * H;
  const float* mb = mask + (size_t)b * N * T;
  const float* fb = feats + (size_t)b * T * D;
  const auto row_of = [&](int p, int r) { return 2 * (warp + WARPS * p) + r; };

  // 0. bits_s[r][j], bit f: row n0 + r sees frame 32 j + f; then the tiles
  // where any row of the block is live, in order
  for (int j0 = 0; j0 < nT; j0 += 4) {
    float v[4][PAIRS][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = (j0 + u) * TF + lane, n = n0 + row_of(p, r);
          v[u][p][r] = t < T && n < N ? mb[(size_t)n * T + t] : 0.f;
        }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const unsigned live = __ballot_sync(FULL, v[u][p][r] != 0.f);
          if (lane == 0 && j0 + u < nT) bits_s[row_of(p, r) * nT + j0 + u] = live;
        }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int j0 = 0; j0 < nT; j0 += 32) {
      const int j = j0 + lane;
      unsigned any = 0u;
      if (j < nT)
        for (int r = 0; r < TR; ++r) any |= bits_s[r * nT + j];
      const unsigned live = __ballot_sync(FULL, any != 0u);
      if (any) list_s[count + __popc(live & ((1u << lane) - 1u))] = j;
      count += __popc(live);
    }
    if (lane == 0) nlive_s = count;
  }
  __syncthreads();
  const int L = nlive_s;
  const int i0 = split * L / splits, nl = (split + 1) * L / splits - i0;  // this split's tiles

  // 1. the scores of the split's tiles into sc_s, each row's max into m
  const int nH = (H + CH - 1) / CH, stages = nl * nH;
  const auto stage_pre = [&](int k) {
    const int t0 = list_s[i0 + k / nH] * TF, h0 = k % nH * CH;
    stage_tile(region + (k & 1) * TF * CH, CH, pb + (size_t)t0 * H + h0, H, TF, CH,
               min(TF, T - t0), min(CH, H - h0), vec_h, THREADS);
  };
  const float bb = bias[0];
  float m[PAIRS][2], res[PAIRS][2];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    m[p][0] = m[p][1] = NEG;
    res[p][0] = res[p][1] = 0.f;
  }
  if (stages > 0) stage_pre(0);
  cp_async_commit();
  for (int k = 0; k < stages; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // stage k has landed, and every warp is done with stage k - 1
    if (k + 1 < stages) stage_pre(k + 1);
    cp_async_commit();
    const int li = k / nH, c = k % nH, j = list_s[i0 + li];
    if (c == 0) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) res[p][0] = res[p][1] = 0.f;
    }
    float wv[KH];
    load_lane_units<KH>(w, c * CH, H, lane, wv);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const unsigned la = bits_s[row_of(p, 0) * nT + j], lc = bits_s[row_of(p, 1) * nT + j];
      if (la | lc)
        pair_scores<KH>(reinterpret_cast<const float4*>(region + (k & 1) * TF * CH), 0, qb,
                        n0 + row_of(p, 0), N, c * CH, H, lane, wv, la, lc, res[p][0],
                        res[p][1]);
    }
    if (c == nH - 1) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const unsigned live = bits_s[row_of(p, r) * nT + j];
          const float s = (live >> lane) & 1u ? res[p][r] + bb : NEG;
          sc_s[row_of(p, r) * SCS + li * TF + lane] = s;
          if (live) m[p][r] = fmaxf(m[p][r], warp_max(s));
        }
    }
  }

  // the feats of the first tile in flight while the row max is settled
  const int dv = min(DC, D - d0);
  const auto stage_feats = [&](int li) {
    const int t0 = list_s[i0 + li] * TF;
    stage_tile(region, FSTR, fb + (size_t)t0 * D + d0, D, TF, DC, min(TF, T - t0), dv, vec_d,
               THREADS);
  };
  __syncthreads();  // every warp is done with the pre buffers
  if (nl > 0) stage_feats(0);
  cp_async_commit();
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      m_s[row_of(p, 0)] = m[p][0];
      m_s[row_of(p, 1)] = m[p][1];
    }
  }
  if (splits > 1) {
    cluster.sync();
    float mx = NEG;
    if (threadIdx.x < TR)
      for (int s = 0; s < splits; ++s)
        mx = fmaxf(mx, cluster.map_shared_rank(m_s, s)[threadIdx.x]);
    cluster.sync();  // every block has read every m_s
    if (threadIdx.x < TR) m_s[threadIdx.x] = mx;
  }
  __syncthreads();

  // 2. acc = bf16(p) bf16(feats) on tensor cores, l = sum p
  const int rt = 16 * (warp / CGROUPS);            // this warp's rows rt.. rt + 15
  const int c0 = 8 * NTILES * (warp % CGROUPS);     // and columns c0.. c0 + 63
  const int g = lane >> 2, tq = lane & 3;
  const float ma = m_s[rt + g], mc = m_s[rt + g + 8];
  float acc[NTILES][4];
#pragma unroll
  for (int i = 0; i < NTILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float la = 0.f, lc = 0.f;  // this thread's part of rows rt + g and rt + g + 8's sums
  for (int li = 0; li < nl; ++li) {
    cp_async_wait<0>();
    __syncthreads();  // the tile's feats have landed
#pragma unroll
    for (int ks = 0; ks < TF / 16; ++ks) {
      const float* sa = sc_s + (rt + g) * SCS + li * TF + 16 * ks + 2 * tq;
      const float2 p0 = weights(*reinterpret_cast<const float2*>(sa), ma);
      const float2 p1 = weights(*reinterpret_cast<const float2*>(sa + 8 * SCS), mc);
      const float2 p2 = weights(*reinterpret_cast<const float2*>(sa + 8), ma);
      const float2 p3 = weights(*reinterpret_cast<const float2*>(sa + 8 * SCS + 8), mc);
      la += p0.x + p0.y + p2.x + p2.y;
      lc += p1.x + p1.y + p3.x + p3.y;
      const uint32_t A0 = bf16x2(p0.x, p0.y), A1 = bf16x2(p1.x, p1.y), A2 = bf16x2(p2.x, p2.y),
                     A3 = bf16x2(p3.x, p3.y);
      const float* fr = region + (16 * ks + 2 * tq) * FSTR + c0 + g;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const float* f = fr + 8 * nt;
        mma_bf16(acc[nt], A0, A1, A2, A3, bf16x2(f[0], f[FSTR]),
                 bf16x2(f[8 * FSTR], f[9 * FSTR]));
      }
    }
    __syncthreads();  // every warp is done with the tile's feats
    if (li + 1 < nl) stage_feats(li + 1);
    cp_async_commit();
  }
  la += __shfl_xor_sync(FULL, la, 1);
  la += __shfl_xor_sync(FULL, la, 2);
  lc += __shfl_xor_sync(FULL, lc, 1);
  lc += __shfl_xor_sync(FULL, lc, 2);
  cp_async_wait<0>();

  if (splits == 1) {
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const int col = c0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + rt + g + 8 * h;
        const float l = h ? lc : la;
        float* o = out + ((size_t)b * N + n) * D + d0 + col;
        if (n < N && col < dv) o[0] = l > 0.f ? acc[nt][2 * h] / l : 0.f;
        if (n < N && col + 1 < dv) o[1] = l > 0.f ? acc[nt][2 * h + 1] / l : 0.f;
      }
    }
    return;
  }
  // a split leaves (acc, l) in shared memory; the cluster combines them
  __syncthreads();  // the feats region is free
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) {
    const int col = c0 + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(region + (rt + g) * FSTR + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(region + (rt + g + 8) * FSTR + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  if (warp % CGROUPS == 0 && tq == 0) {
    l_s[rt + g] = la;
    l_s[rt + g + 8] = lc;
  }
  cluster.sync();
  for (int r = split; r < TR && n0 + r < N; r += splits) {
    float l = 0.f;
    for (int s = 0; s < splits; ++s) l += cluster.map_shared_rank(l_s, s)[r];
    for (int d = threadIdx.x; d < dv; d += THREADS) {
      float v = 0.f;
      for (int s = 0; s < splits; ++s) v += cluster.map_shared_rank(region, s)[r * FSTR + d];
      out[((size_t)b * N + n0 + r) * D + d0 + d] = l > 0.f ? v / l : 0.f;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int KH>
int launch_fused(const float* pre, const float* q, const float* w, const float* b,
                 const float* mask, const float* feats, float* out, int B, int N, int T, int H,
                 int D, int splits, cudaStream_t stream) {
  const int nT = (T + TF - 1) / TF;
  const int tiles = (nT + splits - 1) / splits;  // at most this many live tiles a split
  const size_t smem = smem_bytes(KH, nT, tiles);
  if (tiles > MAX_TILES || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<KH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_h = H % 4 == 0 && aligned(pre);
  const bool vec_d = D % 4 == 0 && aligned(feats);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + TR - 1) / TR * splits, (D + DC - 1) / DC, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_kernel<KH>, pre, q, w, b, mask, feats, out, N, T, H, D,
                           splits, tiles, vec_h, vec_d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T], feats [B, T, D]
// -> out [B, N, D]; all f32, contiguous, on the device of `stream`.  Each
// 32-row tile's live frame tiles are split over `splits` (1-8) blocks of
// one cluster, each keeping the scores of at most 32 tiles.  The hidden
// units are staged 128 at a time for H <= 128, else 256.
extern "C" int echr_attention_fused_splits(const void* pre, const void* q, const void* w,
                                           const void* b, const void* mask, const void* feats,
                                           void* out, int B, int N, int T, int H, int D,
                                           int splits, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(pre);
  const auto* qq = static_cast<const float*>(q);
  const auto* ww = static_cast<const float*>(w);
  const auto* bb = static_cast<const float*>(b);
  const auto* m = static_cast<const float*>(mask);
  const auto* f = static_cast<const float*>(feats);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 128) return launch_fused<4>(p, qq, ww, bb, m, f, o, B, N, T, H, D, splits, s);
  if (H <= 256) return launch_fused<8>(p, qq, ww, bb, m, f, o, B, N, T, H, D, splits, s);
  return launch_fused<16>(p, qq, ww, bb, m, f, o, B, N, T, H, D, splits, s);
}
