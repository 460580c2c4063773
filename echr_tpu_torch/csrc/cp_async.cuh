// cp.async (sm_80+) for the kernels that stage tiles in shared memory
// without TMA: kernels 5, 6, 9, 10 and 11 (attention_fused.cu,
// windowed_attention.cu, probe_score_overlap.cu, lstm_recurrence.cu).  A copy whose source is
// not valid reads nothing and writes zeros, so a ragged edge needs no
// other masking.
#pragma once

#include <cstdint>

namespace cpa {

// 16 bytes from global to shared; zeros, and no read, where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes, for rows whose length or start is not a multiple of 4 floats
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the newest K of this thread has landed
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// A [rows, cols] f32 tile to shared memory (row stride dst_stride floats)
// from src (row stride src_stride), by all `threads` threads of the block:
// entries at row >= rows_valid or col >= cols_valid are zeros.  cols is a
// multiple of 4.  With vec (src 16-byte aligned, src_stride and
// cols_valid multiples of 4) in 16-byte copies, else in 4-byte ones.
// Issues the copies only; the caller commits and waits.
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride, const float* src,
                                           int src_stride, int rows, int cols, int rows_valid,
                                           int cols_valid, bool vec, int threads) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec) {
    const int c4 = cols / 4;
    for (int i = threadIdx.x; i < rows * c4; i += threads) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async16(base + 4u * (r * dst_stride + c), ok ? src + (size_t)r * src_stride + c : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += threads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async4(base + 4u * (r * dst_stride + c), ok ? src + (size_t)r * src_stride + c : src,
                ok);
    }
  }
}

}  // namespace cpa
