// The tanh of kernels 1 and 3-6 (csrc/attention_body.cuh, which
// attention_scores.cu and attention_fused.cu run, attention_scores_bwd.cu,
// windowed_attention.cu) and 9-10 (probe_score_overlap.cu).
//
// tanh |x| = (1 - e) / (1 + e) with e = 2^(-2 |x| log2 e), and the sign of x:
// 7 instructions, two of them on the special-function unit (ex2, rcp).  CUDA's
// accurate tanhf takes 15: built without fast math it evaluates both of its
// paths, a polynomial for |x| < 0.6 and 1 - 2 / (2^(2 |x| log2 e) + 1) above,
// with the same ex2 and rcp, each time.  1 - e is exact for e in [1/2, 1], so
// the error stays absolute near 0: at most 1.36e-7 from float64 over
// [-10, 10] and +-[1e-38, 1] on an H100 (chip_smoke.py phase 2), within
// 2 ulp of 1.0.  experiments/probe_tanh.py compares it with tanhf.
#pragma once

__device__ __forceinline__ float echr_tanh(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-2.8853900817779268f * fabsf(x)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return copysignf((1.f - e) * r, x);
}
