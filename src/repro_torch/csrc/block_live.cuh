// The dense-grid liveness test shared by K8-fwd (jagged_attn_fwd.cu) and
// K8-bwd (jagged_attn_bwd.cu): the TPU kernel's _block_live
// (src/repro/kernels/jagged_attention/kernel.py:227), on the plan's
// per-block segment ranges seg_rng (nb, 2) = (lowest valid segment, highest
// segment) of each 128-token block.
#pragma once

// Does the (q-block qb, k-block kb) pair hold a live token pair? Packed
// segments are contiguous, so intersecting [lo, hi] ranges share a segment;
// with equal q and k blocks the causal band (qb+1)*b-1 >= kb*b is qb >= kb,
// which the acausal mask (CAUSAL false) does not ask.
template <bool CAUSAL>
__device__ __forceinline__ bool block_live(const int* __restrict__ seg_rng,
                                           int qb, int kb) {
  const int qlo = seg_rng[2 * qb], qhi = seg_rng[2 * qb + 1];
  const int klo = seg_rng[2 * kb], khi = seg_rng[2 * kb + 1];
  return qlo <= khi && klo <= qhi && qhi >= 0 && khi >= 0 &&
         (!CAUSAL || qb >= kb);
}
