// Weighted run-sum scatter of sorted (id, slot) pairs (K5), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jagged_lookup/kernel.py:
// weighted_runsum_scatter (body _wscatter_kernel): over slots sorted by
// destination id, the total per id of the grad rows w[slot] · (o[src] ·
// scale), each row generated inside the kernel, so the (T·R, D) rows of
// the negative path's table gradient are never written to device memory.
// The TPU kernel flushed each run's total to row `id` of a (V + 1, D)
// array; here run r's total is written at row r, as K6 (runsum.cu) does,
// so the output is the unique (id, row) pairs the sparse optimizer takes.
// The step's ready rows (the input and label rows) join the same sorted
// stream: slot j < n_neg is the negative row w[j] · (float(o[j / R]) ·
// scale), slot j >= n_neg the fp32 row extra[j - n_neg]. A run of dropped
// ids (keyed at or above drop_key) totals zero.
//
// What bounds it on this card: memory. It writes one fp32 row per run
// (~0.93 M rows of 4 KB at the hstu-large training shape) and reads the
// indices, the weights and the ready rows once; o is bf16 (T, 1024), 16.8
// MB, and stays in the 50 MB L2, so the per-slot row reads mostly hit L2.
// Three operations per element of a negative slot are far below the fp32
// rate, so it is bound by bytes at 3.35 TB/s.
//
// What the design does about it:
// - K6's skeleton: the run pointers (starts, built on the device) split
//   the sorted slots, and each CTA takes whole runs in turn (run r,
//   r + gridDim.x, ...), a grid-stride loop over a run count read from
//   device memory, so the host never waits for it; no atomics.
// - Within a run the CTA is parallel over D: each thread owns 4 columns
//   and adds the run's rows in sorted order, starting from 0, writing the
//   total once.
// - Each product is rounded before it is added (__fmul_rn, __fadd_rn: no
//   contraction into an FMA), in the two-pass path's order w · (o · scale),
//   so the totals equal the two-pass rows summed by K6, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float4 load4(const float* row, int c) {
  return reinterpret_cast<const float4*>(row)[c];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c) {
  const uint2 raw = reinterpret_cast<const uint2*>(row)[c];
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename OT>
__global__ void __launch_bounds__(THREADS)
wscatter_kernel(const OT* __restrict__ o, const float* __restrict__ w,
                const float* __restrict__ extra,
                const long long* __restrict__ order,
                const int* __restrict__ sids, const int* __restrict__ starts,
                const int* __restrict__ num_runs, float* __restrict__ out,
                int n_neg, int R, int D, float scale, int drop_key) {
  const int runs = *num_runs;
  const int D4 = D / 4;
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    const int s0 = starts[r];
    const int s1 = sids[s0] >= drop_key ? s0 : starts[r + 1];
    for (int c = threadIdx.x; c < D4; c += THREADS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = s0; i < s1; ++i) {
        const long long j = order[i];
        float4 x;
        if (j < n_neg) {
          const float wj = w[j];
          const float4 v = load4(o + (size_t)((int)j / R) * D, c);
          x.x = __fmul_rn(wj, __fmul_rn(v.x, scale));
          x.y = __fmul_rn(wj, __fmul_rn(v.y, scale));
          x.z = __fmul_rn(wj, __fmul_rn(v.z, scale));
          x.w = __fmul_rn(wj, __fmul_rn(v.w, scale));
        } else {
          x = load4(extra + (size_t)(j - n_neg) * D, c);
        }
        acc.x = __fadd_rn(acc.x, x.x);
        acc.y = __fadd_rn(acc.y, x.y);
        acc.z = __fadd_rn(acc.z, x.z);
        acc.w = __fadd_rn(acc.w, x.w);
      }
      reinterpret_cast<float4*>(out + (size_t)r * D)[c] = acc;
    }
  }
}

}  // namespace

// o (T, D) float32 (o_code 0) or bfloat16 (o_code 1); w (>= n_neg,)
// float32, slot j < n_neg weighting row j / R of o; extra (n - n_neg, D)
// float32, the ready rows of the slots from n_neg on; order (n,) int64
// (slot order[i] is the i-th in sorted order); sids (n,) int32 sorted ids;
// starts (n + 1,) int32 (starts[r] the first sorted slot of run r,
// starts[num_runs] == n) and num_runs (1,) int32 on the device; out (at
// least num_runs, D) float32: run r's total at row r. D % 4 == 0 and
// 16-byte aligned rows (8-byte for bf16 o). `ctas` CTAs take the runs in
// turn. Returns the launch's cudaError_t.
extern "C" int wscatter(const void* o, const float* w, const float* extra,
                        const long long* order, const int* sids,
                        const int* starts, const int* num_runs, float* out,
                        int n_neg, int n, int R, int D, int o_code,
                        int drop_key, int ctas, float scale, void* stream) {
  if (n <= 0 || n_neg < 0 || n_neg > n || R <= 0 || D <= 0 || D % 4 != 0
      || ctas <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o_code == 0) {
    wscatter_kernel<float><<<ctas, THREADS, 0, s>>>(
        static_cast<const float*>(o), w, extra, order, sids, starts,
        num_runs, out, n_neg, R, D, scale, drop_key);
  } else if (o_code == 1) {
    wscatter_kernel<__nv_bfloat16><<<ctas, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), w, extra, order, sids, starts,
        num_runs, out, n_neg, R, D, scale, drop_key);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
