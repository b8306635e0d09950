// Sorted run-sum of (id, row) pairs (K6), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jagged_lookup/kernel.py:
// runsum_pallas (body _runsum_kernel): over (id, row) pairs sorted by id,
// the total of each run of equal ids. The TPU kernel left the total at the
// run's last slot (and running partial sums elsewhere, which its consumers
// never read); here run r's total is written at row r, so the output is
// the unique (id, row) pairs the sparse optimizer takes, with no zero rows
// and no second compaction pass. A run of dropped ids (keyed at or above
// drop_key) totals zero.
//
// What bounds it on this card: memory. It reads each row once and writes
// one row per run (4 bytes per element read, fp32, 4 per element written)
// and adds once per element, far below the fp32 rate, so it is bound by
// bytes at 3.35 TB/s.
//
// What the design does about it:
// - The TPU grid walked the sorted pairs in order, one row per step, and
//   carried the sum in scratch. Here the run pointers (starts, built on
//   the device from is_start / cumsum) split the sorted list, and each CTA
//   takes whole runs in turn (run r, r + gridDim.x, ...): a grid-stride
//   loop over a run count read from device memory, so the host never
//   waits for it, and a few thousand resident CTAs balance runs of 1 row
//   (most negatives) against runs of thousands (popular ids) without
//   giving any block a fixed slice of rows.
// - Within a run the CTA is parallel over D: each thread owns 4 columns
//   (one 16-byte load per row), adds the run's rows in sorted order, and
//   writes the total once, at row r.
// - The rows are read through the sort permutation (`order`), so the
//   sorted copy of the rows is never built in device memory.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
runsum_kernel(const float* __restrict__ rows,
              const long long* __restrict__ order,
              const int* __restrict__ sids, const int* __restrict__ starts,
              const int* __restrict__ num_runs, float* __restrict__ out,
              int D, int drop_key) {
  const int runs = *num_runs;
  const int D4 = D / 4;
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    const int s0 = starts[r];
    const int s1 = starts[r + 1];
    const bool drop = sids[s0] >= drop_key;
    for (int c = threadIdx.x; c < D4; c += THREADS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 zero = acc;
#pragma unroll 4
      for (int i = s0; i < s1; ++i) {
        const float4 x = reinterpret_cast<const float4*>(
            rows + (size_t)order[i] * D)[c];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      reinterpret_cast<float4*>(out + (size_t)r * D)[c] = drop ? zero : acc;
    }
  }
}

}  // namespace

// rows (n_rows, D) float32, order (n,) int64 (rows[order[i]] is the i-th
// pair in sorted order), sids (n,) int32 sorted ids, starts (n + 1,) int32
// (starts[r] the first slot of run r, starts[num_runs] == n), num_runs (1,)
// int32 on the device; out (at least num_runs, D) float32: run r's total
// at row r. D % 4 == 0 and 16-byte aligned rows. `ctas` CTAs take the runs
// in turn. Returns the launch's cudaError_t.
extern "C" int runsum(const float* rows, const long long* order,
                      const int* sids, const int* starts, const int* num_runs,
                      float* out, int n, int D, int drop_key,
                      int ctas, void* stream) {
  if (n <= 0 || D <= 0 || D % 4 != 0 || ctas <= 0)
    return (int)cudaErrorInvalidValue;
  runsum_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, order, sids, starts, num_runs, out, D, drop_key);
  return (int)cudaGetLastError();
}
