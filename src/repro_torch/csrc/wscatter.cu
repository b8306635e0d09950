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
// What the design does about it. The first version gave one CTA to each
// run, and every run began with a chain of dependent loads (starts[r] ->
// sids -> order -> w -> the row) while 0.88 of the runs are one row: the
// CTA waited on the chain for 4 KB of output. Now:
// - A CTA takes a tile of RT consecutive runs (grid-stride over tiles, a
//   run count read from device memory, so the host never waits for it).
//   It stages the tile's run pointers once; each warp then takes RPW
//   consecutive runs of the tile and stages, with cp.async, the sorted
//   slots (`order`) of its short runs and then the negative slots' weights
//   into shared memory, all lanes at once: three dependent latencies per
//   tile instead of five per run.
// - Short runs (at most WARP_MAX rows, and the dropped run, which reads
//   nothing) go one per warp: a lane owns 32 of each 1024 columns, as
//   float4 columns lane + 32 k so that each load and store of the warp is
//   one contiguous 512-byte (fp32) or 256-byte (bf16) span, and starts
//   all of a row's loads of a pass (512 columns) at once; the next row of
//   the warp's runs is loaded before the current one is added, across
//   run boundaries.
// - Longer runs go to the whole CTA after the warps are done, split over
//   columns (one float4 column per thread), with their slots' order and
//   weights staged 2048 at a time, so that a thread's chain per row is
//   the row's load alone. The grid is no larger than the card holds at
//   once, so no tile with a long run starts after the others are done.
// - The fp32 totals are written with streaming stores (__stcs), and the
//   ready rows read with streaming loads (__ldcs), so the ~3.8 GB that
//   pass once do not push o out of L2.
// - Each column of a run is summed in sorted slot order, from 0, each
//   product rounded before it is added (__fmul_rn, __fadd_rn: no
//   contraction into an FMA), in the two-pass path's order w · (o ·
//   scale), so the totals equal the two-pass rows summed by K6, bit for
//   bit, and are the same from run to run. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 64;             // runs per tile
constexpr int RPW = RT / WARPS;    // runs per warp: 8
constexpr int WARP_MAX = 32;       // the longest run a warp takes
constexpr int CPL = 4;             // float4 columns per lane per pass
constexpr int PASS4 = 32 * CPL;    // float4 columns per warp pass: 512 cols
constexpr int LONG = -1;           // s_mode of a run for the CTA path
constexpr int LCH = WARPS * RPW * WARP_MAX;  // long-run slots staged: 2048
constexpr int LP = 8;              // long-run rows in flight per thread

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One slot's row as a lane holds it, raw: CPL float4 columns c0 + lane +
// 32 k (4 bf16 in r[k].x/.y, or 4 fp32 in r[k]).
struct Raw {
  uint4 r[CPL];
  float w;
  bool neg;
};

template <typename OT>
__device__ __forceinline__ void load_slot(Raw& x, long long j, float wj,
                                          const OT* __restrict__ o,
                                          const float* __restrict__ extra,
                                          int n_neg, int R, int D, int c0,
                                          int lane) {
  x.neg = j < n_neg;
  x.w = wj;
  const int D4 = D / 4;
  if (x.neg) {
    const OT* row = o + (size_t)((int)j / R) * D;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < D4) {
        if constexpr (sizeof(OT) == 2) {
          const uint2 h = __ldg(reinterpret_cast<const uint2*>(row) + c);
          x.r[k].x = h.x;
          x.r[k].y = h.y;
        } else {
          x.r[k] = __ldg(reinterpret_cast<const uint4*>(row) + c);
        }
      }
    }
  } else {
    const float4* row =
        reinterpret_cast<const float4*>(extra + (size_t)(j - n_neg) * D);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < D4) {
        const float4 a = __ldcs(row + c);
        x.r[k] = *reinterpret_cast<const uint4*>(&a);
      }
    }
  }
}

template <typename OT>
__device__ __forceinline__ void add_slot(float (&acc)[4 * CPL], const Raw& x,
                                         float scale, int D, int c0,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (c0 + lane + 32 * k >= D / 4) continue;
    float v[4];
    if (x.neg && sizeof(OT) == 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.r[k].x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.r[k].y));
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(&x.r[k]);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t =
          x.neg ? __fmul_rn(x.w, __fmul_rn(v[e], scale)) : v[e];
      acc[4 * k + e] = __fadd_rn(acc[4 * k + e], t);
    }
  }
}

template <typename OT>
__global__ void __launch_bounds__(THREADS, 2)
wscatter_kernel(const OT* __restrict__ o, const float* __restrict__ w,
                const float* __restrict__ extra,
                const long long* __restrict__ order,
                const int* __restrict__ sids, const int* __restrict__ starts,
                const int* __restrict__ num_runs, float* __restrict__ out,
                int n_neg, int R, int D, float scale, int drop_key) {
  __shared__ int st[RT + 1];          // the tile's run pointers
  __shared__ int s_mode[RT];          // rows to add, or LONG
  __shared__ long long s_ord[WARPS][RPW][WARP_MAX];
  __shared__ float s_w[WARPS][RPW][WARP_MAX];
  const int runs = *num_runs;
  const int D4 = D / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr0 = warp * RPW;         // the warp's first run in the tile

  for (int r0 = blockIdx.x * RT; r0 < runs; r0 += gridDim.x * RT) {
    const int nr = min(RT, runs - r0);
    for (int j = threadIdx.x; j <= RT; j += THREADS)
      st[j] = starts[r0 + min(j, nr)];
    __syncthreads();

    // ---- each warp: classify and stage its runs ----
    int mode = LONG, beg = 0;
    if (lane < RPW && wr0 + lane < nr) {
      beg = st[wr0 + lane];
      const int len = st[wr0 + lane + 1] - beg;
      if (sids[beg] >= drop_key)
        mode = 0;                     // reads nothing, totals zero
      else if (len <= WARP_MAX)
        mode = len;
      s_mode[wr0 + lane] = mode;
    }
#pragma unroll
    for (int jj = 0; jj < RPW; ++jj) {
      const int m = __shfl_sync(0xffffffffu, mode, jj);
      const int b = __shfl_sync(0xffffffffu, beg, jj);
      if (lane < m) cp_async8(&s_ord[warp][jj][lane], order + b + lane);
    }
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < RPW; ++jj) {
      const int m = __shfl_sync(0xffffffffu, mode, jj);
      if (lane < m) {
        const long long j = s_ord[warp][jj][lane];
        if (j < n_neg) cp_async4(&s_w[warp][jj][lane], w + j);
      }
    }
    cp_async_wait_all();
    __syncwarp();

    // ---- each warp: its short runs, one after another, the next slot's
    // row in flight while the current one is added; a pass per 512
    // columns ----
    const int nw = max(0, min(RPW, nr - wr0));
    for (int c0 = 0; c0 < D4; c0 += PASS4) {
      int pj = 0, pi = 0;             // the next (run, slot) to load
      auto skip = [&]() {
        while (pj < nw && pi >= max(s_mode[wr0 + pj], 0)) {
          ++pj;
          pi = 0;
        }
      };
      Raw cur, nxt;
      skip();
      if (pj < nw) {
        load_slot<OT>(cur, s_ord[warp][pj][pi], s_w[warp][pj][pi], o, extra,
                      n_neg, R, D, c0, lane);
        ++pi;
        skip();
      }
      for (int jj = 0; jj < nw; ++jj) {
        const int m = s_mode[wr0 + jj];
        if (m == LONG) continue;
        float acc[4 * CPL];
#pragma unroll
        for (int e = 0; e < 4 * CPL; ++e) acc[e] = 0.0f;
        for (int i = 0; i < m; ++i) {
          if (pj < nw) {
            load_slot<OT>(nxt, s_ord[warp][pj][pi], s_w[warp][pj][pi], o,
                          extra, n_neg, R, D, c0, lane);
            ++pi;
            skip();
          }
          add_slot<OT>(acc, cur, scale, D, c0, lane);
          cur = nxt;
        }
        float4* row = reinterpret_cast<float4*>(
            out + (size_t)(r0 + wr0 + jj) * D);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < D4)
            __stcs(row + c, make_float4(acc[4 * k], acc[4 * k + 1],
                                        acc[4 * k + 2], acc[4 * k + 3]));
        }
      }
    }
    __syncthreads();                  // s_mode of every warp is written

    // ---- the whole CTA: the tile's long runs, over columns; the slots'
    // order and weights staged LCH at a time (in the warps' staging
    // space), so that a thread's chain per row is the row's load alone ----
    long long* l_ord = &s_ord[0][0][0];
    float* l_w = &s_w[0][0][0];
    for (int j = 0; j < nr; ++j) {
      if (s_mode[j] != LONG) continue;  // uniform in the CTA
      const int s0 = st[j], s1 = st[j + 1];
      for (int cb = 0; cb < D4; cb += THREADS) {
        const int c = cb + threadIdx.x;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int cs = s0; cs < s1; cs += LCH) {
          const int n = min(LCH, s1 - cs);
          __syncthreads();              // the last chunk's readers are done
          for (int i = threadIdx.x; i < n; i += THREADS)
            cp_async8(l_ord + i, order + cs + i);
          cp_async_wait_all();
          __syncthreads();
          for (int i = threadIdx.x; i < n; i += THREADS)
            if (l_ord[i] < n_neg) cp_async4(l_w + i, w + l_ord[i]);
          cp_async_wait_all();
          __syncthreads();
          if (c < D4) {
            // LP rows' loads started together, then added in order
            for (int i0 = 0; i0 < n; i0 += LP) {
              uint4 raw[LP];
#pragma unroll
              for (int p = 0; p < LP; ++p) {
                const long long js = i0 + p < n ? l_ord[i0 + p] : 0;
                if (i0 + p < n && js < n_neg) {
                  const OT* row = o + (size_t)((int)js / R) * D;
                  if constexpr (sizeof(OT) == 2) {
                    const uint2 h =
                        __ldg(reinterpret_cast<const uint2*>(row) + c);
                    raw[p] = make_uint4(h.x, h.y, 0u, 0u);
                  } else {
                    raw[p] = __ldg(reinterpret_cast<const uint4*>(row) + c);
                  }
                } else if (i0 + p < n) {
                  const float4 f = __ldcs(reinterpret_cast<const float4*>(
                                              extra + (size_t)(js - n_neg) *
                                                          D) + c);
                  raw[p] = *reinterpret_cast<const uint4*>(&f);
                }
              }
#pragma unroll
              for (int p = 0; p < LP; ++p) {
                if (i0 + p < n) {
                  const long long js = l_ord[i0 + p];
                  float4 x = *reinterpret_cast<const float4*>(&raw[p]);
                  if (js < n_neg) {
                    float4 v = x;
                    if constexpr (sizeof(OT) == 2) {
                      const float2 lo = __bfloat1622float2(
                          *reinterpret_cast<const __nv_bfloat162*>(
                              &raw[p].x));
                      const float2 hi = __bfloat1622float2(
                          *reinterpret_cast<const __nv_bfloat162*>(
                              &raw[p].y));
                      v = make_float4(lo.x, lo.y, hi.x, hi.y);
                    }
                    const float wj = l_w[i0 + p];
                    x.x = __fmul_rn(wj, __fmul_rn(v.x, scale));
                    x.y = __fmul_rn(wj, __fmul_rn(v.y, scale));
                    x.z = __fmul_rn(wj, __fmul_rn(v.z, scale));
                    x.w = __fmul_rn(wj, __fmul_rn(v.w, scale));
                  }
                  acc.x = __fadd_rn(acc.x, x.x);
                  acc.y = __fadd_rn(acc.y, x.y);
                  acc.z = __fadd_rn(acc.z, x.z);
                  acc.w = __fadd_rn(acc.w, x.w);
                }
              }
            }
          }
        }
        if (c < D4)
          __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + j) * D) + c,
                 acc);
      }
    }
    __syncthreads();                  // st and s_mode are reused
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
// 16-byte aligned rows (8-byte for bf16 o). At most `ctas` CTAs, and no
// more than are resident at once, take the tiles of 64 runs in turn.
// Returns the first cudaError_t.
extern "C" int wscatter(const void* o, const float* w, const float* extra,
                        const long long* order, const int* sids,
                        const int* starts, const int* num_runs, float* out,
                        int n_neg, int n, int R, int D, int o_code,
                        int drop_key, int ctas, float scale, void* stream) {
  if (n <= 0 || n_neg < 0 || n_neg > n || R <= 0 || D <= 0 || D % 4 != 0
      || ctas <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // no more CTAs than are resident at once: a late CTA must not start a
  // tile with a long run after the others are done
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = o_code == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, wscatter_kernel<__nv_bfloat16>, THREADS, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, wscatter_kernel<float>, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  ctas = max(1, min(ctas, sms * per_sm));
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
