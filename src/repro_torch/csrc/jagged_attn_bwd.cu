// Jagged pointwise attention + RAB, backward (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/jagged_attention/kernel.py:
// bwd_pallas_wl, i.e. _bwd_kv_kernel_wl (k-major: dk, dv) and
// _bwd_q_kernel_wl (q-major: dq and the grads of pos_table and
// time_table, or of FuXi's functional (amp, sigma, rho)), both recomputing
// (a, ds) as _recompute_block does:
//   s  = q.k^T * scale + pos_table[clip(i-j)] + time bias
//   mw = [same row, key at or before query] / (pos+1)
//   a  = SiLU(s) * mw                      (fp32; the forward's rounding of
//                                           a to v's dtype passes straight
//                                           through, as on the TPU)
//   ds = (dy.v^T) * SiLU'(s) * mw
//   dv += a^T.dy,  dk += ds^T.q * scale,  dq += ds.k * scale
//   d pos_table[b] += ds over the pairs in position bucket b (a sum over
//   diagonals), and, by the time mode (a template parameter):
//   bucket      d time_table[b] += ds over the pairs in time bucket b;
//   functional  with E = exp(-z^rho), z = (|tq-tk| + 1e-6) / sigma and
//               bias = amp * E (_functional_time_grads, kernel.py:183):
//               d amp += ds * E, d sigma += ds * amp*E*rho*z^rho/sigma,
//               d rho += -ds * amp*E*z^rho*ln z.
// The score arithmetic is K1-fwd's (jagged_attn_fwd.cu), and the time
// bias is the same code (time_bias.cuh): fp32, true divisions, the precise
// logf/expf.
//
// What bounds it on this card: the work needs 10 * 128^2 * D flops per
// live block pair and head (s, dy.v^T, dv, dk and dq, 2 * 128^2 * D each)
// against six 128 x D tiles read; this design does 14, since the dk/dv
// and the dq kernel each recompute s and dy.v^T. Each entry also needs
// SiLU's special functions and the time bias's (counted from the function
// by chip_smoke.py, which states the binding bound). As K1-fwd, this
// first version runs its products in fp32 FMA on the CUDA cores
// (67 TFLOP/s), so it is bound by operations, far from either bound.
//
// What the design does about the TPU's sequential grid:
// - The work-lists are read as CSR runs: one CTA per (64-key chunk of a
//   k-block, head, pack) walks kv_rowptr for dk/dv; one CTA per (64-row
//   chunk of a q-block, head, pack) walks q_rowptr for dq. Each keeps its
//   accumulators in registers over its whole run and writes once, zeros
//   for an empty run.
// - Registers: two 128 x 128 fp32 accumulators (dk, dv) per CTA do not fit
//   as K1-fwd's one did, so the keys are sub-tiled: a CTA owns 64 keys
//   (two CTAs per k-block), 64 x D of dk and of dv, 32 floats each per
//   thread at D = 128. The dq CTA likewise owns 64 query rows. Queries and
//   keys stream through shared memory in 64-row chunks.
// - The TPU accumulates the RAB-table grads in windows that persist over
//   the whole grid. Here each dq CTA reduces its own (npb + ntb) partial
//   for its head in shared memory, every bucket owned by one thread and
//   summed in a fixed order (diagonal sums for positions, per-row then
//   per-bucket sums for times), and writes it to its own slot; a third
//   kernel sums the slots in a fixed order. No atomics: the result is the
//   same from run to run. The functional mode's three sums take the place
//   of the time buckets (a partial of npb + 3): each thread sums its
//   entries of a row, a fixed shuffle tree sums the row's 16 threads, and
//   the rows are summed in order. E * z^rho is taken as 0 where E
//   underflows to 0 (z^rho may be inf there), so a masked entry, whose ds
//   is 0, adds exactly 0.
//
// K8-bwd, the dense-grid schedule, is a launch variant of these kernels
// (`dense` set). It replaces bwd_pallas (bodies _bwd_kv_kernel and
// _bwd_q_kernel, kernel.py:696), whose (nb, nb) grids skip dead pairs by
// _block_live and whose dq kernel accumulates the table grads across the
// whole grid. Each CTA loops over every block of its other axis instead of
// its work-list run, testing each live on the plan's per-block segment
// ranges (block_live.cuh): the same live blocks in the same ascending
// order, so K8 gives K2's bits on the same plan. The table grads keep K2's
// per-CTA partials and their fixed-order sum, so no CTA depends on another.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "block_live.cuh"
#include "time_bias.cuh"

namespace {

constexpr int MAX_DEVICES = 64;

constexpr int BLK = 128;      // the plan's block
constexpr int CH = 64;        // query / key rows per chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr int RPT = CH / 16;  // rows (and score columns) per thread: 4

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory, in 4-byte words, for both kernels.
template <int D>
__host__ __device__ constexpr size_t smem_words_fixed() {
  return 4 * (size_t)CH * (D + 1)     // q, dy, k, v chunks
         + 3 * (size_t)CH * (CH + 1)  // a, ds, time bucket per entry
         + 2 * CH                     // diagonal sums
         + 5 * CH;                    // q seg/ts/1/n, k seg/ts
}

__host__ __device__ inline size_t smem_words_var(int npb, int ntb) {
  return (size_t)(npb + ntb)       // bias tables
         + (size_t)(npb + ntb)     // this CTA's RAB-grad partial
         + (size_t)CH * ntb;       // per-row time-bucket sums
}

struct Smem {
  float *q, *dy, *k, *v, *a, *ds, *diag, *qninv, *pt, *tt, *part, *rowpart;
  int *tb, *qseg, *qts, *kseg, *kts;
};

template <int D>
__device__ Smem carve(float* smem, int npb, int ntb) {
  Smem s;
  s.q = smem;
  s.dy = s.q + CH * (D + 1);
  s.k = s.dy + CH * (D + 1);
  s.v = s.k + CH * (D + 1);
  s.a = s.v + CH * (D + 1);
  s.ds = s.a + CH * (CH + 1);
  s.tb = reinterpret_cast<int*>(s.ds + CH * (CH + 1));
  s.diag = reinterpret_cast<float*>(s.tb + CH * (CH + 1));
  s.qseg = reinterpret_cast<int*>(s.diag + 2 * CH);
  s.qts = s.qseg + CH;
  s.qninv = reinterpret_cast<float*>(s.qts + CH);
  s.kseg = reinterpret_cast<int*>(s.qninv + CH);
  s.kts = s.kseg + CH;
  s.pt = reinterpret_cast<float*>(s.kts + CH);
  s.tt = s.pt + npb;
  s.part = s.tt + ntb;
  s.rowpart = s.part + npb + ntb;
  return s;
}

// CH rows of one head, starting at token slot `slot0` of the pack, into a
// padded fp32 tile.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* __restrict__ src,
                          size_t slot0, int H, int h) {
  const size_t row_stride = (size_t)H * D;
  for (int i = threadIdx.x; i < CH * D; i += THREADS) {
    int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        to_f32(src[(slot0 + r) * row_stride + (size_t)h * D + d]);
  }
}

// The (a, ds) tile of one (query chunk at slot q0, key chunk at slot
// key0) pair into shared memory, rows = queries, cols = keys. With
// `time_grads`, what the time grads need: in the bucket mode each entry's
// time bucket (sm.tb); in the functional mode (FUNC) each row's sums of
// ds * d bias / d(amp, sigma, rho) over the tile's keys (sm.rowpart, 3 per
// row).
template <int D, bool FUNC>
__device__ void recompute_tile(const Smem& sm, int q0, int key0, float scale,
                               float tb_denom, int npb, int ntb, int use_pos,
                               int use_time, bool keep_a, bool time_grads) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[RPT][RPT], da[RPT][RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) s[i][j] = da[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float qv[RPT], dyv[RPT], kv[RPT], vv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = sm.q[(ty + 16 * i) * (D + 1) + d];
      dyv[i] = sm.dy[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      kv[j] = sm.k[(tx + 16 * j) * (D + 1) + d];
      vv[j] = sm.v[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        da[i][j] = fmaf(dyv[i], vv[j], da[i][j]);
      }
  }
  // the head's functional time parameters and the per-head factors of
  // d bias / d sigma (amp * rho / sigma) and d bias / d rho (-amp)
  float amp = 0.0f, sigma = 1.0f, rho = 1.0f, c_sig = 0.0f, c_rho = 0.0f;
  if constexpr (FUNC) {
    amp = sm.tt[0];
    sigma = sm.tt[1];
    rho = sm.tt[2];
    c_sig = __fdiv_rn(__fmul_rn(amp, rho), sigma);
    c_rho = -amp;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const int qslot = q0 + r;
    const int qseg = sm.qseg[r];
    const int qts = sm.qts[r];
    const float qninv = sm.qninv[r];
    float g_amp = 0.0f, g_sig = 0.0f, g_rho = 0.0f;  // this row's sums
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int c = tx + 16 * j;
      const int kslot = key0 + c;
      float bias = 0.0f;
      if (use_pos) bias += sm.pt[min(max(qslot - kslot, 0), npb - 1)];
      int tb = 0;
      float E = 0.0f, zr = 0.0f, lnz = 0.0f;
      if (use_time) {
        if constexpr (FUNC) {
          E = functional_E(qts, sm.kts[c], sigma, rho, zr, lnz);
          bias += __fmul_rn(amp, E);
        } else {
          tb = time_bucket(qts, sm.kts[c], tb_denom, ntb);
          bias += sm.tt[tb];
        }
      }
      const float x = s[i][j] * scale + bias;
      const bool live = qseg == sm.kseg[c] && qseg >= 0 && qslot >= kslot;
      const float mw = live ? qninv : 0.0f;
      const float sig = 1.0f / (1.0f + expf(-x));
      if (keep_a) sm.a[r * (CH + 1) + c] = x * sig * mw;
      const float ds = da[i][j] * (sig * (1.0f + x * (1.0f - sig))) * mw;
      sm.ds[r * (CH + 1) + c] = ds;
      if constexpr (FUNC) {
        if (time_grads && use_time) {
          const float ezr = E == 0.0f ? 0.0f : __fmul_rn(E, zr);
          g_amp += ds * E;
          g_sig += ds * __fmul_rn(ezr, c_sig);
          g_rho += ds * __fmul_rn(__fmul_rn(ezr, lnz), c_rho);
        }
      } else {
        if (time_grads) sm.tb[r * (CH + 1) + c] = tb;
      }
    }
    if constexpr (FUNC) {
      if (time_grads && use_time) {
        // the row's 64 keys lie with the 16 threads of one half-warp
        // (tx = 0..15): a fixed shuffle tree, then one write per row
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          g_amp += __shfl_xor_sync(0xffffffffu, g_amp, off);
          g_sig += __shfl_xor_sync(0xffffffffu, g_sig, off);
          g_rho += __shfl_xor_sync(0xffffffffu, g_rho, off);
        }
        if (tx == 0) {
          sm.rowpart[r * 3 + 0] = g_amp;
          sm.rowpart[r * 3 + 1] = g_sig;
          sm.rowpart[r * 3 + 2] = g_rho;
        }
      }
    }
  }
}

__device__ void load_meta(int* seg, int* ts, float* ninv,
                          const int* __restrict__ meta_i32,
                          const float* __restrict__ meta_f32, size_t slot0) {
  for (int r = threadIdx.x; r < CH; r += THREADS) {
    seg[r] = meta_i32[(slot0 + r) * 3 + 0];
    ts[r] = meta_i32[(slot0 + r) * 3 + 2];
    if (ninv) ninv[r] = meta_f32[slot0 + r];
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one CTA per (64-key chunk, head, pack), walking kv_rowptr
// ---------------------------------------------------------------------------

template <typename T, int D, bool FUNC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dy,
                   const float* __restrict__ pos_table,
                   const float* __restrict__ time_table,
                   const int* __restrict__ meta_i32,
                   const float* __restrict__ meta_f32,
                   const int* __restrict__ kv_wl,
                   const int* __restrict__ kv_rowptr,
                   const int* __restrict__ seg_rng, T* __restrict__ dk,
                   T* __restrict__ dv, int cap, int H, int L, int npb,
                   int ntb, float scale, float tb_denom, int use_pos,
                   int use_time, int dense) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  const Smem sm = carve<D>(smem, npb, ntb);
  const int kc = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int nb = cap / BLK;
  const int kb = kc >> 1;
  const int key0 = kb * BLK + (kc & 1) * CH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t pack = (size_t)g * cap;

  load_rows<T, D>(sm.k, k, pack + key0, H, h);
  load_rows<T, D>(sm.v, v, pack + key0, H, h);
  load_meta(sm.kseg, sm.kts, nullptr, meta_i32, meta_f32, pack + key0);
  for (int t = threadIdx.x; t < npb; t += THREADS)
    sm.pt[t] = pos_table[t * H + h];
  for (int t = threadIdx.x; t < ntb; t += THREADS)
    sm.tt[t] = time_table[t * H + h];

  float acc_k[RPT][NC], acc_v[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // this CTA's live q-blocks in ascending order: its run of the k-major
  // work-list (K2), or every q-block of the dense grid tested live (K8)
  const int* rng = seg_rng + (size_t)g * nb * 2;
  const int p0 = dense ? 0 : kv_rowptr[g * (nb + 1) + kb];
  const int p1 = dense ? nb : kv_rowptr[g * (nb + 1) + kb + 1];
  for (int p = p0; p < p1; ++p) {
    if (dense && !block_live(rng, p, kb)) continue;  // uniform in the CTA
    const int qb = dense ? p : kv_wl[((size_t)g * L + p) * 2 + 0];
    for (int qc = 0; qc < BLK / CH; ++qc) {
      const int q0 = qb * BLK + qc * CH;
      if (q0 + CH - 1 < key0) continue;  // every pair acausal: ds = a = 0
      __syncthreads();  // the previous chunk's readers are done
      load_rows<T, D>(sm.q, q, pack + q0, H, h);
      load_rows<T, D>(sm.dy, dy, pack + q0, H, h);
      load_meta(sm.qseg, sm.qts, sm.qninv, meta_i32, meta_f32, pack + q0);
      __syncthreads();
      recompute_tile<D, FUNC>(sm, q0, key0, scale, tb_denom, npb, ntb,
                              use_pos, use_time, true, false);
      __syncthreads();
      // keys ty + 16 i, head dims tx + 16 j
      for (int qq = 0; qq < CH; ++qq) {
        float av[RPT], dsv[RPT], dyv[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          av[i] = sm.a[qq * (CH + 1) + ty + 16 * i];
          dsv[i] = sm.ds[qq * (CH + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dyv[j] = sm.dy[qq * (D + 1) + tx + 16 * j];
          qv[j] = sm.q[qq * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            acc_v[i][j] = fmaf(av[i], dyv[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const size_t slot = pack + key0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const size_t o = slot * row_stride + (size_t)h * D + tx + 16 * j;
      dk[o] = from_f32<T>(acc_k[i][j] * scale);
      dv[o] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq + RAB partials: one CTA per (64-row q chunk, head, pack), q_rowptr
// ---------------------------------------------------------------------------

template <typename T, int D, bool FUNC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dy,
                  const float* __restrict__ pos_table,
                  const float* __restrict__ time_table,
                  const int* __restrict__ meta_i32,
                  const float* __restrict__ meta_f32,
                  const int* __restrict__ q_wl,
                  const int* __restrict__ q_rowptr,
                  const int* __restrict__ seg_rng, T* __restrict__ dq,
                  float* __restrict__ partial, int cap, int H, int L,
                  int npb, int ntb, float scale, float tb_denom, int use_pos,
                  int use_time, int dense) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  const Smem sm = carve<D>(smem, npb, ntb);
  const int qc = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int nb = cap / BLK;
  const int qb = qc >> 1;
  const int q0 = qb * BLK + (qc & 1) * CH;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t pack = (size_t)g * cap;
  const int W = npb + ntb;

  load_rows<T, D>(sm.q, q, pack + q0, H, h);
  load_rows<T, D>(sm.dy, dy, pack + q0, H, h);
  load_meta(sm.qseg, sm.qts, sm.qninv, meta_i32, meta_f32, pack + q0);
  for (int t = tid; t < npb; t += THREADS) sm.pt[t] = pos_table[t * H + h];
  for (int t = tid; t < ntb; t += THREADS) sm.tt[t] = time_table[t * H + h];
  for (int t = tid; t < W; t += THREADS) sm.part[t] = 0.0f;

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  // this CTA's live k-blocks in ascending order: its run of the q-major
  // work-list (K2), or every k-block of the dense grid tested live (K8)
  const int* rng = seg_rng + (size_t)g * nb * 2;
  const int p0 = dense ? 0 : q_rowptr[g * (nb + 1) + qb];
  const int p1 = dense ? nb : q_rowptr[g * (nb + 1) + qb + 1];
  for (int p = p0; p < p1; ++p) {
    if (dense && !block_live(rng, qb, p)) continue;  // uniform in the CTA
    const int kb = dense ? p : q_wl[((size_t)g * L + p) * 2 + 1];
    for (int kc = 0; kc < BLK / CH; ++kc) {
      const int key0 = kb * BLK + kc * CH;
      if (key0 > q0 + CH - 1) continue;  // every pair acausal: ds = 0
      __syncthreads();
      load_rows<T, D>(sm.k, k, pack + key0, H, h);
      load_rows<T, D>(sm.v, v, pack + key0, H, h);
      load_meta(sm.kseg, sm.kts, nullptr, meta_i32, meta_f32, pack + key0);
      for (int t = tid; t < CH * ntb; t += THREADS) sm.rowpart[t] = 0.0f;
      __syncthreads();
      recompute_tile<D, FUNC>(sm, q0, key0, scale, tb_denom, npb, ntb,
                              use_pos, use_time, false, use_time != 0);
      __syncthreads();
      // rows ty + 16 i, head dims tx + 16 j
      for (int kk = 0; kk < CH; ++kk) {
        float dsv[RPT], kv[NC];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          dsv[i] = sm.ds[(ty + 16 * i) * (CH + 1) + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) kv[j] = sm.k[kk * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j)
            acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
      }
      // position grads: diagonal t holds the entries with r - c = t - 63,
      // i.e. relative distance (q0 - key0) + t - 63, summed in row order
      if (use_pos) {
        for (int t = tid; t < 2 * CH - 1; t += THREADS) {
          const int off = t - (CH - 1);
          float sum = 0.0f;
          for (int r = max(0, off); r < min(CH, CH + off); ++r)
            sum += sm.ds[r * (CH + 1) + (r - off)];
          sm.diag[t] = sum;
        }
      }
      // bucket time grads, first per row: each row's thread adds its
      // entries in key order into the row's own bucket sums (the
      // functional mode's row sums came out of recompute_tile)
      if (use_time && !FUNC) {
        for (int r = tid; r < CH; r += THREADS)
          for (int c = 0; c < CH; ++c)
            sm.rowpart[r * ntb + sm.tb[r * (CH + 1) + c]] +=
                sm.ds[r * (CH + 1) + c];
      }
      __syncthreads();
      if (use_pos) {
        const int base = q0 - key0 - (CH - 1);  // distance of diagonal 0
        for (int b = tid; b < npb; b += THREADS) {
          float add = 0.0f;
          bool any = false;
          for (int t = 0; t < 2 * CH - 1; ++t) {
            const int dist = base + t;
            const int bucket = min(max(dist, 0), npb - 1);
            if (bucket == b) {
              add += sm.diag[t];
              any = true;
            }
          }
          if (any) sm.part[b] += add;
        }
      }
      if (use_time) {
        for (int b = tid; b < ntb; b += THREADS) {
          float add = 0.0f;
          for (int r = 0; r < CH; ++r) add += sm.rowpart[r * ntb + b];
          sm.part[npb + b] += add;
        }
      }
    }
  }
  __syncthreads();

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const size_t slot = pack + q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[slot * row_stride + (size_t)h * D + tx + 16 * j] =
          from_f32<T>(acc[i][j] * scale);
  }
  const size_t cta = ((size_t)g * gridDim.x + qc) * H + h;
  for (int b = tid; b < W; b += THREADS) partial[cta * W + b] = sm.part[b];
}

// d pos_table / d time_table: the per-CTA partials of each head summed
// over (pack, q chunk) in that fixed order.
__global__ void rab_partial_sum_kernel(const float* __restrict__ partial,
                                       int nslots, int H, int npb, int ntb,
                                       float* __restrict__ dpt,
                                       float* __restrict__ dtt) {
  const int W = npb + ntb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < W * H;
       i += gridDim.x * blockDim.x) {
    const int b = i / H, h = i % H;
    float sum = 0.0f;
    for (int s = 0; s < nslots; ++s)
      sum += partial[((size_t)s * H + h) * W + b];
    if (b < npb)
      dpt[b * H + h] = sum;
    else
      dtt[(b - npb) * H + h] = sum;
  }
}

cudaError_t set_smem(const void* kern, int smem, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > done[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    done[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, int D, bool FUNC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dy, const float* pt, const float* tt,
                   const int* meta_i32, const float* meta_f32,
                   const int* q_wl, const int* q_rowptr, const int* kv_wl,
                   const int* kv_rowptr, const int* seg_rng, void* dq,
                   void* dk, void* dv, float* partial, float* dpt,
                   float* dtt, int G, int cap, int H, int L, int npb,
                   int ntb, float scale, float tb_denom, int use_pos,
                   int use_time, int dense, cudaStream_t stream) {
  const int smem =
      (int)((smem_words_fixed<D>() + smem_words_var(npb, ntb)) * 4);
  auto kv_kern = attn_bwd_kv_kernel<T, D, FUNC>;
  auto q_kern = attn_bwd_q_kernel<T, D, FUNC>;
  static int kv_set[MAX_DEVICES] = {};
  static int q_set[MAX_DEVICES] = {};
  cudaError_t e = set_smem((const void*)kv_kern, smem, kv_set);
  if (e != cudaSuccess) return e;
  e = set_smem((const void*)q_kern, smem, q_set);
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  dim3 grid(2 * (cap / BLK), H, G);
  kv_kern<<<grid, THREADS, smem, stream>>>(
      qt, kt, vt, dyt, pt, tt, meta_i32, meta_f32, kv_wl, kv_rowptr,
      seg_rng, static_cast<T*>(dk), static_cast<T*>(dv), cap, H, L, npb, ntb,
      scale, tb_denom, use_pos, use_time, dense);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  q_kern<<<grid, THREADS, smem, stream>>>(
      qt, kt, vt, dyt, pt, tt, meta_i32, meta_f32, q_wl, q_rowptr, seg_rng,
      static_cast<T*>(dq), partial, cap, H, L, npb, ntb, scale, tb_denom,
      use_pos, use_time, dense);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = (npb + ntb) * H;
  rab_partial_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, G * 2 * (cap / BLK), H, npb, ntb, dpt, dtt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int D, int func, const void* q, const void* k,
                         const void* v,
                         const void* dy, const float* pt, const float* tt,
                         const int* mi, const float* mf, const int* q_wl,
                         const int* q_rowptr, const int* kv_wl,
                         const int* kv_rowptr, const int* seg_rng, void* dq,
                         void* dk, void* dv, float* partial, float* dpt,
                         float* dtt, int G, int cap, int H, int L, int npb,
                         int ntb, float scale, float tb_denom, int use_pos,
                         int use_time, int dense, cudaStream_t s) {
#define JAB_CASE(DD)                                                        \
  case DD:                                                                  \
    return func ? launch<T, DD, true>(q, k, v, dy, pt, tt, mi, mf, q_wl,    \
                                      q_rowptr, kv_wl, kv_rowptr, seg_rng,  \
                                      dq, dk, dv, partial, dpt, dtt, G,     \
                                      cap, H, L, npb, ntb, scale, tb_denom, \
                                      use_pos, use_time, dense, s)          \
                : launch<T, DD, false>(q, k, v, dy, pt, tt, mi, mf, q_wl,   \
                                       q_rowptr, kv_wl, kv_rowptr, seg_rng, \
                                       dq, dk, dv, partial, dpt, dtt, G,    \
                                       cap, H, L, npb, ntb, scale,          \
                                       tb_denom, use_pos, use_time, dense,  \
                                       s);
  switch (D) {
    JAB_CASE(16)
    JAB_CASE(32)
    JAB_CASE(64)
    JAB_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef JAB_CASE
}

}  // namespace

// q, k, v, dy, dq, dk, dv: (G, cap, H, D) float32 (dtype 0) or bfloat16
// (dtype 1); pos_table, dpt (npb, H) and time_table, dtt (ntb, H) float32
// (with time_functional set, the packed (3, H) [amp; sigma; rho] and its
// grad);
// meta_i32 (G, cap, 3); meta_f32 (G, cap, 1); q_wl, kv_wl (G, L, 2);
// q_rowptr, kv_rowptr (G, cap/128 + 1); seg_rng (G, cap/128, 2); partial
// (G * 2 * cap/128 * H, npb + ntb) float32 scratch. With `dense` set (K8)
// the kernels walk the dense grid on seg_rng and read no work-list; else
// (K2) they walk the work-lists and read no seg_rng. Launches three kernels
// on `stream`, on the calling thread's current device. Returns the first
// cudaError_t (0 on success).
extern "C" int jagged_attn_bwd(
    const void* q, const void* k, const void* v, const void* dy,
    const float* pos_table, const float* time_table, const int* meta_i32,
    const float* meta_f32, const int* q_wl, const int* q_rowptr,
    const int* kv_wl, const int* kv_rowptr, const int* seg_rng, void* dq,
    void* dk, void* dv, float* partial, float* dpt, float* dtt, int G,
    int cap, int H, int D, int L, int npb, int ntb, float scale,
    float tb_denom, int use_pos, int use_time, int time_functional,
    int dense, int dtype, void* stream) {
  if (G <= 0 || cap <= 0 || cap % BLK != 0 || H <= 0 || L <= 0 || npb <= 0 ||
      ntb <= 0 || (time_functional && ntb != 3) ||
      (dense ? seg_rng == nullptr
             : (q_wl == nullptr || q_rowptr == nullptr || kv_wl == nullptr ||
                kv_rowptr == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_dtype<float>(D, time_functional, q, k, v, dy, pos_table,
                            time_table, meta_i32, meta_f32, q_wl, q_rowptr,
                            kv_wl, kv_rowptr, seg_rng, dq, dk, dv, partial,
                            dpt, dtt, G, cap, H, L, npb, ntb, scale, tb_denom,
                            use_pos, use_time, dense, s);
  else if (dtype == 1)
    e = launch_dtype<__nv_bfloat16>(
        D, time_functional, q, k, v, dy, pos_table, time_table, meta_i32,
        meta_f32, q_wl, q_rowptr, kv_wl, kv_rowptr, seg_rng, dq, dk, dv,
        partial, dpt, dtt, G, cap, H, L, npb, ntb, scale, tb_denom, use_pos,
        use_time, dense, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
