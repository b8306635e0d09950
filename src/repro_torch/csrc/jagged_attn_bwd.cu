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
// by chip_smoke.py, which states the binding bound).
// - bf16 (the training path): all five products run on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulate, fed by ldmatrix from
//   padded bf16 tiles; see "The bf16 instantiation" below), with the next
//   streamed chunk brought in by cp.async while the current one is
//   computed. At 64 x 64 tiles the products no longer set the pace: the
//   per-entry epilogue (bias, SiLU, the mask) and the dq kernel's trip of
//   the fp32 ds tile through shared memory for the RAB-table grads do.
//   a and ds are rounded to bf16 once, as operands of dv, dk and dq: a
//   declared divergence from the reference, which multiplies them in
//   fp32; the table grads are summed from the fp32 ds.
// - fp32: the products in fp32 FMA on the CUDA cores (67 TFLOP/s), the
//   first version's path kept as it was, since it is held to 1e-4.
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
//   entries of a row, a fixed shuffle tree sums the row's 16 threads (in
//   the bf16 kernels the 4 lanes of a quad, then the two warps' half rows
//   in order), and the rows are summed in order. E * z^rho is taken as 0
//   where E underflows to 0 (z^rho may be inf there), so a masked entry,
//   whose ds is 0, adds exactly 0.
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

#include <climits>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The bf16 instantiation: the five products on the tensor cores
// ---------------------------------------------------------------------------
//
// q, k, v and dy stay bf16 in shared memory, rows padded by 8 elements (16
// bytes) so that the eight 16-byte rows an ldmatrix reads fall in eight
// different bank groups. Eight warps split a 64 x 64 score tile as 4 (16
// query rows) x 2 (32 keys); each runs s = q.k^T and da = dy.v^T with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), fed by ldmatrix. The
// per-entry epilogue (bias, SiLU, SiLU', the mask) runs on the fp32
// accumulators in their fragment layout. a and ds are rounded to bf16
// once, as the operands of the second products (the declared divergence
// from the reference, which multiplies fp32 a and ds by bf16 operands);
// the RAB-table grads are summed from the fp32 ds only.
// - dk/dv kernel: a and ds go to shared memory as bf16 [query][key]
//   tiles, and dv += a^T.dy, dk += ds^T.q read them with ldmatrix.trans
//   (warps split 4 (16 keys) x 2 (D/2 head dims)).
// - dq kernel: ds also goes to shared memory in fp32 for the RAB-table
//   grads (rab_tile_reduce_tc: sums in fixed orders, spread over more
//   threads than the fp32 kernel's); dq += ds.k takes ds as the A operand
//   straight from the accumulators (two n8 tiles make one k16 fragment),
//   so each warp sums over its 32 keys into a 16 x D partial; the two key
//   halves are added in a fixed order at the end.
// - The streamed chunk (q, dy and their metadata in the dk/dv kernel; k,
//   v and theirs in the dq kernel) is double-buffered: the next live
//   chunk is brought in with cp.async while the current one is computed.
// CH = 64 is wgmma's 64-row tile; wgmma with TMA is the next step.

constexpr int PAD = 8;           // bf16 elements of row padding
constexpr int LDA = CH + PAD;    // the bf16 a / ds tiles' row stride
// the fp32 ds tile's row stride: a half-warp's 8-byte stores of a
// fragment row pair (8 g x 4 t) fall in distinct banks
constexpr int DSLD = CH + 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a.b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of the tensor-core kernels, in bytes, every piece 16-byte
// aligned. Both: the CTA's fixed pair of bf16 tiles, two stages of the
// streamed pair, the metadata (fixed, two stages) and the bias tables.
// The dk/dv kernel adds the bf16 a and ds tiles; the dq kernel the fp32
// ds tile, the half-diagonal sums, the partial, the time grads' group sums
// and their row slices: row_slices() per row, ntb wide at a stride of
// ntb + 1 (so that a warp's lanes adding to one bucket of their own
// slices meet few bank conflicts), each written by one thread only.
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

template <bool FUNC>
__host__ __device__ constexpr int row_slices() {
  return FUNC ? 2 : 8;  // functional: the two warps' half rows; bucket:
                        // one per (warp column, lane of the quad)
}

struct SmemTC {
  bf16 *fx0, *fx1;           // the CTA's own rows (k, v or q, dy)
  bf16 *st0[2], *st1[2];     // the streamed chunk, two stages
  int *fseg, *fts;           // the fixed rows' segment and timestamp
  float* fninv;
  int *sseg[2], *sts[2];     // the streamed rows'
  float* sninv[2];
  float *pt, *tt;
  bf16 *a, *dsb;             // dk/dv: bf16 a and ds, [query][key]
  float* ds;                 // dq: fp32 ds, [query][key], stride DSLD
  float *diag2, *part, *gsum, *slices;
};

// One stage of the streamed chunk: its two tiles and its metadata. (The
// stage is picked by a select, not an index, so the struct's arrays stay
// out of local memory.)
struct Stage {
  bf16 *r0, *r1;
  int *seg, *ts;
  float* ninv;
};

__device__ __forceinline__ Stage stage_of(const SmemTC& sm, int st) {
  return st ? Stage{sm.st0[1], sm.st1[1], sm.sseg[1], sm.sts[1], sm.sninv[1]}
            : Stage{sm.st0[0], sm.st1[0], sm.sseg[0], sm.sts[0], sm.sninv[0]};
}

// Lays the pieces out from `base` (nullptr on the host: sizes only) and
// returns the bytes used.
template <int D, bool KV, bool FUNC>
__host__ __device__ size_t layout_tc(unsigned char* base, SmemTC& s,
                                     int npb, int ntb) {
  size_t used = 0;
  auto take = [&](size_t bytes) {
    unsigned char* r = base ? base + used : nullptr;
    used += align16(bytes);
    return r;
  };
  const size_t tile = (size_t)CH * (D + PAD) * sizeof(bf16);
  s.fx0 = reinterpret_cast<bf16*>(take(tile));
  s.fx1 = reinterpret_cast<bf16*>(take(tile));
  for (int i = 0; i < 2; ++i) {
    s.st0[i] = reinterpret_cast<bf16*>(take(tile));
    s.st1[i] = reinterpret_cast<bf16*>(take(tile));
  }
  s.fseg = reinterpret_cast<int*>(take(CH * 4));
  s.fts = reinterpret_cast<int*>(take(CH * 4));
  s.fninv = reinterpret_cast<float*>(take(CH * 4));
  for (int i = 0; i < 2; ++i) {
    s.sseg[i] = reinterpret_cast<int*>(take(CH * 4));
    s.sts[i] = reinterpret_cast<int*>(take(CH * 4));
    s.sninv[i] = reinterpret_cast<float*>(take(CH * 4));
  }
  s.pt = reinterpret_cast<float*>(take((size_t)npb * 4));
  s.tt = reinterpret_cast<float*>(take((size_t)ntb * 4));
  s.a = s.dsb = nullptr;
  s.ds = s.diag2 = s.part = s.gsum = s.slices = nullptr;
  if (KV) {
    s.a = reinterpret_cast<bf16*>(take((size_t)CH * LDA * sizeof(bf16)));
    s.dsb = reinterpret_cast<bf16*>(take((size_t)CH * LDA * sizeof(bf16)));
  } else {
    s.ds = reinterpret_cast<float*>(take((size_t)CH * DSLD * 4));
    s.diag2 = reinterpret_cast<float*>(take(4 * CH * 4));
    s.part = reinterpret_cast<float*>(take((size_t)(npb + ntb) * 4));
    s.gsum = reinterpret_cast<float*>(take((size_t)8 * ntb * 4));
    s.slices = reinterpret_cast<float*>(
        take((size_t)CH * row_slices<FUNC>() * (ntb + 1) * 4));
  }
  return used;
}

// Can the 64-row query chunk at q0 and the 64-key chunk at key0 of a pack
// hold a pair of one row? A pack's segments ascend with the slot and its
// padding (segment < 0) comes last, so each chunk's rows lie in the
// segments from its first slot's to its last's (to any, if the last is
// padding), and the chunks meet only where those ranges do. The chunk
// pairs this skips add exactly nothing (a = ds = 0) to any result.
__device__ __forceinline__ bool chunks_meet(const int* __restrict__ meta_i32,
                                            size_t pack, int q0, int key0) {
  const int qlo = meta_i32[(pack + q0) * 3];
  const int klo = meta_i32[(pack + key0) * 3];
  if (qlo < 0 || klo < 0) return false;  // all padding
  int qhi = meta_i32[(pack + q0 + CH - 1) * 3];
  int khi = meta_i32[(pack + key0 + CH - 1) * 3];
  qhi = qhi < 0 ? INT_MAX : qhi;
  khi = khi < 0 ? INT_MAX : khi;
  return qlo <= khi && klo <= qhi;
}

// CH rows of one head from token slot `slot0` into a padded bf16 tile by
// cp.async; the caller commits.
template <int D>
__device__ void copy_rows_async(bf16* dst, const bf16* __restrict__ src,
                                size_t slot0, int H, int h) {
  constexpr int C8 = D / 8;  // 16-byte chunks per row
  const size_t row_stride = (size_t)H * D;
  for (int i = threadIdx.x; i < CH * C8; i += THREADS) {
    const int r = i / C8, c = i % C8;
    cp_async16(dst + r * (D + PAD) + c * 8,
               src + (slot0 + r) * row_stride + (size_t)h * D + c * 8);
  }
}

// Their metadata: segment, timestamp and, with `ninv`, the 1/(pos+1)
// weight.
__device__ void copy_meta_async(int* seg, int* ts, float* ninv,
                                const int* __restrict__ meta_i32,
                                const float* __restrict__ meta_f32,
                                size_t slot0) {
  for (int r = threadIdx.x; r < CH; r += THREADS) {
    cp_async4(seg + r, meta_i32 + (slot0 + r) * 3 + 0);
    cp_async4(ts + r, meta_i32 + (slot0 + r) * 3 + 2);
    if (ninv) cp_async4(ninv + r, meta_f32 + slot0 + r);
  }
}

// s = q.k^T and da = dy.v^T for this warp's 16 query rows (wi) and 32
// keys (wj) of the tile: Q, DY rows = queries, K, V rows = keys, stride
// D + PAD. s[nt][e] is (row 16 wi + g + 8 (e >= 2), key 32 wj + 8 nt +
// 2 t + (e & 1)) with g = lane / 4, t = lane % 4.
template <int D>
__device__ __forceinline__ void scores_tc(const bf16* Q, const bf16* DY,
                                          const bf16* K, const bf16* V,
                                          float (&s)[4][4],
                                          float (&da)[4][4], int wi, int wj,
                                          int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = da[n][e] = 0.0f;
  const int arow = 16 * wi + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  const int brow = 32 * wj + (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned aq[4], ady[4];
    ldsm_x4(aq, Q + arow * LD + 16 * kk + acol);
    ldsm_x4(ady, DY + arow * LD + 16 * kk + acol);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned bk[4], bv[4];
      ldsm_x4(bk, K + (brow + 16 * np) * LD + 16 * kk + bcol);
      ldsm_x4(bv, V + (brow + 16 * np) * LD + 16 * kk + bcol);
      mma16816(s[2 * np], aq, bk[0], bk[1]);
      mma16816(s[2 * np + 1], aq, bk[2], bk[3]);
      mma16816(da[2 * np], ady, bv[0], bv[1]);
      mma16816(da[2 * np + 1], ady, bv[2], bv[3]);
    }
  }
}

// The per-entry epilogue on the accumulators (recompute_tile's
// arithmetic): rows are queries (q0 + row) with metadata rseg/rts/rninv,
// columns keys (key0 + col) with cseg/cts. KV: a and ds to the bf16
// tiles. Else (dq): ds to the fp32 tile, ds as bf16 A fragments of ds.k
// (dsf[kk] for keys 32 wj + 16 kk ..), and with `time_grads` the time
// grads' row slices: in the bucket mode each entry's ds added to this
// thread's slice of its row at its bucket, in key order; in the
// functional mode this warp's half-row sums (slice wj of the row, 3 wide).
template <bool FUNC, bool KV>
__device__ __forceinline__ void epilogue_tc(
    const SmemTC& sm, const float (&s)[4][4], const float (&da)[4][4],
    const int* rseg, const int* rts, const float* rninv, const int* cseg,
    const int* cts, int q0, int key0, float scale, float tb_denom, int npb,
    int ntb, int use_pos, int use_time, bool time_grads,
    unsigned (&dsf)[2][4], int wi, int wj, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float amp = 0.0f, sigma = 1.0f, rho = 1.0f, c_sig = 0.0f, c_rho = 0.0f;
  if constexpr (FUNC) {
    amp = sm.tt[0];
    sigma = sm.tt[1];
    rho = sm.tt[2];
    c_sig = __fdiv_rn(__fmul_rn(amp, rho), sigma);
    c_rho = -amp;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {   // rows g and g + 8
    const int r = 16 * wi + g + 8 * hr;
    const int qslot = q0 + r;
    const int qseg = rseg[r];
    const int qts = rts[r];
    const float qninv = rninv[r];
    float g_amp = 0.0f, g_sig = 0.0f, g_rho = 0.0f;
    float* slice = nullptr;  // the bucket mode's slice of this row
    if constexpr (!FUNC && !KV) {
      slice = sm.slices + (r * 8 + wj * 4 + t) * (ntb + 1);
      if (time_grads)
        for (int b = 0; b < ntb; ++b) slice[b] = 0.0f;
    }
    int run_b = -1;
    float run_sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float av[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 32 * wj + 8 * nt + 2 * t + e;
        const int kslot = key0 + c;
        float bias = 0.0f;
        if (use_pos) bias += sm.pt[min(max(qslot - kslot, 0), npb - 1)];
        int tb = 0;
        float E = 0.0f, zr = 0.0f, lnz = 0.0f;
        if (use_time) {
          if constexpr (FUNC) {
            E = functional_E(qts, cts[c], sigma, rho, zr, lnz);
            bias += __fmul_rn(amp, E);
          } else {
            tb = time_bucket(qts, cts[c], tb_denom, ntb);
            bias += sm.tt[tb];
          }
        }
        const float x = s[nt][2 * hr + e] * scale + bias;
        const bool live = qseg == cseg[c] && qseg >= 0 && qslot >= kslot;
        const float mw = live ? qninv : 0.0f;
        const float sig = 1.0f / (1.0f + expf(-x));
        av[e] = x * sig * mw;
        const float ds =
            da[nt][2 * hr + e] * (sig * (1.0f + x * (1.0f - sig))) * mw;
        dsv[e] = ds;
        if constexpr (!KV) {
          if constexpr (FUNC) {
            if (time_grads && use_time) {
              const float ezr = E == 0.0f ? 0.0f : __fmul_rn(E, zr);
              g_amp += ds * E;
              g_sig += ds * __fmul_rn(ezr, c_sig);
              g_rho += ds * __fmul_rn(__fmul_rn(ezr, lnz), c_rho);
            }
          } else if (time_grads) {
            // the row's entries of this thread come in key order, so
            // their buckets in runs: a run's sum is added to this
            // thread's own slice of the row (no other writer) when the
            // bucket changes
            if (tb != run_b) {
              if (run_b >= 0) slice[run_b] += run_sum;
              run_b = tb;
              run_sum = ds;
            } else {
              run_sum += ds;
            }
          }
        }
      }
      const int c0 = 32 * wj + 8 * nt + 2 * t;
      if constexpr (KV) {
        *reinterpret_cast<unsigned*>(sm.a + r * LDA + c0) =
            pack_bf16(av[0], av[1]);
        *reinterpret_cast<unsigned*>(sm.dsb + r * LDA + c0) =
            pack_bf16(dsv[0], dsv[1]);
      } else {
        *reinterpret_cast<float2*>(sm.ds + r * DSLD + c0) =
            make_float2(dsv[0], dsv[1]);
        // the A fragment of keys 16 kk ..: a0 / a1 (rows g, g + 8) from
        // n8 tile 2 kk, a2 / a3 from tile 2 kk + 1
        dsf[nt >> 1][(nt & 1) * 2 + hr] = pack_bf16(dsv[0], dsv[1]);
      }
    }
    if constexpr (!FUNC && !KV) {
      if (run_b >= 0) slice[run_b] += run_sum;
    }
    if constexpr (FUNC && !KV) {
      if (time_grads && use_time) {
        // this warp's 32 keys of the row lie with the 4 lanes of a quad:
        // a fixed shuffle tree, then one write per half row
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          g_amp += __shfl_xor_sync(0xffffffffu, g_amp, off);
          g_sig += __shfl_xor_sync(0xffffffffu, g_sig, off);
          g_rho += __shfl_xor_sync(0xffffffffu, g_rho, off);
        }
        if (t == 0) {
          float* rp = sm.slices + (r * 2 + wj) * (ntb + 1);
          rp[0] = g_amp;
          rp[1] = g_sig;
          rp[2] = g_rho;
        }
      }
    }
  }
}

// The RAB-table grads of one tile into this dq CTA's partial, in a fixed
// order, with more threads on each sum than the fp32 kernel: positions as
// half-diagonal sums of the fp32 ds tile (each diagonal's rows split in
// two), each bucket then adding only its own diagonals in order; times
// from the row slices, eight groups of eight rows per bucket (the slices
// of each row in order), then the groups in order. Starts after and ends
// before a __syncthreads of the caller.
template <bool FUNC>
__device__ void rab_tile_reduce_tc(const SmemTC& sm, int q0, int key0,
                                   int npb, int ntb, int use_pos,
                                   int use_time) {
  constexpr int S = row_slices<FUNC>();
  const int tid = threadIdx.x;
  if (use_pos) {
    for (int i = tid; i < 2 * (2 * CH - 1); i += THREADS) {
      const int t = i >> 1;
      const int off = t - (CH - 1);
      const int lo = max(0, off), hi = min(CH, CH + off);
      const int mid = lo + (hi - lo) / 2;
      const int r0 = (i & 1) ? mid : lo, r1 = (i & 1) ? hi : mid;
      float sum = 0.0f;
      for (int r = r0; r < r1; ++r) sum += sm.ds[r * DSLD + (r - off)];
      sm.diag2[i] = sum;
    }
  }
  if (use_time) {
    for (int i = tid; i < 8 * ntb; i += THREADS) {
      const int b = i % ntb, grp = i / ntb;
      float sum = 0.0f;
      for (int r = 8 * grp; r < 8 * grp + 8; ++r)
#pragma unroll
        for (int sl = 0; sl < S; ++sl)
          sum += sm.slices[(r * S + sl) * (ntb + 1) + b];
      sm.gsum[grp * ntb + b] = sum;
    }
  }
  __syncthreads();
  if (use_pos) {
    // diagonal t is at distance base + t, in bucket clip(base + t)
    const int base = q0 - key0 - (CH - 1);
    for (int b = tid; b < npb; b += THREADS) {
      const int t0 = max(b == 0 ? 0 : b - base, 0);
      const int t1 = min(b == npb - 1 ? 2 * CH - 2 : b - base, 2 * CH - 2);
      if (t0 > t1) continue;
      float add = 0.0f;
      for (int t = t0; t <= t1; ++t)
        add += sm.diag2[2 * t] + sm.diag2[2 * t + 1];
      sm.part[b] += add;
    }
  }
  if (use_time) {
    for (int b = tid; b < ntb; b += THREADS) {
      float add = 0.0f;
      for (int grp = 0; grp < 8; ++grp) add += sm.gsum[grp * ntb + b];
      sm.part[npb + b] += add;
    }
  }
}

// ---- dk, dv on the tensor cores: one CTA per (64-key chunk, head, pack)

template <int D, bool FUNC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_kv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dy,
                      const float* __restrict__ pos_table,
                      const float* __restrict__ time_table,
                      const int* __restrict__ meta_i32,
                      const float* __restrict__ meta_f32,
                      const int* __restrict__ kv_wl,
                      const int* __restrict__ kv_rowptr,
                      const int* __restrict__ seg_rng, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int cap, int H, int L, int npb,
                      int ntb, float scale, float tb_denom, int use_pos,
                      int use_time, int dense) {
  constexpr int LD = D + PAD;
  constexpr int WN = D / 2;        // head dims per warp
  constexpr int NT = WN / 8;       // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_tc[];
  SmemTC sm;
  layout_tc<D, true, FUNC>(smem_tc, sm, npb, ntb);
  const int kc = blockIdx.x, h = blockIdx.y, gp = blockIdx.z;
  const int nb = cap / BLK;
  const int kb = kc >> 1;
  const int key0 = kb * BLK + (kc & 1) * CH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wi = warp >> 1, wj = warp & 1;
  const size_t pack = (size_t)gp * cap;

  copy_rows_async<D>(sm.fx0, k, pack + key0, H, h);
  copy_rows_async<D>(sm.fx1, v, pack + key0, H, h);
  copy_meta_async(sm.fseg, sm.fts, nullptr, meta_i32, meta_f32, pack + key0);
  for (int t = threadIdx.x; t < npb; t += THREADS)
    sm.pt[t] = pos_table[t * H + h];
  for (int t = threadIdx.x; t < ntb; t += THREADS)
    sm.tt[t] = time_table[t * H + h];

  // this CTA's live q chunks in ascending order, as a flat index i over
  // its run (K2) or the dense grid (K8): q-block entry p0 + i / 2, half
  // i % 2
  const int* rng = seg_rng + (size_t)gp * nb * 2;
  const int p0 = dense ? 0 : kv_rowptr[gp * (nb + 1) + kb];
  const int p1 = dense ? nb : kv_rowptr[gp * (nb + 1) + kb + 1];
  const int end = 2 * (p1 - p0);
  auto q0_of = [&](int i) {
    const int p = p0 + (i >> 1);
    const int qb = dense ? p : kv_wl[((size_t)gp * L + p) * 2 + 0];
    return qb * BLK + (i & 1) * CH;
  };
  auto next_live = [&](int i) {
    for (; i < end; ++i) {
      if (dense && !block_live(rng, p0 + (i >> 1), kb)) continue;
      const int q0 = q0_of(i);
      if (q0 + CH - 1 < key0) continue;  // all acausal: ds = a = 0
      if (!chunks_meet(meta_i32, pack, q0, key0)) continue;
      return i;
    }
    return end;
  };
  auto prefetch = [&](int i, int st) {
    const size_t s0 = pack + q0_of(i);
    const Stage g = stage_of(sm, st);
    copy_rows_async<D>(g.r0, q, s0, H, h);
    copy_rows_async<D>(g.r1, dy, s0, H, h);
    copy_meta_async(g.seg, g.ts, g.ninv, meta_i32, meta_f32, s0);
  };

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  int cur = next_live(0), st = 0;
  if (cur < end) prefetch(cur, 0);
  cp_async_commit();
  while (cur < end) {
    cp_async_wait_all();  // the fixed rows and this chunk have landed
    // ... for every thread, and the last chunk's readers are done with
    // the other stage and the a / ds tiles
    __syncthreads();
    const int nxt = next_live(cur + 1);
    if (nxt < end) prefetch(nxt, st ^ 1);
    cp_async_commit();
    const int q0 = q0_of(cur);
    const Stage g = stage_of(sm, st);
    float s[4][4], da[4][4];
    unsigned unused[2][4];
    scores_tc<D>(g.r0, g.r1, sm.fx0, sm.fx1, s, da, wi, wj, lane);
    epilogue_tc<FUNC, true>(sm, s, da, g.seg, g.ts, g.ninv, sm.fseg, sm.fts,
                            q0, key0, scale, tb_denom, npb, ntb, use_pos,
                            use_time, false, unused, wi, wj, lane);
    __syncthreads();
    // dv += a^T.dy, dk += ds^T.q: rows = this warp's 16 keys, columns its
    // WN head dims, over the chunk's 64 queries
    const bf16* Q = g.r0;
    const bf16* DY = g.r1;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      unsigned aa[4], ad[4];
      const int arow = 16 * kk + (lane & 7) + (lane >> 4) * 8;
      const int acol = 16 * wi + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(aa, sm.a + arow * LDA + acol);
      ldsm_x4_t(ad, sm.dsb + arow * LDA + acol);
      const int brow = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      if constexpr (NT >= 2) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int bcol = WN * wj + 16 * np + (lane >> 4) * 8;
          unsigned bd[4], bq[4];
          ldsm_x4_t(bd, DY + brow * LD + bcol);
          ldsm_x4_t(bq, Q + brow * LD + bcol);
          mma16816(acc_v[2 * np], aa, bd[0], bd[1]);
          mma16816(acc_v[2 * np + 1], aa, bd[2], bd[3]);
          mma16816(acc_k[2 * np], ad, bq[0], bq[1]);
          mma16816(acc_k[2 * np + 1], ad, bq[2], bq[3]);
        }
      } else {
        const int bcol = WN * wj;
        unsigned bd[2], bq[2];
        ldsm_x2_t(bd, DY + brow * LD + bcol);
        ldsm_x2_t(bq, Q + brow * LD + bcol);
        mma16816(acc_v[0], aa, bd[0], bd[1]);
        mma16816(acc_k[0], ad, bq[0], bq[1]);
      }
    }
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait_all();

  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t slot = pack + key0 + 16 * wi + g + 8 * hr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const size_t o = slot * row_stride + (size_t)h * D + WN * wj + 8 * n
                       + 2 * t;
      *reinterpret_cast<unsigned*>(dk + o) = pack_bf16(
          acc_k[n][2 * hr] * scale, acc_k[n][2 * hr + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + o) =
          pack_bf16(acc_v[n][2 * hr], acc_v[n][2 * hr + 1]);
    }
  }
}

// ---- dq + RAB partials on the tensor cores: one CTA per (64-row q
// chunk, head, pack)

template <int D, bool FUNC>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_q_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dy,
                     const float* __restrict__ pos_table,
                     const float* __restrict__ time_table,
                     const int* __restrict__ meta_i32,
                     const float* __restrict__ meta_f32,
                     const int* __restrict__ q_wl,
                     const int* __restrict__ q_rowptr,
                     const int* __restrict__ seg_rng, bf16* __restrict__ dq,
                     float* __restrict__ partial, int cap, int H, int L,
                     int npb, int ntb, float scale, float tb_denom,
                     int use_pos, int use_time, int dense) {
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;        // n8 tiles of dq per warp: all of D
  extern __shared__ __align__(16) unsigned char smem_tc[];
  SmemTC sm;
  layout_tc<D, false, FUNC>(smem_tc, sm, npb, ntb);
  const int qc = blockIdx.x, h = blockIdx.y, gp = blockIdx.z;
  const int nb = cap / BLK;
  const int qb = qc >> 1;
  const int q0 = qb * BLK + (qc & 1) * CH;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wi = warp >> 1, wj = warp & 1;
  const size_t pack = (size_t)gp * cap;
  const int W = npb + ntb;
  const bool time_grads = use_time != 0;

  copy_rows_async<D>(sm.fx0, q, pack + q0, H, h);
  copy_rows_async<D>(sm.fx1, dy, pack + q0, H, h);
  copy_meta_async(sm.fseg, sm.fts, sm.fninv, meta_i32, meta_f32, pack + q0);
  for (int t = tid; t < npb; t += THREADS) sm.pt[t] = pos_table[t * H + h];
  for (int t = tid; t < ntb; t += THREADS) sm.tt[t] = time_table[t * H + h];
  for (int t = tid; t < W; t += THREADS) sm.part[t] = 0.0f;

  const int* rng = seg_rng + (size_t)gp * nb * 2;
  const int p0 = dense ? 0 : q_rowptr[gp * (nb + 1) + qb];
  const int p1 = dense ? nb : q_rowptr[gp * (nb + 1) + qb + 1];
  const int end = 2 * (p1 - p0);
  auto key0_of = [&](int i) {
    const int p = p0 + (i >> 1);
    const int kb = dense ? p : q_wl[((size_t)gp * L + p) * 2 + 1];
    return kb * BLK + (i & 1) * CH;
  };
  auto next_live = [&](int i) {
    for (; i < end; ++i) {
      if (dense && !block_live(rng, qb, p0 + (i >> 1))) continue;
      const int key0 = key0_of(i);
      if (key0 > q0 + CH - 1) continue;  // all acausal: ds = 0
      if (!chunks_meet(meta_i32, pack, q0, key0)) continue;
      return i;
    }
    return end;
  };
  auto prefetch = [&](int i, int st) {
    const size_t s0 = pack + key0_of(i);
    const Stage g = stage_of(sm, st);
    copy_rows_async<D>(g.r0, k, s0, H, h);
    copy_rows_async<D>(g.r1, v, s0, H, h);
    copy_meta_async(g.seg, g.ts, nullptr, meta_i32, meta_f32, s0);
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  int cur = next_live(0), st = 0;
  if (cur < end) prefetch(cur, 0);
  cp_async_commit();
  while (cur < end) {
    cp_async_wait_all();  // the fixed rows and this chunk have landed
    // ... for every thread, and the last chunk's readers are done with
    // the other stage, the ds tile and the row slices
    __syncthreads();
    const int nxt = next_live(cur + 1);
    if (nxt < end) prefetch(nxt, st ^ 1);
    cp_async_commit();
    const int key0 = key0_of(cur);
    const Stage g = stage_of(sm, st);
    float s[4][4], da[4][4];
    unsigned dsf[2][4];
    scores_tc<D>(sm.fx0, sm.fx1, g.r0, g.r1, s, da, wi, wj, lane);
    epilogue_tc<FUNC, false>(sm, s, da, sm.fseg, sm.fts, sm.fninv, g.seg,
                             g.ts, q0, key0, scale, tb_denom, npb, ntb,
                             use_pos, use_time, time_grads, dsf, wi, wj,
                             lane);
    // dq += ds.k over this warp's 32 keys: A from registers, B = the k
    // rows (keys x head dims) by ldmatrix.trans
    const bf16* K = g.r0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int brow = 32 * wj + 16 * kk + (lane & 7)
                       + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bk[4];
        ldsm_x4_t(bk, K + brow * LD + 16 * np + (lane >> 4) * 8);
        mma16816(acc[2 * np], dsf[kk], bk[0], bk[1]);
        mma16816(acc[2 * np + 1], dsf[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the fp32 ds tile, buckets and row sums are written
    rab_tile_reduce_tc<FUNC>(sm, q0, key0, npb, ntb, use_pos, use_time);
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait_all();
  __syncthreads();

  // dq = (key half 0 + key half 1) * scale: the wj = 1 warps park their
  // partial in the idle stage tiles as fp32 (CH x D x 4 bytes fit in the
  // four), the wj = 0 warps add it to theirs
  const int g = lane >> 2, t = lane & 3;
  float* park = reinterpret_cast<float*>(sm.st0[0]);
  if (wj == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * wi + g + 8 * hr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        park[r * D + 8 * n + 2 * t] = acc[n][2 * hr];
        park[r * D + 8 * n + 2 * t + 1] = acc[n][2 * hr + 1];
      }
    }
  }
  __syncthreads();
  if (wj == 0) {
    const size_t row_stride = (size_t)H * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * wi + g + 8 * hr;
      const size_t slot = pack + q0 + r;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + 2 * t;
        const float x0 = acc[n][2 * hr] + park[r * D + c];
        const float x1 = acc[n][2 * hr + 1] + park[r * D + c + 1];
        *reinterpret_cast<unsigned*>(dq + slot * row_stride
                                     + (size_t)h * D + c) =
            pack_bf16(x0 * scale, x1 * scale);
      }
    }
  }
  const size_t cta = ((size_t)gp * gridDim.x + qc) * H + h;
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
  // bf16: the tensor-core kernels; fp32: the FMA kernels
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  SmemTC sizes;
  const int smem_fma =
      (int)((smem_words_fixed<D>() + smem_words_var(npb, ntb)) * 4);
  const int smem_kv =
      TC ? (int)layout_tc<D, true, FUNC>(nullptr, sizes, npb, ntb)
         : smem_fma;
  const int smem_q =
      TC ? (int)layout_tc<D, false, FUNC>(nullptr, sizes, npb, ntb)
         : smem_fma;
  auto kv_kern = [] {
    if constexpr (TC)
      return attn_bwd_kv_tc_kernel<D, FUNC>;
    else
      return attn_bwd_kv_kernel<T, D, FUNC>;
  }();
  auto q_kern = [] {
    if constexpr (TC)
      return attn_bwd_q_tc_kernel<D, FUNC>;
    else
      return attn_bwd_q_kernel<T, D, FUNC>;
  }();
  static int kv_set[MAX_DEVICES] = {};
  static int q_set[MAX_DEVICES] = {};
  cudaError_t e = set_smem((const void*)kv_kern, smem_kv, kv_set);
  if (e != cudaSuccess) return e;
  e = set_smem((const void*)q_kern, smem_q, q_set);
  if (e != cudaSuccess) return e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  dim3 grid(2 * (cap / BLK), H, G);
  kv_kern<<<grid, THREADS, smem_kv, stream>>>(
      qt, kt, vt, dyt, pt, tt, meta_i32, meta_f32, kv_wl, kv_rowptr,
      seg_rng, static_cast<T*>(dk), static_cast<T*>(dv), cap, H, L, npb, ntb,
      scale, tb_denom, use_pos, use_time, dense);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  q_kern<<<grid, THREADS, smem_q, stream>>>(
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
