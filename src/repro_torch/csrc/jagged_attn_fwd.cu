// Jagged pointwise attention + RAB, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jagged_attention/kernel.py:
// fwd_pallas_wl (body _fwd_kernel_wl + _fwd_block_compute), the work-list
// forward of HSTU's and FuXi's softmax-free attention:
//   s   = q.k^T / sqrt(D) + pos_table[clip(i-j, 0, npb-1)] + time bias
//   a   = SiLU(s) * [same row, key at or before query] / (pos+1), rounded
//         to v's dtype
//   out = sum over the live k-blocks of a @ v, accumulated in fp32.
// The time bias has two modes, a template parameter of the kernel:
//   bucket (HSTU)     time_table[floor(log(1+|tq-tk|) / (log(10)*scale))]
//   functional (FuXi) amp * exp(-exp(rho * ln z)), z = (|tq-tk| + 1e-6) /
//                     sigma, from the head's (amp, sigma, rho) packed as a
//                     (3, H) table (_functional_time_bias, kernel.py:167).
//
// What bounds it on this card: at block 128 and head dim 128 a live block
// pair does 4*128*128*128 flops per head against 3 tiles of 32 KB (bf16)
// read, about 256 flops per byte, so on the tensor cores it sits at the
// ridge between memory (3.35 TB/s) and bf16 math (989 TFLOP/s). Besides,
// SiLU and the RAB need special functions (SiLU's exp and reciprocal per
// entry; the bucket's division per query-key pair, or the functional
// bias's two exps per entry); chip_smoke.py counts the ones the function
// needs, which at 16 per clock per SM outlast the tensor-core bound in the
// functional mode, and states which bound binds.
// - bf16 (the training and serving path): both products on the tensor
//   cores (mma.sync m16n8k16, bf16 in, fp32 accumulate, fed by ldmatrix;
//   see "The bf16 instantiation" below). The per-entry epilogue (the bias
//   with its precise logf/expf and true divisions, SiLU, the mask), not
//   the products, then sets the pace.
// - fp32: the products in fp32 FMA on the CUDA cores (67 TFLOP/s), the
//   first version's path kept as it was, since it is held to 1e-4.
//
// What the design does about the TPU's sequential grid: the TPU ran the
// q-major work-list in order and carried an accumulator across grid steps
// with first/last flags. Here the list is read as CSR runs (q_rowptr,
// built in ops.py): one CTA per (q-block, head, pack) walks its own run of
// live k-blocks in parallel with the others, keeps the 128 x D fp32
// accumulator in registers across the whole run, and writes its output
// once - zeros when the run is empty, so no output window is left
// unwritten. Each 128-key block is taken in two 64-key sub-tiles. The bias
// tables are indexed directly in shared memory; the TPU's one-hot matmul
// gathers are not needed. In the functional mode the head's (amp, sigma,
// rho) sit where the bucket table would, and the bias is computed per
// entry in fp32 with a true division and the precise logf/expf (no
// fast-math), as the plain version computes it. Dead pairs are never
// visited: the work-list holds live pairs only.
//
// The mask is a template parameter (CAUSAL), as in the TPU kernel (its
// `causal` flag, _mask_block / _block_live, kernel.py:218-237): causal, a
// query sees the keys of its row at or before it; acausal, every key of its
// row. The plan's 1/n (the causal count pos+1, or the row length) and its
// live pairs are built for one of the two (ops.py), and the wrapper picks
// the instantiation by the plan. Acausal drops the in-tile test qslot >=
// kslot and the dense grid's qb >= kb, and nothing else: K1-fwd has no
// whole-tile causal skip (its work-list holds the live pairs, and a
// sub-tile is skipped only when it shares no row with the q-block), so the
// causal instantiations are the code they were before the flag.
//
// K8-fwd, the dense-grid schedule, is a launch variant of this kernel
// (`dense` set). It replaces fwd_pallas (body _fwd_kernel, kernel.py:333),
// which walks the whole (nb, nb) grid and skips dead pairs by _block_live.
// The TPU's sequential k-block axis becomes a loop inside the CTA over every
// k-block, each tested live on the plan's per-block segment ranges
// (block_live.cuh); the live ones are the work-list run's, in the same
// ascending order, so K8 gives K1's bits on the same plan. Its extra cost is
// the scan of nb dead-or-live tests per CTA.
//
// The append launch (APPEND set) computes the serving warm path's attention
// (pointwise_attention_append, src/repro/models/hstu.py:333, which the TPU
// reference computes in XLA): the Q new queries at rows [p, p + Q) of each of
// R slot rows, against keys [0, p + Q) of the row's cached K/V, read by slot
// index from the layer's cache (N+1, cap, H, D). It must give each live query
// the bits the cold work-list launch gives it on a pack holding that row of
// T = p + n tokens alone, so it is that launch with the pack's meta computed
// in place: position i has segment 0 if i < T (else padding), the row's
// timestamp and 1/(i+1) from the same table the plan holds. A CTA takes one
// 128-row q-block of the window (its rows before p hold zeros in the q tile,
// and their outputs are dropped: an mma output row depends on its own A row
// only) and walks the k-blocks 0..qb the cold run walks for that q-block,
// skipping the same sub-tiles, in the same order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <type_traits>

#include "block_live.cuh"
#include "mma_bf16.cuh"
#include "time_bias.cuh"

namespace {

constexpr int MAX_DEVICES = 64;

constexpr int BQ = 128;       // q rows per CTA: the plan's block
constexpr int BK = 128;       // keys per k-block: the plan's block
constexpr int KC = 64;        // keys per shared-memory sub-tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = BQ / 16;  // rows per thread (8)
constexpr int SCT = KC / 16;  // score columns per thread (4)

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

// The warm window of the append launch: R slot rows, row r's Q new queries
// at positions [pref[r], pref[r] + Q) of a row of total[r] live tokens.
struct Window {
  const int* rows;     // (R,) the row's slot in the cache
  const int* pref;     // (R,) p, the first window position
  const int* total;    // (R,) T = p + n, the row's live tokens
  const int* ts;       // (R, cap) the row's timestamps
  const float* ninv;   // (cap,) 1/(i+1) at position i, as the plan has it
  int Q;
};

// The pack meta of position i of a one-row pack of T tokens: segment 0 or
// padding (-1), and 1/(i+1) or 0 for padding.
__device__ __forceinline__ int window_seg(int i, int T) {
  return i < T ? 0 : -1;
}
__device__ __forceinline__ float window_ninv(const Window& w, int i, int T) {
  return i < T ? w.ninv[i] : 0.0f;
}

template <int D>
__host__ __device__ constexpr size_t smem_floats_fixed() {
  return (size_t)BQ * (D + 1)     // q tile, padded rows
         + (size_t)KC * (D + 1)   // k sub-tile, padded rows
         + (size_t)KC * D         // v sub-tile
         + (size_t)BQ * (KC + 1)  // weights a
         + 3 * BQ                 // q seg / ts / 1/n
         + 2 * KC;                // k seg / ts
}

template <typename T, int D, bool FUNC, bool APPEND, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v,
                const float* __restrict__ pos_table,
                const float* __restrict__ time_table,
                const int* __restrict__ meta_i32,
                const float* __restrict__ meta_f32,
                const int* __restrict__ q_wl,
                const int* __restrict__ q_rowptr,
                const int* __restrict__ seg_rng, T* __restrict__ out,
                int cap, int H, int L, int npb, int ntb, float scale,
                float tb_denom, int use_pos, int use_time, int dense,
                Window win) {
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * (D + 1);
  float* v_s = k_s + KC * (D + 1);
  float* a_s = v_s + KC * D;
  int* qseg_s = reinterpret_cast<int*>(a_s + BQ * (KC + 1));
  int* qts_s = qseg_s + BQ;
  float* qninv_s = reinterpret_cast<float*>(qts_s + BQ);
  int* kseg_s = reinterpret_cast<int*>(qninv_s + BQ);
  int* kts_s = kseg_s + KC;
  float* pt_s = reinterpret_cast<float*>(kts_s + KC);
  float* tt_s = pt_s + npb;

  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int nb = cap / BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t row_stride = (size_t)H * D;
  const size_t pack = (size_t)g * cap;
  // APPEND: the window's q-block blockIdx.x of row g, its keys and values
  // at the row's slot of the cache
  int qb = blockIdx.x, wp = 0, wt = 0;
  size_t kv_pack = pack;
  if constexpr (APPEND) {
    wp = win.pref[g];
    wt = win.total[g];
    qb += wp / BQ;
    if (qb >= nb || qb * BQ >= wp + win.Q) return;  // past the window
    kv_pack = (size_t)win.rows[g] * cap;
  }

  // this CTA's live k-blocks in ascending order: its run of the q-major
  // work-list (K1), or every k-block of the dense grid tested live (K8),
  // or for the append launch the cold run of a one-row pack, k-blocks
  // 0..qb when the q-block holds a live row
  const int* rng = seg_rng + (size_t)g * nb * 2;
  int p0, p1;
  if constexpr (APPEND) {
    p0 = 0;
    p1 = qb * BQ < wt ? qb + 1 : 0;
  } else {
    p0 = dense ? 0 : q_rowptr[g * (nb + 1) + qb];
    p1 = dense ? nb : q_rowptr[g * (nb + 1) + qb + 1];
  }

  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    if constexpr (APPEND) {
      const int j = qb * BQ + r - wp;
      q_s[r * (D + 1) + d] =
          j >= 0 && j < win.Q
              ? to_f32(q[((size_t)g * win.Q + j) * row_stride +
                         (size_t)h * D + d])
              : 0.0f;
    } else {
      size_t slot = pack + (size_t)qb * BQ + r;
      q_s[r * (D + 1) + d] = to_f32(q[slot * row_stride + (size_t)h * D + d]);
    }
  }
  for (int r = tid; r < BQ; r += THREADS) {
    if constexpr (APPEND) {
      const int i = qb * BQ + r;
      qseg_s[r] = window_seg(i, wt);
      qts_s[r] = win.ts[pack + i];
      qninv_s[r] = window_ninv(win, i, wt);
    } else {
      size_t slot = pack + (size_t)qb * BQ + r;
      qseg_s[r] = meta_i32[slot * 3 + 0];
      qts_s[r] = meta_i32[slot * 3 + 2];
      qninv_s[r] = meta_f32[slot];
    }
  }
  for (int t = tid; t < npb; t += THREADS) pt_s[t] = pos_table[t * H + h];
  for (int t = tid; t < ntb; t += THREADS) tt_s[t] = time_table[t * H + h];

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int p = p0; p < p1; ++p) {
    if (!APPEND && dense && !block_live<CAUSAL>(rng, qb, p))  // uniform
      continue;
    const int kb = APPEND || dense ? p : q_wl[((size_t)g * L + p) * 2 + 1];
    for (int c = 0; c < BK / KC; ++c) {
      const int key0 = kb * BK + c * KC;  // first key slot of the sub-tile
      __syncthreads();  // the previous sub-tile's readers are done
      for (int i = tid; i < KC * D; i += THREADS) {
        int r = i / D, d = i % D;
        size_t src = (kv_pack + key0 + r) * row_stride + (size_t)h * D + d;
        k_s[r * (D + 1) + d] = to_f32(k[src]);
        v_s[r * D + d] = to_f32(v[src]);
      }
      for (int r = tid; r < KC; r += THREADS) {
        if constexpr (APPEND) {
          kseg_s[r] = window_seg(key0 + r, wt);
          kts_s[r] = win.ts[pack + key0 + r];
        } else {
          size_t slot = pack + key0 + r;
          kseg_s[r] = meta_i32[slot * 3 + 0];
          kts_s[r] = meta_i32[slot * 3 + 2];
        }
      }
      __syncthreads();

      // the head's functional time parameters (FUNC: tt is (3, H))
      float amp = 0.0f, sigma = 1.0f, rho = 1.0f;
      if constexpr (FUNC) {
        amp = tt_s[0];
        sigma = tt_s[1];
        rho = tt_s[2];
      }

      // scores for rows ty + 16 i, keys tx + 16 j
      float s[RPT][SCT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SCT; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float qv[RPT], kv[SCT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < SCT; ++j) kv[j] = k_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < SCT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + 16 * i;
        const int qslot = qb * BQ + r;
        const int qseg = qseg_s[r];
        const int qts = qts_s[r];
        const float qninv = qninv_s[r];
#pragma unroll
        for (int j = 0; j < SCT; ++j) {
          const int cl = tx + 16 * j;
          const int kslot = key0 + cl;
          float bias = 0.0f;
          if (use_pos) bias += pt_s[min(max(qslot - kslot, 0), npb - 1)];
          if (use_time) {
            if constexpr (FUNC) {
              float zr, lnz;
              bias += __fmul_rn(
                  amp, functional_E(qts, kts_s[cl], sigma, rho, zr, lnz));
            } else {
              bias += tt_s[time_bucket(qts, kts_s[cl], tb_denom, ntb)];
            }
          }
          const float x = s[i][j] * scale + bias;
          const bool live = qseg == kseg_s[cl] && qseg >= 0 &&
                            (!CAUSAL || qslot >= kslot);
          const float mw = live ? qninv : 0.0f;
          const float a = x * (1.0f / (1.0f + expf(-x))) * mw;
          a_s[r * (KC + 1) + cl] = to_f32(from_f32<T>(a));
        }
      }
      __syncthreads();

      // acc[rows ty + 16 i][cols tx + 16 j] += a @ v
      for (int kk = 0; kk < KC; ++kk) {
        float av[RPT], vv[NC];
#pragma unroll
        for (int i = 0; i < RPT; ++i) av[i] = a_s[(ty + 16 * i) * (KC + 1) + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    size_t slot = pack + (size_t)qb * BQ + ty + 16 * i;
    if constexpr (APPEND) {  // the window's rows only
      const int w = qb * BQ + ty + 16 * i - wp;
      if (w < 0 || w >= win.Q) continue;
      slot = (size_t)g * win.Q + w;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[slot * row_stride + (size_t)h * D + tx + 16 * j] =
          from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// The bf16 instantiation: both products on the tensor cores
// ---------------------------------------------------------------------------
//
// q, k and v stay bf16 in shared memory, rows padded by 8 elements (16
// bytes) so that the eight 16-byte rows an ldmatrix reads fall in eight
// different bank groups. The CTA's 128 x D q tile is loaded once; the
// k-block's 64-key K and V sub-tiles (and their segment and timestamp) are
// double-buffered: the next live sub-tile is brought in with cp.async while
// the current one is computed. Eight warps each own 16 query rows and all
// D output columns, and take each sub-tile 16 keys at a time:
// - s = q.k^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate), q and k
//   fed by ldmatrix; q is read again from shared memory for each 16 keys
//   rather than held in registers (32 more per thread at D = 128);
// - the epilogue on the accumulator fragments in registers, each thread
//   knowing its (row, key) from the m16n8 C layout, in the FMA kernel's
//   expression (the precise expf, the true division, time_bias.cuh);
// - a rounded to bf16 (as the FMA kernel and the reference round it to v's
//   dtype) and repacked as the A operand of out += a.v straight from the
//   registers: the two n8 C tiles of the 16 keys make one k16 A fragment.
//   v comes in by ldmatrix.trans. No a tile goes through shared memory.
// The products of bf16 operands are exact and summed in fp32, so the
// result differs from the FMA kernel's only in the fp32 summation order.
// Registers: 64 fp32 of the output accumulator per thread at D = 128, 8
// of s and 4 of packed a per 16 keys: two CTAs per SM (128 registers,
// about 107 KB of shared memory each at D = 128). Under that cap ptxas
// spilled at D = 64 and 128 with 32 keys a step (16 of s, 8 of a), and at
// D = 128 still with the 16-key steps unrolled or the q.k^T loop unrolled
// in full; the loops below (16-key steps one at a time, q.k^T four
// k16 slices at a time) spill nothing. One CTA per SM at 180 registers
// took 1.3-1.5x as long on the long-tail and training packs. The append
// launch's instantiations keep the window's row, start and length live as
// well and spilled under the 128 cap, so they take one CTA per SM: a warm
// tick's few hundred CTAs fill the card either way, and its time is set
// by the longest row's walk.
// A sub-tile whose keys share no segment with the q-block's rows (or
// whose rows are all padding) adds exactly zero and is skipped; the test
// is the same for K1 and K8, so they keep equal bits.
// Grid (head, q-block, pack), the q-blocks in descending order: a row's
// last q-blocks have the longest runs of k-blocks, so they start first and
// the short ones fill in behind them; the heads of a q-block start
// together and read the same token rows.

constexpr int PAD = 8;     // bf16 elements of row padding
constexpr int TC_MIN_CTAS = 2;

using bf16 = __nv_bfloat16;

// Shared memory of the tensor-core kernel, in bytes, every piece 16-byte
// aligned: the q tile, two stages of the K and V sub-tiles and of their
// segment and timestamp, and the bias tables.
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

struct SmemTC {
  bf16 *q, *k, *v;   // k, v: two stages, KC rows each
  int *kseg, *kts;   // two stages, KC each
  float *pt, *tt;
};

template <int D>
__host__ __device__ size_t layout_tc(unsigned char* base, SmemTC& s,
                                     int npb, int ntb) {
  size_t used = 0;
  auto take = [&](size_t bytes) {
    unsigned char* r = base ? base + used : nullptr;
    used += align16(bytes);
    return r;
  };
  s.q = reinterpret_cast<bf16*>(take((size_t)BQ * (D + PAD) * 2));
  s.k = reinterpret_cast<bf16*>(take((size_t)2 * KC * (D + PAD) * 2));
  s.v = reinterpret_cast<bf16*>(take((size_t)2 * KC * (D + PAD) * 2));
  s.kseg = reinterpret_cast<int*>(take(2 * KC * 4));
  s.kts = reinterpret_cast<int*>(take(2 * KC * 4));
  s.pt = reinterpret_cast<float*>(take((size_t)npb * 4));
  s.tt = reinterpret_cast<float*>(take((size_t)ntb * 4));
  return used;
}

// ROWS rows of one head from token slot `slot0` into a padded bf16 tile by
// cp.async; the caller commits.
template <int D, int ROWS>
__device__ void copy_rows_async(bf16* dst, const bf16* __restrict__ src,
                                size_t slot0, int H, int h) {
  constexpr int C8 = D / 8;  // 16-byte chunks per row
  const size_t row_stride = (size_t)H * D;
  for (int i = threadIdx.x; i < ROWS * C8; i += THREADS) {
    const int r = i / C8, c = i % C8;
    cp_async16(dst + r * (D + PAD) + c * 8,
               src + (slot0 + r) * row_stride + (size_t)h * D + c * 8);
  }
}

// Can the q-block's rows at slot q0 and the sub-tile's keys at slot key0
// of a pack hold a pair of one row? A pack's segments ascend with the slot
// and its padding (segment < 0) comes last, so each range's rows lie in
// the segments from its first slot's to its last's (to any, if the last
// is padding), and the two meet only where those ranges do.
__device__ __forceinline__ bool tile_meets(const int* __restrict__ meta_i32,
                                           size_t pack, int q0, int key0) {
  const int qlo = meta_i32[(pack + q0) * 3];
  const int klo = meta_i32[(pack + key0) * 3];
  if (qlo < 0 || klo < 0) return false;  // all padding
  int qhi = meta_i32[(pack + q0 + BQ - 1) * 3];
  int khi = meta_i32[(pack + key0 + KC - 1) * 3];
  qhi = qhi < 0 ? INT_MAX : qhi;
  khi = khi < 0 ? INT_MAX : khi;
  return qlo <= khi && klo <= qhi;
}

template <int D, bool FUNC, bool APPEND, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, APPEND ? 1 : TC_MIN_CTAS)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const float* __restrict__ pos_table,
                   const float* __restrict__ time_table,
                   const int* __restrict__ meta_i32,
                   const float* __restrict__ meta_f32,
                   const int* __restrict__ q_wl,
                   const int* __restrict__ q_rowptr,
                   const int* __restrict__ seg_rng, bf16* __restrict__ out,
                   int cap, int H, int L, int npb, int ntb, float scale,
                   float tb_denom, int use_pos, int use_time, int dense,
                   Window win) {
  constexpr int LD = D + PAD;
  constexpr int NT = D / 8;  // n8 tiles of the output per warp: all of D
  extern __shared__ __align__(16) unsigned char smem_tc[];
  SmemTC sm;
  layout_tc<D>(smem_tc, sm, npb, ntb);
  const int h = blockIdx.x;
  const int nb = cap / BQ;
  const int gp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t pack = (size_t)gp * cap;
  // APPEND: the window's q-block blockIdx.y of row gp, its keys and values
  // at the row's slot of the cache
  int qb, wp = 0, wt = 0;
  size_t kv_pack = pack;
  if constexpr (APPEND) {
    wp = win.pref[gp];
    wt = win.total[gp];
    qb = wp / BQ + (int)blockIdx.y;
    if (qb >= nb || qb * BQ >= wp + win.Q) return;  // past the window
    kv_pack = (size_t)win.rows[gp] * cap;
  } else {
    qb = nb - 1 - (int)blockIdx.y;
  }
  const int q0 = qb * BQ;

  if constexpr (APPEND) {
    // the window's queries at their rows of the q-block, zeros elsewhere
    constexpr int C8 = D / 8;
    const size_t row_stride = (size_t)H * D;
    for (int i = tid; i < BQ * C8; i += THREADS) {
      const int r = i / C8, c = i % C8;
      const int j = q0 + r - wp;
      bf16* dst = sm.q + r * LD + c * 8;
      if (j >= 0 && j < win.Q)
        cp_async16(dst, q + ((size_t)gp * win.Q + j) * row_stride +
                            (size_t)h * D + c * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    copy_rows_async<D, BQ>(sm.q, q, pack + q0, H, h);
  }
  for (int i = tid; i < npb; i += THREADS) sm.pt[i] = pos_table[i * H + h];
  for (int i = tid; i < ntb; i += THREADS) sm.tt[i] = time_table[i * H + h];
  // this thread's two rows (g and g + 8 of the warp's 16) and their
  // segment, timestamp and 1/(pos+1)
  int qseg[2], qts[2], qslot[2];
  float qninv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qslot[hr] = q0 + 16 * warp + g + 8 * hr;
    const size_t slot = pack + qslot[hr];
    if constexpr (APPEND) {
      qseg[hr] = window_seg(qslot[hr], wt);
      qts[hr] = win.ts[slot];
      qninv[hr] = window_ninv(win, qslot[hr], wt);
    } else {
      qseg[hr] = meta_i32[slot * 3 + 0];
      qts[hr] = meta_i32[slot * 3 + 2];
      qninv[hr] = meta_f32[slot];
    }
  }

  // this CTA's live 64-key sub-tiles in ascending order, as a flat index
  // i over its run (K1) or the dense grid (K8): k-block entry p0 + i / 2,
  // half i % 2; for the append launch the cold run of a one-row pack,
  // k-blocks 0..qb, and the sub-tiles that tile_meets would keep there
  const int* rng = seg_rng + (size_t)gp * nb * 2;
  int p0, p1;
  if constexpr (APPEND) {
    p0 = 0;
    p1 = qb + 1;
  } else {
    p0 = dense ? 0 : q_rowptr[gp * (nb + 1) + qb];
    p1 = dense ? nb : q_rowptr[gp * (nb + 1) + qb + 1];
  }
  const int end = 2 * (p1 - p0);
  auto key0_of = [&](int i) {
    const int p = p0 + (i >> 1);
    const int kb = APPEND || dense ? p : q_wl[((size_t)gp * L + p) * 2 + 1];
    return kb * BK + (i & 1) * KC;
  };
  auto next_live = [&](int i) {
    for (; i < end; ++i) {
      if constexpr (APPEND) {
        if (q0 >= wt || key0_of(i) >= wt) continue;
      } else {
        if (dense && !block_live<CAUSAL>(rng, qb, p0 + (i >> 1))) continue;
        if (!tile_meets(meta_i32, pack, q0, key0_of(i))) continue;
      }
      return i;
    }
    return end;
  };
  auto prefetch = [&](int i, int st) {
    const int key0 = key0_of(i);
    const size_t s0 = pack + key0;
    copy_rows_async<D, KC>(sm.k + st * KC * LD, k, kv_pack + key0, H, h);
    copy_rows_async<D, KC>(sm.v + st * KC * LD, v, kv_pack + key0, H, h);
    for (int r = tid; r < KC; r += THREADS) {
      if constexpr (APPEND) {
        sm.kseg[st * KC + r] = window_seg(key0 + r, wt);
        cp_async4(sm.kts + st * KC + r, win.ts + s0 + r);
      } else {
        cp_async4(sm.kseg + st * KC + r, meta_i32 + (s0 + r) * 3 + 0);
        cp_async4(sm.kts + st * KC + r, meta_i32 + (s0 + r) * 3 + 2);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // ldmatrix lane addressing: A (q rows) and B (k rows, keys x head dims)
  const int arow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
  // ... and v by ldmatrix.trans (keys x head dims, read as k x n)
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 8;

  int cur = next_live(0), st = 0;
  if (cur < end) prefetch(cur, 0);
  cp_async_commit();
  while (cur < end) {
    cp_async_wait_all();  // the q tile and this sub-tile have landed
    // ... for every thread, and the last sub-tile's readers are done with
    // the other stage
    __syncthreads();
    const int nxt = next_live(cur + 1);
    if (nxt < end) prefetch(nxt, st ^ 1);
    cp_async_commit();
    const int key0 = key0_of(cur);
    const bf16* K = sm.k + st * KC * LD;
    const bf16* V = sm.v + st * KC * LD;
    const int* kseg = sm.kseg + st * KC;
    const int* kts = sm.kts + st * KC;
    // the head's functional time parameters (FUNC: tt is (3, H))
    float amp = 0.0f, sigma = 1.0f, rho = 1.0f;
    if constexpr (FUNC) {
      amp = sm.tt[0];
      sigma = sm.tt[1];
      rho = sm.tt[2];
    }
#pragma unroll 1
    for (int kq = 0; kq < KC / 16; ++kq) {
      // s[nt][e]: row g + 8 (e >= 2) of the warp's 16, key 16 kq + 8 nt +
      // 2 t + (e & 1) of the sub-tile
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned aq[4], bk[4];
        ldsm_x4(aq, sm.q + arow * LD + 16 * kk + acol);
        ldsm_x4(bk, K + (16 * kq + brow) * LD + 16 * kk + bcol);
        mma16816(s[0], aq, bk[0], bk[1]);
        mma16816(s[1], aq, bk[2], bk[3]);
      }
      // the epilogue in registers; af is the A fragment of a for the 16
      // keys: a0 / a1 (rows g, g + 8) from n8 tile 0, a2 / a3 from tile 1
      unsigned af[4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float av[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 16 * kq + 8 * nt + 2 * t + e;
            const int kslot = key0 + c;
            float bias = 0.0f;
            if (use_pos)
              bias += sm.pt[min(max(qslot[hr] - kslot, 0), npb - 1)];
            if (use_time) {
              if constexpr (FUNC) {
                float zr, lnz;
                bias += __fmul_rn(
                    amp, functional_E(qts[hr], kts[c], sigma, rho, zr, lnz));
              } else {
                bias += sm.tt[time_bucket(qts[hr], kts[c], tb_denom, ntb)];
              }
            }
            const float x = s[nt][2 * hr + e] * scale + bias;
            // acausal: kslot - cap < 0 <= qslot always holds; written as
            // a comparison (not dropped) because without it ptxas spills
            // in the functional D = 128 kernel under the 128-register cap
            const bool live = qseg[hr] == kseg[c] && qseg[hr] >= 0 &&
                              qslot[hr] >= kslot - (CAUSAL ? 0 : cap);
            const float mw = live ? qninv[hr] : 0.0f;
            av[e] = x * (1.0f / (1.0f + expf(-x))) * mw;
          }
          af[nt * 2 + hr] = pack_bf16(av[0], av[1]);
        }
      }
      // out += a.v over the 16 keys
      const bf16* vr = V + (16 * kq + vrow) * LD + vcol;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bv[4];
        ldsm_x4_t(bv, vr + 16 * np);
        mma16816(acc[2 * np], af, bv[0], bv[1]);
        mma16816(acc[2 * np + 1], af, bv[2], bv[3]);
      }
    }
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait_all();

  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    size_t slot = pack + qslot[hr];
    if constexpr (APPEND) {  // the window's rows only
      const int w = qslot[hr] - wp;
      if (w < 0 || w >= win.Q) continue;
      slot = (size_t)gp * win.Q + w;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(out + slot * row_stride + (size_t)h * D
                                   + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * hr], acc[n][2 * hr + 1]);
  }
}

__global__ void time_bucket_kernel(const int* __restrict__ qts, int nq,
                                   const int* __restrict__ kts, int nk,
                                   float denom, int ntb,
                                   int* __restrict__ out) {
  size_t n = (size_t)nq * nk;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = time_bucket(qts[i / nk], kts[i % nk], denom, ntb);
}

// The kernel for (T, D, FUNC, APPEND, CAUSAL), launched on a grid of G
// packs (the append launch, causal only: G window rows of `nqb` q-blocks
// each; else nqb is cap/BQ).
template <typename T, int D, bool FUNC, bool APPEND, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* pt, const float* tt, const int* meta_i32,
                   const float* meta_f32, const int* q_wl,
                   const int* q_rowptr, const int* seg_rng, void* out, int G,
                   int cap, int H, int L, int npb, int ntb, float scale,
                   float tb_denom, int use_pos, int use_time, int dense,
                   const Window& win, int nqb, cudaStream_t stream) {
  // bf16: the tensor-core kernel; fp32: the FMA kernel
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static_assert(CAUSAL || !APPEND, "the append launch is causal only");
  SmemTC sizes;
  const int smem =
      TC ? (int)layout_tc<D>(nullptr, sizes, npb, ntb)
         : (int)((smem_floats_fixed<D>() + npb + ntb) * sizeof(float));
  auto kern = [] {
    if constexpr (TC)
      return attn_fwd_tc_kernel<D, FUNC, APPEND, CAUSAL>;
    else
      return attn_fwd_kernel<T, D, FUNC, APPEND, CAUSAL>;
  }();
  // Opt in to more than 48 KB of shared memory once per device, and again
  // only when longer bias tables need more than was set there before.
  static int smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  const dim3 grid = TC ? dim3(H, nqb, G) : dim3(nqb, H, G);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, tt, meta_i32, meta_f32, q_wl, q_rowptr,
      seg_rng, static_cast<T*>(out), cap, H, L, npb, ntb, scale, tb_denom,
      use_pos, use_time, dense, win);
  return cudaGetLastError();
}

template <typename T, bool APPEND, bool CAUSAL>
cudaError_t launch_dtype(int D, int func, const void* q, const void* k,
                         const void* v, const float* pt, const float* tt,
                         const int* meta_i32, const float* meta_f32,
                         const int* q_wl, const int* q_rowptr,
                         const int* seg_rng, void* out, int G, int cap, int H,
                         int L, int npb, int ntb, float scale,
                         float tb_denom, int use_pos, int use_time, int dense,
                         const Window& win, int nqb, cudaStream_t stream) {
#define JAF_CASE(DD)                                                       \
  case DD:                                                                 \
    return func ? launch<T, DD, true, APPEND, CAUSAL>(                     \
                      q, k, v, pt, tt, meta_i32, meta_f32, q_wl, q_rowptr, \
                      seg_rng, out, G, cap, H, L, npb, ntb, scale,         \
                      tb_denom, use_pos, use_time, dense, win, nqb,        \
                      stream)                                              \
                : launch<T, DD, false, APPEND, CAUSAL>(                    \
                      q, k, v, pt, tt, meta_i32, meta_f32, q_wl, q_rowptr, \
                      seg_rng, out, G, cap, H, L, npb, ntb, scale,         \
                      tb_denom, use_pos, use_time, dense, win, nqb,        \
                      stream);
  switch (D) {
    JAF_CASE(16)
    JAF_CASE(32)
    JAF_CASE(64)
    JAF_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef JAF_CASE
}

// The cold launch's instantiation for the plan's mask.
template <typename T>
cudaError_t launch_cold(int causal, int D, int func, const void* q,
                        const void* k, const void* v, const float* pt,
                        const float* tt, const int* meta_i32,
                        const float* meta_f32, const int* q_wl,
                        const int* q_rowptr, const int* seg_rng, void* out,
                        int G, int cap, int H, int L, int npb, int ntb,
                        float scale, float tb_denom, int use_pos,
                        int use_time, int dense, cudaStream_t stream) {
  const Window none = {};
  return causal
             ? launch_dtype<T, false, true>(
                   D, func, q, k, v, pt, tt, meta_i32, meta_f32, q_wl,
                   q_rowptr, seg_rng, out, G, cap, H, L, npb, ntb, scale,
                   tb_denom, use_pos, use_time, dense, none, cap / BQ, stream)
             : launch_dtype<T, false, false>(
                   D, func, q, k, v, pt, tt, meta_i32, meta_f32, q_wl,
                   q_rowptr, seg_rng, out, G, cap, H, L, npb, ntb, scale,
                   tb_denom, use_pos, use_time, dense, none, cap / BQ,
                   stream);
}

}  // namespace

// q, k, v, out: (G, cap, H, D) float32 (dtype 0) or bfloat16 (dtype 1);
// pos_table (npb, H), time_table (ntb, H) float32 - with time_functional
// set, the packed (3, H) [amp; sigma; rho]; meta_i32 (G, cap, 3);
// meta_f32 (G, cap, 1); q_wl (G, L, 2); q_rowptr (G, cap/128 + 1);
// seg_rng (G, cap/128, 2). With `dense` set (K8) the kernel walks the dense
// grid on seg_rng and reads neither q_wl nor q_rowptr; else (K1) it walks
// the work-list and reads no seg_rng. `causal`: the plan's mask (1: keys at
// or before the query; 0: every key of its row).
// Launches on the calling thread's current device, which the caller sets.
// Returns the launch's cudaError_t (0 on success).
extern "C" int jagged_attn_fwd(const void* q, const void* k, const void* v,
                               const float* pos_table,
                               const float* time_table, const int* meta_i32,
                               const float* meta_f32, const int* q_wl,
                               const int* q_rowptr, const int* seg_rng,
                               void* out, int G, int cap, int H, int D, int L,
                               int npb, int ntb, float scale, float tb_denom,
                               int use_pos, int use_time, int time_functional,
                               int dense, int causal, int dtype,
                               void* stream) {
  if (G <= 0 || cap <= 0 || cap % BQ != 0 || H <= 0 || L <= 0 || npb <= 0 ||
      ntb <= 0 || (time_functional && ntb != 3) ||
      (dense ? seg_rng == nullptr : (q_wl == nullptr || q_rowptr == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_cold<float>(
        causal, D, time_functional, q, k, v, pos_table, time_table,
        meta_i32, meta_f32, q_wl, q_rowptr, seg_rng, out, G, cap, H, L, npb,
        ntb, scale, tb_denom, use_pos, use_time, dense, s);
  else if (dtype == 1)
    e = launch_cold<__nv_bfloat16>(
        causal, D, time_functional, q, k, v, pos_table, time_table,
        meta_i32, meta_f32, q_wl, q_rowptr, seg_rng, out, G, cap, H, L, npb,
        ntb, scale, tb_denom, use_pos, use_time, dense, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// The append launch: q, out (R, Q, H, D); k_cache, v_cache (N+1, cap, H, D)
// of one layer, float32 (dtype 0) or bfloat16 (dtype 1); rows, pref, total
// (R,) int32: row r's slot, first window position p and live tokens
// T = p + n (p + Q <= cap); ts (R, cap) int32 the rows' timestamps; ninv
// (cap,) float32 1/(i+1); the tables as for jagged_attn_fwd. Writes every
// window row, 0 at positions at or past T. Returns the launch's
// cudaError_t (0 on success).
extern "C" int jagged_attn_fwd_append(
    const void* q, const void* k_cache, const void* v_cache,
    const float* pos_table, const float* time_table, const int* rows,
    const int* pref, const int* total, const int* ts, const float* ninv,
    void* out, int R, int Q, int cap, int H, int D, int npb, int ntb,
    float scale, float tb_denom, int use_pos, int use_time,
    int time_functional, int dtype, void* stream) {
  if (R <= 0 || Q <= 0 || cap <= 0 || cap % BQ != 0 || H <= 0 || npb <= 0 ||
      ntb <= 0 || (time_functional && ntb != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Window win = {rows, pref, total, ts, ninv, Q};
  // the most q-blocks a window of Q rows touches, wherever it starts
  int nqb = (Q + 2 * BQ - 2) / BQ;
  if (nqb > cap / BQ) nqb = cap / BQ;
  cudaError_t e;
  if (dtype == 0)
    e = launch_dtype<float, true, true>(
        D, time_functional, q, k_cache, v_cache, pos_table, time_table,
        nullptr, nullptr, nullptr, nullptr, nullptr, out, R, cap, H, 1, npb,
        ntb, scale, tb_denom, use_pos, use_time, 0, win, nqb, s);
  else if (dtype == 1)
    e = launch_dtype<__nv_bfloat16, true, true>(
        D, time_functional, q, k_cache, v_cache, pos_table, time_table,
        nullptr, nullptr, nullptr, nullptr, nullptr, out, R, cap, H, 1, npb,
        ntb, scale, tb_denom, use_pos, use_time, 0, win, nqb, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// out (nq, nk) int32: the forward kernel's time bucket of every pair.
extern "C" int jagged_attn_time_buckets(const int* qts, int nq,
                                        const int* kts, int nk, float denom,
                                        int ntb, int* out, void* stream) {
  if (nq <= 0 || nk <= 0 || ntb <= 0) return (int)cudaErrorInvalidValue;
  size_t n = (size_t)nq * nk;
  int blocks = (int)((n + 255) / 256);
  if (blocks > 65535) blocks = 65535;
  time_bucket_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      qts, nq, kts, nk, denom, ntb, out);
  return (int)cudaGetLastError();
}
