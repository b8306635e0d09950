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
// functional mode, and states which bound binds. This first version does
// its math in fp32 FMA on the CUDA cores (67 TFLOP/s peak), so it is bound
// by those operations, far from either bound; wgmma/TMA tiles are later
// work.
//
// What the design does about it: the TPU grid ran the q-major work-list in
// order and carried an accumulator across grid steps with first/last flags.
// Here the list is read as CSR runs (q_rowptr, built in ops.py): one CTA per
// (q-block, head, pack) walks its own run of live k-blocks in parallel with
// the others, keeps the 128 x D fp32 accumulator in registers across the
// whole run, and writes its output once - zeros when the run is empty, so
// no output window is left unwritten. Each 128-key block is taken in two
// 64-key sub-tiles so Q, K, V, the weights and the bias tables fit in shared
// memory (about 165 KB at D = 128). The bias tables are indexed directly in
// shared memory; the TPU's one-hot matmul gathers are not needed. In the
// functional mode the head's (amp, sigma, rho) sit where the bucket table
// would, and the bias is computed per entry in fp32 with a true division
// and the precise logf/expf (no fast-math), as the plain version computes
// it. Dead pairs are never visited: the work-list holds live pairs only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <int D>
__host__ __device__ constexpr size_t smem_floats_fixed() {
  return (size_t)BQ * (D + 1)     // q tile, padded rows
         + (size_t)KC * (D + 1)   // k sub-tile, padded rows
         + (size_t)KC * D         // v sub-tile
         + (size_t)BQ * (KC + 1)  // weights a
         + 3 * BQ                 // q seg / ts / 1/n
         + 2 * KC;                // k seg / ts
}

template <typename T, int D, bool FUNC>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v,
                const float* __restrict__ pos_table,
                const float* __restrict__ time_table,
                const int* __restrict__ meta_i32,
                const float* __restrict__ meta_f32,
                const int* __restrict__ q_wl,
                const int* __restrict__ q_rowptr, T* __restrict__ out,
                int cap, int H, int L, int npb, int ntb, float scale,
                float tb_denom, int use_pos, int use_time) {
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

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int nb = cap / BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t row_stride = (size_t)H * D;
  const size_t pack = (size_t)g * cap;

  // this CTA's run of the q-major work-list
  const int p0 = q_rowptr[g * (nb + 1) + qb];
  const int p1 = q_rowptr[g * (nb + 1) + qb + 1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    size_t slot = pack + (size_t)qb * BQ + r;
    q_s[r * (D + 1) + d] = to_f32(q[slot * row_stride + (size_t)h * D + d]);
  }
  for (int r = tid; r < BQ; r += THREADS) {
    size_t slot = pack + (size_t)qb * BQ + r;
    qseg_s[r] = meta_i32[slot * 3 + 0];
    qts_s[r] = meta_i32[slot * 3 + 2];
    qninv_s[r] = meta_f32[slot];
  }
  for (int t = tid; t < npb; t += THREADS) pt_s[t] = pos_table[t * H + h];
  for (int t = tid; t < ntb; t += THREADS) tt_s[t] = time_table[t * H + h];

  float acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int p = p0; p < p1; ++p) {
    const int kb = q_wl[((size_t)g * L + p) * 2 + 1];
    for (int c = 0; c < BK / KC; ++c) {
      const int key0 = kb * BK + c * KC;  // first key slot of the sub-tile
      __syncthreads();  // the previous sub-tile's readers are done
      for (int i = tid; i < KC * D; i += THREADS) {
        int r = i / D, d = i % D;
        size_t src = (pack + key0 + r) * row_stride + (size_t)h * D + d;
        k_s[r * (D + 1) + d] = to_f32(k[src]);
        v_s[r * D + d] = to_f32(v[src]);
      }
      for (int r = tid; r < KC; r += THREADS) {
        size_t slot = pack + key0 + r;
        kseg_s[r] = meta_i32[slot * 3 + 0];
        kts_s[r] = meta_i32[slot * 3 + 2];
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
                            qslot >= kslot;
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
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[slot * row_stride + (size_t)h * D + tx + 16 * j] =
          from_f32<T>(acc[i][j]);
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

template <typename T, int D, bool FUNC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* pt, const float* tt, const int* meta_i32,
                   const float* meta_f32, const int* q_wl,
                   const int* q_rowptr, void* out, int G, int cap, int H,
                   int L, int npb, int ntb, float scale, float tb_denom,
                   int use_pos, int use_time, cudaStream_t stream) {
  const int smem =
      (int)((smem_floats_fixed<D>() + npb + ntb) * sizeof(float));
  auto kern = attn_fwd_kernel<T, D, FUNC>;
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
  dim3 grid(cap / BQ, H, G);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, tt, meta_i32, meta_f32, q_wl, q_rowptr,
      static_cast<T*>(out), cap, H, L, npb, ntb, scale, tb_denom, use_pos,
      use_time);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int D, int func, const void* q, const void* k,
                         const void* v, const float* pt, const float* tt,
                         const int* meta_i32, const float* meta_f32,
                         const int* q_wl, const int* q_rowptr, void* out,
                         int G, int cap, int H, int L, int npb, int ntb,
                         float scale, float tb_denom, int use_pos,
                         int use_time, cudaStream_t stream) {
#define JAF_CASE(DD)                                                       \
  case DD:                                                                 \
    return func ? launch<T, DD, true>(q, k, v, pt, tt, meta_i32, meta_f32, \
                                      q_wl, q_rowptr, out, G, cap, H, L,   \
                                      npb, ntb, scale, tb_denom, use_pos,  \
                                      use_time, stream)                    \
                : launch<T, DD, false>(q, k, v, pt, tt, meta_i32,          \
                                       meta_f32, q_wl, q_rowptr, out, G,   \
                                       cap, H, L, npb, ntb, scale,         \
                                       tb_denom, use_pos, use_time, stream);
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

}  // namespace

// q, k, v, out: (G, cap, H, D) float32 (dtype 0) or bfloat16 (dtype 1);
// pos_table (npb, H), time_table (ntb, H) float32 - with time_functional
// set, the packed (3, H) [amp; sigma; rho]; meta_i32 (G, cap, 3);
// meta_f32 (G, cap, 1); q_wl (G, L, 2); q_rowptr (G, cap/128 + 1).
// Launches on the calling thread's current device, which the caller sets.
// Returns the launch's cudaError_t (0 on success).
extern "C" int jagged_attn_fwd(const void* q, const void* k, const void* v,
                               const float* pos_table,
                               const float* time_table, const int* meta_i32,
                               const float* meta_f32, const int* q_wl,
                               const int* q_rowptr, void* out, int G, int cap,
                               int H, int D, int L, int npb, int ntb,
                               float scale, float tb_denom, int use_pos,
                               int use_time, int time_functional, int dtype,
                               void* stream) {
  if (G <= 0 || cap <= 0 || cap % BQ != 0 || H <= 0 || L <= 0 || npb <= 0 ||
      ntb <= 0 || (time_functional && ntb != 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_dtype<float>(D, time_functional, q, k, v, pos_table,
                            time_table, meta_i32, meta_f32, q_wl, q_rowptr,
                            out, G, cap, H, L, npb, ntb, scale, tb_denom,
                            use_pos, use_time, s);
  else if (dtype == 1)
    e = launch_dtype<__nv_bfloat16>(D, time_functional, q, k, v, pos_table,
                                    time_table, meta_i32, meta_f32, q_wl,
                                    q_rowptr, out, G, cap, H, L, npb, ntb,
                                    scale, tb_denom, use_pos, use_time, s);
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
