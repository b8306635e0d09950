// Negative logits over a materialised (T, R, D) negative tensor (K9), for
// Hopper (sm_90a): the §4.3.1 baseline of Table 7 and the per-segment
// logits of the segmented path.
//
// Replaces the TPU kernels of src/repro/kernels/neg_logits/kernel.py:
//   fwd_pallas (:31, body _fwd_kernel :23)
//     out[t, r]   = (sum_d o[t, d] * n[t, r, d]) * inv_tau          (fp32)
//   bwd_pallas (:57, body _bwd_kernel :47), with gs = g * inv_tau (fp32):
//     do[t, d]    = sum_r gs[t, r] * n[t, r, d]                      (fp32)
//     dn[t, r, d] = gs[t, r] * o[t, d], rounded once to n's dtype.
// o is fp32 or bf16; n is fp32, bf16 (the baseline: the master's rows cast
// to the model's dtype) or fp16 (the segmented path's fetch rounding).
//
// What bounds it on this card: bytes. The forward reads n once (2 bytes an
// element at T = 8192, R = 128, D = 1024: 2.15 GB, 0.64 ms at 3.35 TB/s)
// for 2 flops an element; the backward reads n and writes dn of the same
// size (4.3 GB, 1.3 ms) for 3 flops an element. Both are far below the
// ridge, so the design only has to keep the memory system busy.
//
// What the design does about it. The TPU walked segments of tokens in order
// with the segment's (seg, R, D) tile double-buffered in VMEM; the tokens
// are independent, so here a token's rows go to its own CTAs and nothing
// crosses CTAs.
// - Forward: each warp takes a few rows at a time; lanes read 16-byte
//   vectors of each row (neighbouring lanes on neighbouring addresses),
//   every row's loads in flight together and kept raw until the products,
//   beside the same vector of o[t] read through the cache (a token's rows
//   all read it; no shared-memory copy, no barrier); each lane sums its
//   products of a row in a fixed order and a fixed xor-shuffle tree sums
//   the lanes: the same bits from run to run, whatever the grid. The grid
//   is T x `split` CTAs, each taking R / split of the token's rows: the
//   wrapper raises `split` when T is small (a 128-token segment of the
//   segmented path would otherwise be 128 CTAs on 132 SMs, each warp
//   walking its 16 rows one after another), and then each warp's one group
//   of 4 rows is in flight at once (4 vectors a row).
// - Backward: one pass over n does both outputs, the thread that reads a
//   16-byte vector of n[t, r] adding it into do and writing dn[t, r] for
//   it. gs is the reference's g * inv_tau, taken first, and dn's product
//   is rounded once (__fmul_rn, no FMA contraction), so dn equals the plain
//   version's gs * o cast to n's dtype bit for bit. A CTA takes one token:
//   `split` groups of 128 threads, each thread a column vector of its
//   group's R / split rows, 8 rows' loads in flight at once. The wrapper
//   raises `split` when T is small: a 128-token segment was 128 CTAs of 128
//   threads, each thread walking all R rows with a few loads in flight
//   (held by latency, slower than torch.bmm plus the multiply). The
//   groups' do partials meet in shared memory, group 0 adding the others
//   in group order, rather than in a cluster of CTAs through distributed
//   shared memory: a token's rows fit one CTA of 512 threads, and 128 such
//   CTAs already fill 128 of the 132 SMs, so a cluster would add a launch
//   attribute and a cluster barrier for no more parallelism. With split 1
//   (T = 8192) each do is the r-order fmaf sum it was; with split > 1 it
//   is another fixed order (the same bits run to run).
// n is read with streaming loads and dn written with streaming stores:
// neither is read again.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int FWD_THREADS = 256;  // 8 warps, R / split rows of one token
constexpr int BWD_COLS = 128;     // a row group: a 16-byte column a thread
constexpr int BWD_MAX_SPLIT = 4;  // row groups a CTA (512 threads)
constexpr int BWD_ROWS = 8;       // rows a thread keeps in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// 16 bytes of T from floats, written once (evict first).
template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p,
                                        const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) e[i] = from_f32<T>(f[i]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// V elements of o as floats (V * sizeof(TO) bytes, aligned to that size
// up to 16), read through the cache: a token's rows all read them.
template <typename TO, int V>
__device__ __forceinline__ void load_o(const TO* __restrict__ p,
                                       float (&f)[V]) {
  constexpr int B = V * (int)sizeof(TO);
  static_assert(B == 8 || B == 16 || B == 32, "o vector size");
  uint4 u[B >= 16 ? B / 16 : 1];
  if constexpr (B == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    u[0] = make_uint4(w.x, w.y, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  const TO* e = reinterpret_cast<const TO*>(u);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
}

// ROWS: rows a warp keeps in flight together; UNROLL: 16-byte vectors of
// each of them per lane. 8 x 2 when a token's rows fill the card by
// themselves (T = 8192: bound by device memory); 4 x 4 for the split grid
// of small T, whose warps take one group of rows each and are held by
// latency (a 128-token segment: 32 rows a CTA).
template <typename TO, typename TN, int ROWS, int UNROLL>
__global__ void __launch_bounds__(FWD_THREADS)
neg_logits_fwd_kernel(const TO* __restrict__ o, const TN* __restrict__ n,
                      float* __restrict__ out, int R, int D, int split,
                      float inv_tau) {
  constexpr int V = 16 / sizeof(TN);
  const int t = blockIdx.x / split;
  const int per = (R + split - 1) / split;  // rows per CTA
  const int r_begin = (blockIdx.x % split) * per;
  const int r_end = min(R, r_begin + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / V;
  const TO* ot = o + (size_t)t * D;
  const TN* nt = n + (size_t)t * R * D;
  for (int r0 = r_begin + warp * ROWS; r0 < r_end;
       r0 += ROWS * (FWD_THREADS / 32)) {
    // rows r0 .. r0 + ROWS - 1 below r_end (uniform in the warp): their
    // 16-byte loads are issued together, kept raw until the products, and
    // each row is summed by the lanes in the order of a warp per row
    float acc[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j] = 0.0f;
#pragma unroll (UNROLL)
    for (int vi = lane; vi < nv; vi += 32) {
      uint4 raw[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (r0 + j < r_end)
          raw[j] = __ldcs(reinterpret_cast<const uint4*>(
              nt + (size_t)(r0 + j) * D + vi * V));
      float ov[V];
      load_o<TO, V>(ot + vi * V, ov);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (r0 + j < r_end) {
          const TN* el = reinterpret_cast<const TN*>(&raw[j]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[j] = fmaf(ov[e], to_f32(el[e]), acc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      if (lane == 0 && r0 + j < r_end)
        out[(size_t)t * R + r0 + j] = __fmul_rn(acc[j], inv_tau);
    }
  }
}

// One CTA per token: `split` groups of BWD_COLS threads, group y taking
// rows [y * per, (y + 1) * per) of the token (per = ceil(R / split)), each
// thread a 16-byte column vector of them, BWD_ROWS rows' loads issued
// together. Each group's do partial goes through shared memory and group 0
// adds the others' in group order.
template <typename TO, typename TN>
__global__ void __launch_bounds__(BWD_COLS * BWD_MAX_SPLIT)
neg_logits_bwd_kernel(const TO* __restrict__ o, const TN* __restrict__ n,
                      const float* __restrict__ g, float* __restrict__ dout,
                      TN* __restrict__ dn, int R, int D, int split,
                      float inv_tau) {
  constexpr int V = 16 / sizeof(TN);
  extern __shared__ float4 smem4[];
  float* gs_s = reinterpret_cast<float*>(smem4);  // R: g[t, :] * inv_tau
  float4* part = smem4 + (R + 3) / 4;  // (split - 1) x BWD_COLS x V floats
  const int t = blockIdx.x;
  const int col = threadIdx.x % BWD_COLS, grp = threadIdx.x / BWD_COLS;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    gs_s[r] = __fmul_rn(g[(size_t)t * R + r], inv_tau);
  __syncthreads();
  const int per = (R + split - 1) / split;
  const int r_begin = min(R, grp * per), r_end = min(R, r_begin + per);
  const int nv = D / V;
  const size_t base = (size_t)t * R * D;
  for (int v0 = 0; v0 < nv; v0 += BWD_COLS) {
    const int vi = v0 + col;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    if (vi < nv) {
      float ov[V];
      load_o<TO, V>(o + (size_t)t * D + vi * V, ov);
      for (int r0 = r_begin; r0 < r_end; r0 += BWD_ROWS) {
        uint4 raw[BWD_ROWS];
#pragma unroll
        for (int j = 0; j < BWD_ROWS; ++j)
          if (r0 + j < r_end)
            raw[j] = __ldcs(reinterpret_cast<const uint4*>(
                n + base + (size_t)(r0 + j) * D + vi * V));
#pragma unroll
        for (int j = 0; j < BWD_ROWS; ++j)
          if (r0 + j < r_end) {
            const float gs = gs_s[r0 + j];
            const TN* el = reinterpret_cast<const TN*>(&raw[j]);
            float d[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              acc[e] = fmaf(gs, to_f32(el[e]), acc[e]);
              d[e] = __fmul_rn(gs, ov[e]);
            }
            store16(dn + base + (size_t)(r0 + j) * D + vi * V, d);
          }
      }
    }
    if (split > 1) {
      if (grp > 0) {
        float4* mine = part + ((grp - 1) * BWD_COLS + col) * (V / 4);
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          mine[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                acc[4 * q + 3]);
      }
      __syncthreads();
      if (grp == 0)
        for (int y = 1; y < split; ++y) {
          const float4* p = part + ((y - 1) * BWD_COLS + col) * (V / 4);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            const float4 f = p[q];
            acc[4 * q] += f.x;
            acc[4 * q + 1] += f.y;
            acc[4 * q + 2] += f.z;
            acc[4 * q + 3] += f.w;
          }
        }
      __syncthreads();  // part is written again by the next columns
    }
    if (grp == 0 && vi < nv) {
      float4* dst = reinterpret_cast<float4*>(dout + (size_t)t * D + vi * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                             acc[4 * q + 3]);
    }
  }
}

template <typename TO, typename TN>
cudaError_t launch(bool bwd, const void* o, const void* n, const float* g,
                   float* out, float* dout, void* dn, int T, int R, int D,
                   int split, float inv_tau, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TN);
  if (D % V != 0 || (bwd && split > BWD_MAX_SPLIT))
    return cudaErrorInvalidValue;
  if (!bwd) {
    auto kern = split > 1 ? neg_logits_fwd_kernel<TO, TN, 4, 4>
                          : neg_logits_fwd_kernel<TO, TN, 8, 2>;
    kern<<<(unsigned)T * split, FWD_THREADS, 0, s>>>(
        static_cast<const TO*>(o), static_cast<const TN*>(n), out, R, D,
        split, inv_tau);
  } else {
    const int smem = ((R + 3) / 4 + (split - 1) * BWD_COLS * (V / 4)) * 16;
    neg_logits_bwd_kernel<TO, TN><<<T, BWD_COLS * split, smem, s>>>(
        static_cast<const TO*>(o), static_cast<const TN*>(n), g, dout,
        static_cast<TN*>(dn), R, D, split, inv_tau);
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_n(int n_dtype, bool bwd, const void* o, const void* n,
                     const float* g, float* out, float* dout, void* dn, int T,
                     int R, int D, int split, float inv_tau, cudaStream_t s) {
  switch (n_dtype) {
    case 0:
      return launch<TO, float>(bwd, o, n, g, out, dout, dn, T, R, D, split,
                               inv_tau, s);
    case 1:
      return launch<TO, __nv_bfloat16>(bwd, o, n, g, out, dout, dn, T, R, D,
                                       split, inv_tau, s);
    case 2:
      return launch<TO, __half>(bwd, o, n, g, out, dout, dn, T, R, D, split,
                                inv_tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int o_dtype, int n_dtype, bool bwd, const void* o,
             const void* n, const float* g, float* out, float* dout,
             void* dn, int T, int R, int D, int split, float inv_tau,
             void* stream) {
  if (T <= 0 || R <= 0 || D <= 0 || split <= 0 || split > R ||
      (long long)T * split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (o_dtype == 0)
    e = launch_n<float>(n_dtype, bwd, o, n, g, out, dout, dn, T, R, D, split,
                        inv_tau, s);
  else if (o_dtype == 1)
    e = launch_n<__nv_bfloat16>(n_dtype, bwd, o, n, g, out, dout, dn, T, R,
                                D, split, inv_tau, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// o (T, D) float32 (o_dtype 0) or bfloat16 (1); n (T, R, D) float32 (n_dtype
// 0), bfloat16 (1) or float16 (2), 16-byte aligned, D a multiple of a
// 16-byte vector of n; out (T, R) float32; `split` CTAs per token (1 .. R),
// which changes no bit of out. Launches on `stream`, on the calling
// thread's current device; returns the launch's cudaError_t.
extern "C" int neg_logits_fwd(const void* o, const void* n, float* out,
                              int T, int R, int D, int split, float inv_tau,
                              int o_dtype, int n_dtype, void* stream) {
  return dispatch(o_dtype, n_dtype, false, o, n, nullptr, out, nullptr,
                  nullptr, T, R, D, split, inv_tau, stream);
}

// The same o, n; g (T, R) float32; dout (T, D) float32; dn (T, R, D) in n's
// dtype; `split` row groups a token (1 .. min(R, 4)), whose do partials are
// added in group order: split 1 sums each do in r order.
extern "C" int neg_logits_bwd(const void* o, const void* n, const float* g,
                              float* dout, void* dn, int T, int R, int D,
                              int split, float inv_tau, int o_dtype,
                              int n_dtype, void* stream) {
  return dispatch(o_dtype, n_dtype, true, o, n, g, nullptr, dout, dn, T, R,
                  D, split, inv_tau, stream);
}
