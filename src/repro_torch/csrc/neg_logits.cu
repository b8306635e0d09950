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
// are independent, so here every token is its own CTA and nothing crosses
// CTAs. Forward: o[t] sits in shared memory in fp32; each warp takes rows
// r, lanes read 16-byte vectors of the row (neighbouring lanes on
// neighbouring addresses), each lane sums its products in a fixed order,
// and a fixed xor-shuffle tree sums the lanes: the same bits from run to
// run. Backward: one pass over n does both outputs; each thread owns a
// 16-byte column vector of the token, walks r in order for do, and writes
// dn[t, r] for the same vector as it goes. gs is the reference's g * inv_tau,
// taken first, and dn's product is rounded once (__fmul_rn, no FMA
// contraction), so dn equals the plain version's gs * o cast to n's dtype bit
// for bit. n is read with streaming loads and dn written with streaming
// stores: neither is read again.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int FWD_THREADS = 256;  // 8 warps, one token
constexpr int BWD_THREADS = 128;  // one token, a 16-byte column per thread

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

// 16 bytes of T as floats, read once (evict first).
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p,
                                       float (&f)[16 / sizeof(T)]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) f[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p,
                                        const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) e[i] = from_f32<T>(f[i]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

template <typename TO, typename TN>
__global__ void __launch_bounds__(FWD_THREADS)
neg_logits_fwd_kernel(const TO* __restrict__ o, const TN* __restrict__ n,
                      float* __restrict__ out, int R, int D,
                      float inv_tau) {
  constexpr int V = 16 / sizeof(TN);
  extern __shared__ float o_s[];  // D floats
  const int t = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += FWD_THREADS)
    o_s[d] = to_f32(o[(size_t)t * D + d]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / V;
  const TN* nt = n + (size_t)t * R * D;
  for (int r = warp; r < R; r += FWD_THREADS / 32) {
    const TN* row = nt + (size_t)r * D;
    float acc = 0.0f;
#pragma unroll 4
    for (int vi = lane; vi < nv; vi += 32) {
      float f[V];
      load16(row + vi * V, f);
#pragma unroll
      for (int e = 0; e < V; ++e) acc = fmaf(o_s[vi * V + e], f[e], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[(size_t)t * R + r] = __fmul_rn(acc, inv_tau);
  }
}

template <typename TO, typename TN>
__global__ void __launch_bounds__(BWD_THREADS)
neg_logits_bwd_kernel(const TO* __restrict__ o, const TN* __restrict__ n,
                      const float* __restrict__ g, float* __restrict__ dout,
                      TN* __restrict__ dn, int R, int D, float inv_tau) {
  constexpr int V = 16 / sizeof(TN);
  extern __shared__ float gs_s[];  // R floats: g[t, :] * inv_tau
  const int t = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += BWD_THREADS)
    gs_s[r] = __fmul_rn(g[(size_t)t * R + r], inv_tau);
  __syncthreads();
  const int nv = D / V;
  const size_t base = (size_t)t * R * D;
  for (int vi = threadIdx.x; vi < nv; vi += BWD_THREADS) {
    float ov[V], acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      ov[e] = to_f32(o[(size_t)t * D + vi * V + e]);
      acc[e] = 0.0f;
    }
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float gs = gs_s[r];
      const size_t at = base + (size_t)r * D + vi * V;
      float f[V], d[V];
      load16(n + at, f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] = fmaf(gs, f[e], acc[e]);
        d[e] = __fmul_rn(gs, ov[e]);
      }
      store16(dn + at, d);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dout[(size_t)t * D + vi * V + e] = acc[e];
  }
}

template <typename TO, typename TN>
cudaError_t launch(bool bwd, const void* o, const void* n, const float* g,
                   float* out, float* dout, void* dn, int T, int R, int D,
                   float inv_tau, cudaStream_t s) {
  if (D % (16 / sizeof(TN)) != 0) return cudaErrorInvalidValue;
  if (!bwd) {
    neg_logits_fwd_kernel<TO, TN>
        <<<T, FWD_THREADS, D * sizeof(float), s>>>(
            static_cast<const TO*>(o), static_cast<const TN*>(n), out, R, D,
            inv_tau);
  } else {
    neg_logits_bwd_kernel<TO, TN>
        <<<T, BWD_THREADS, R * sizeof(float), s>>>(
            static_cast<const TO*>(o), static_cast<const TN*>(n), g, dout,
            static_cast<TN*>(dn), R, D, inv_tau);
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_n(int n_dtype, bool bwd, const void* o, const void* n,
                     const float* g, float* out, float* dout, void* dn, int T,
                     int R, int D, float inv_tau, cudaStream_t s) {
  switch (n_dtype) {
    case 0:
      return launch<TO, float>(bwd, o, n, g, out, dout, dn, T, R, D, inv_tau,
                               s);
    case 1:
      return launch<TO, __nv_bfloat16>(bwd, o, n, g, out, dout, dn, T, R, D,
                                       inv_tau, s);
    case 2:
      return launch<TO, __half>(bwd, o, n, g, out, dout, dn, T, R, D,
                                inv_tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int o_dtype, int n_dtype, bool bwd, const void* o,
             const void* n, const float* g, float* out, float* dout,
             void* dn, int T, int R, int D, float inv_tau, void* stream) {
  if (T <= 0 || R <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (o_dtype == 0)
    e = launch_n<float>(n_dtype, bwd, o, n, g, out, dout, dn, T, R, D,
                        inv_tau, s);
  else if (o_dtype == 1)
    e = launch_n<__nv_bfloat16>(n_dtype, bwd, o, n, g, out, dout, dn, T, R,
                                D, inv_tau, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// o (T, D) float32 (o_dtype 0) or bfloat16 (1); n (T, R, D) float32 (n_dtype
// 0), bfloat16 (1) or float16 (2), 16-byte aligned, D a multiple of a
// 16-byte vector of n; out (T, R) float32. Launches on `stream`, on the
// calling thread's current device; returns the launch's cudaError_t.
extern "C" int neg_logits_fwd(const void* o, const void* n, float* out,
                              int T, int R, int D, float inv_tau, int o_dtype,
                              int n_dtype, void* stream) {
  return dispatch(o_dtype, n_dtype, false, o, n, nullptr, out, nullptr,
                  nullptr, T, R, D, inv_tau, stream);
}

// The same o, n; g (T, R) float32; dout (T, D) float32; dn (T, R, D) in n's
// dtype.
extern "C" int neg_logits_bwd(const void* o, const void* n, const float* g,
                              float* dout, void* dn, int T, int R, int D,
                              float inv_tau, int o_dtype, int n_dtype,
                              void* stream) {
  return dispatch(o_dtype, n_dtype, true, o, n, g, nullptr, dout, dn, T, R,
                  D, inv_tau, stream);
}
