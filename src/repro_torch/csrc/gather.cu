// Packed-index embedding row gather (K7), for Hopper (sm_90a): the forward
// of the jagged lookup (paper §4.1.2).
//
// Replaces the TPU kernel src/repro/kernels/jagged_lookup/kernel.py:
// gather_pallas (:57, body _gather_kernel :48), with the wrapper's clip,
// mask and cast around it (jagged_lookup/ops.py:170-178) fused in:
//   out[i, :] = ids[i] >= 0 ? cast(table[min(ids[i], V - 1), :]) : 0
// table fp32, bf16 or fp16; out fp32, bf16 or fp16 (the compute dtype).
// Each element is one conversion of the table's value (round to nearest
// even), so the output equals the plain version's gather, mask and cast bit
// for bit.
//
// What bounds it on this card: bytes, n * D * (table's + out's item size)
// and the ids; there is no arithmetic. At n = 8192 rows of 1024 from the
// fp32 master to bf16 that is 50 MB, some 15 us, so at the path's sizes a
// launch costs about as much as the work.
//
// What the design does about it. The TPU prefetched the ids into SMEM and
// let them drive one (1, D) DMA window per row, grid step by grid step. Here
// one warp copies one row: it reads its id once, and its lanes move the row
// in 16-byte vectors of the table (neighbouring lanes on neighbouring
// addresses), converting in registers and storing the converted vector in
// one piece. An id < 0 reads nothing (its row is written as zeros), and ids
// >= V read row V - 1, as the reference clips them, so no read leaves the
// table.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, a row each
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// One conversion from the table's type to the output's: identity when they
// match, else through fp32 (exact for every widening) with one rounding.
template <typename TO, typename TT> __device__ __forceinline__ TO conv(TT x);
template <> __device__ __forceinline__ float conv<float, float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float conv<float, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float conv<float, __half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ __nv_bfloat16
conv<__nv_bfloat16, float>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16
conv<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
conv<__nv_bfloat16, __half>(__half x) {
  return __float2bfloat16_rn(__half2float(x));
}
template <> __device__ __forceinline__ __half conv<__half, float>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __half
conv<__half, __nv_bfloat16>(__nv_bfloat16 x) {
  return __float2half_rn(__bfloat162float(x));
}
template <> __device__ __forceinline__ __half conv<__half, __half>(__half x) {
  return x;
}

// The converted vector of VT = 16 / sizeof(TT) outputs, stored in one
// piece of VT * sizeof(TO) bytes.
template <int BYTES> struct alignas(BYTES) Chunk {
  unsigned char b[BYTES];
};

template <typename TT, typename TO>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const TT* __restrict__ table, const int* __restrict__ ids,
              TO* __restrict__ out, int n, int V, int D) {
  constexpr int VT = 16 / sizeof(TT);
  using C = Chunk<VT * sizeof(TO)>;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int id = ids[row];
  const TT* src = table + (size_t)min(id, V - 1) * D;
  TO* dst = out + (size_t)row * D;
  for (int vi = lane; vi < D / VT; vi += 32) {
    C c;
    TO* e = reinterpret_cast<TO*>(&c);
    if (id >= 0) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + vi);
      const TT* t = reinterpret_cast<const TT*>(&u);
#pragma unroll
      for (int i = 0; i < VT; ++i) e[i] = conv<TO, TT>(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VT; ++i) e[i] = conv<TO, float>(0.0f);
    }
    reinterpret_cast<C*>(dst)[vi] = c;
  }
}

template <typename TT, typename TO>
cudaError_t launch(const void* table, const int* ids, void* out, int n,
                   int V, int D, cudaStream_t s) {
  if (D % (16 / sizeof(TT)) != 0) return cudaErrorInvalidValue;
  gather_kernel<TT, TO><<<(n + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const TT*>(table), ids, static_cast<TO*>(out), n, V, D);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t launch_out(int out_dtype, const void* table, const int* ids,
                       void* out, int n, int V, int D, cudaStream_t s) {
  switch (out_dtype) {
    case 0:
      return launch<TT, float>(table, ids, out, n, V, D, s);
    case 1:
      return launch<TT, __nv_bfloat16>(table, ids, out, n, V, D, s);
    case 2:
      return launch<TT, __half>(table, ids, out, n, V, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// table (V, D), 16-byte aligned, D a multiple of a 16-byte vector of it;
// ids (n,) int32; out (n, D). dtype codes: 0 float32, 1 bfloat16, 2
// float16. Launches on `stream`, on the calling thread's current device;
// returns the launch's cudaError_t (0 on success).
extern "C" int gather_rows(const void* table, const int* ids, void* out,
                           int n, int V, int D, int table_dtype,
                           int out_dtype, void* stream) {
  if (n <= 0 || V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (table_dtype) {
    case 0:
      e = launch_out<float>(out_dtype, table, ids, out, n, V, D, s);
      break;
    case 1:
      e = launch_out<__nv_bfloat16>(out_dtype, table, ids, out, n, V, D, s);
      break;
    case 2:
      e = launch_out<__half>(out_dtype, table, ids, out, n, V, D, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
