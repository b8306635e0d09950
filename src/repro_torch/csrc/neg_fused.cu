// Fused ID-driven negative-sampling recall path, forward (K3) and backward
// (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/neg_logits/fused.py:
// fwd_pallas (body _fwd_kernel) and bwd_pallas (body _bwd_kernel). Per
// segment of `seg` tokens, each with R negative ids:
//   logit[t, r] = sum_d o[t, d] * row(ids[t, r])[d] * inv_tau   (fp32;
//                 rows gathered by id from the fp16 shadow, or
//                 from an fp32 table with an optional fp16/bf16 rounding)
//   shared     = for e < expansion - 1, the R logits of source token
//                perms[e][t] of the same segment, valid-masked to NEG_POOL
//   K3: lse[t] = logsumexp over [pos[t] | logit[t, :] | shared]
//   K4: w[t, r]  = g[t] * exp(logit[t, r] - lse[t])
//                  + sum over e and consumers c with perms[e][c] == t of
//                    g[c] * exp(masked logit[t, r] - lse[c])
//       dpos[t]  = g[t] * exp(pos[t] - lse[t])
//       dout[t]  = sum_r (w[t, r] * row(ids[t, r])) * inv_tau
// The table gradient leaves as the weights w (the caller builds the grad
// rows w * o * inv_tau); neither the (T, R, D) rows nor the (T, R * k)
// logits ever reach device memory.
//
// What bounds it on this card: bytes. Each logit is a D-long dot product
// (2 flops per 2-byte fp16 element, 1 flop per byte), so the gathered rows
// (T * R * D * 2 bytes: 2.15 GB at T = 8192, R = 128, D = 1024) set the
// time at 3.35 TB/s; K3 and K4 each gather them once.
//
// What the design does about it.
// - K3: one CTA (16 warps) per segment, as the TPU grid's outer dimension.
//   A warp takes one token at a time, holds its o row in registers (8
//   elements per lane per 256 columns) and streams the token's R rows, two
//   at a time, with one 16-byte load per lane per 256 columns, reducing
//   each dot across the warp with shuffles. The segment's (seg, R) logits
//   live in shared memory (64 KB at seg = R = 128), and the logsumexp, the
//   valid mask and the sharing term are computed there: the sharing term
//   is an index by `perms`, not the TPU's one-hot matmul.
// - K4 needs no other token's logits: lse comes in from K3, so the weight
//   of row r of token t is its own logit, g and lse of t, and g and lse of
//   t's consumers. The TPU kernel rebuilt the segment's logits in a first
//   pass only because it took the weights over the whole (seg, R) tile at
//   once. Here the grid is over tokens (a warp each, BWD_WARPS tokens of a
//   segment per CTA: 1024 CTAs at T = 8192, two resident per SM), and a
//   warp gathers each row once, through a per-warp ring of rows in shared
//   memory that cp.async fills STAGES - 1 rows ahead; from the row in hand
//   it takes the logit, the weight and the row's term of dout with the
//   arithmetic of the two-pass kernel it replaced (the same lane-to-column
//   map, fmaf order, xor tree and weight expression), so w, dout and dpos
//   keep their bits. A warp lists its token's consumers once, ascending c
//   for each e, from ballots over the segment's staged perms, so any perms
//   (a source with several consumers or none) is taken, and a row's fold
//   costs one exp per consumer.
// Bit-identical from run to run: no atomics, every sum in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int THREADS = 512;         // K3: a CTA a segment
constexpr int WARPS = THREADS / 32;
constexpr int UNR = 2;               // K3: rows in flight per warp
constexpr int BWD_WARPS = 8;         // K4: tokens a CTA, one a warp
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int STAGES = 4;            // K4: rows in each warp's ring
constexpr float NEG_POOL = -1e30f;   // fused.py NEG_POOL

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// fp32 table rows fetched at half precision (fetch_round 1: fp16, 2: bf16)
__device__ __forceinline__ float fetch_round(float x, int mode) {
  if (mode == 1) return __half2float(__float2half_rn(x));
  if (mode == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Lane `lane` owns columns (c * 32 + lane) * 8 .. + 8 for c < NCH.
template <typename TT, int NCH>
__device__ __forceinline__ void load_row(const TT* row, int lane, int mode,
                                         float* x) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) load8(row + (c * 32 + lane) * 8, x + 8 * c);
  if (mode) {
#pragma unroll
    for (int i = 0; i < 8 * NCH; ++i) x[i] = fetch_round(x[i], mode);
  }
}

// The segment's (seg, R) logits into shared memory `lg`.
template <typename TO, typename TT, int NCH>
__device__ void segment_logits(const TO* __restrict__ o,
                               const TT* __restrict__ table,
                               const int* __restrict__ ids, float* lg,
                               int s, int seg, int R, float inv_tau,
                               int mode) {
  constexpr int D = NCH * 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < seg; t += WARPS) {
    const size_t tok = (size_t)s * seg + t;
    float ov[8 * NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      load8(o + tok * D + (c * 32 + lane) * 8, ov + 8 * c);
    const int* idr = ids + tok * R;
    for (int r = 0; r < R; r += UNR) {
      float x[UNR][8 * NCH];
#pragma unroll
      for (int u = 0; u < UNR; ++u)
        if (r + u < R)
          load_row<TT, NCH>(table + (size_t)idr[r + u] * D, lane, mode, x[u]);
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (r + u >= R) break;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < 8 * NCH; ++i) part = fmaf(ov[i], x[u][i], part);
        part = warp_sum(part);
        if (lane == 0) lg[t * R + r + u] = part * inv_tau;
      }
    }
  }
}

// logsumexp over [pos | own logits | shared logits] of token t.
__device__ float token_lse(const float* lg, const float* __restrict__ valid,
                           const int* perm_s, float pos, int s, int t,
                           int seg, int R, int expansion) {
  float m = pos;
  for (int r = 0; r < R; ++r) m = fmaxf(m, lg[t * R + r]);
  for (int e = 0; e + 1 < expansion; ++e) {
    const int src = perm_s[e * seg + t];
    const bool ok = valid[(size_t)s * seg + src] > 0.0f;
    for (int r = 0; r < R; ++r) m = fmaxf(m, ok ? lg[src * R + r] : NEG_POOL);
  }
  float sum = expf(pos - m);
  for (int r = 0; r < R; ++r) sum += expf(lg[t * R + r] - m);
  for (int e = 0; e + 1 < expansion; ++e) {
    const int src = perm_s[e * seg + t];
    const bool ok = valid[(size_t)s * seg + src] > 0.0f;
    for (int r = 0; r < R; ++r)
      sum += expf((ok ? lg[src * R + r] : NEG_POOL) - m);
  }
  return m + logf(sum);
}

__device__ void load_perms(int* perm_s, const int* __restrict__ perms, int s,
                           int E, int seg, int expansion) {
  const int n = (expansion - 1) * seg;
  for (int i = threadIdx.x; i < n; i += THREADS)
    perm_s[i] = perms[(size_t)s * E * seg + i];
}

template <typename TO, typename TT, int NCH>
__global__ void __launch_bounds__(THREADS, 1)
neg_fwd_kernel(const TO* __restrict__ o, const float* __restrict__ pos,
               const TT* __restrict__ table, const int* __restrict__ ids,
               const float* __restrict__ valid, const int* __restrict__ perms,
               float* __restrict__ lse, int seg, int R, int E, int expansion,
               float inv_tau, int mode) {
  extern __shared__ float smem[];
  float* lg = smem;
  int* perm_s = reinterpret_cast<int*>(lg + seg * R);
  const int s = blockIdx.x;
  load_perms(perm_s, perms, s, E, seg, expansion);
  segment_logits<TO, TT, NCH>(o, table, ids, lg, s, seg, R, inv_tau, mode);
  __syncthreads();
  for (int t = threadIdx.x; t < seg; t += THREADS) {
    const size_t tok = (size_t)s * seg + t;
    lse[tok] = token_lse(lg, valid, perm_s, pos[tok], s, t, seg, R,
                         expansion);
  }
}

// K4's ring: each lane copies, and later reads, exactly the 16-byte pieces
// of a row that load_row gives it, so a lane's slots are its own: no
// barrier between the copy, the read and the next copy into the slot.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TT, int NCH>
__device__ __forceinline__ void stage_row(TT* slot, const TT* row, int lane) {
  constexpr int PER = 16 / (int)sizeof(TT);  // elements in 16 bytes
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int k = 0; k < 8 / PER; ++k) {
      const int at = (c * 32 + lane) * 8 + k * PER;
      cp_async16(slot + at, row + at);
    }
}

// K4's shared memory in bytes: the warps' rings and ids, the segment's g
// and lse, its perms (then the consumer lists), each warp's consumer words
// and list bounds, and the warps' consumer counts.
size_t bwd_smem_bytes(int D, int tsize, int seg, int R, int expansion) {
  const size_t nsh = (size_t)(expansion - 1), nk = (seg + 31) / 32;
  return (size_t)BWD_WARPS * STAGES * D * tsize + (size_t)BWD_WARPS * R * 4 +
         2 * (size_t)seg * 4 + nsh * seg * 4 + BWD_WARPS * nsh * nk * 4 +
         BWD_WARPS * (nsh + 1) * 4 + BWD_WARPS * 4;
}

// One warp per token, BWD_WARPS tokens of one segment per CTA. The warp
// gathers each of its token's R rows once, through a ring of STAGES rows
// per warp filled by cp.async STAGES - 1 rows ahead, and from the row in
// hand takes the logit, the weight and the row's term of dout. The weight
// of row r needs only the token's own logit and the g and lse of the
// token itself and of its consumers (c with perms[e][c] == t), which the
// warp finds once: one ballot word per 32 c of each slot e, then a list of
// the consumers, ascending c for each e, written over the staged perms
// (a segment's (e, c) pairs each have one source, so the CTA's lists fit).
template <typename TO, typename TT, int NCH>
__global__ void __launch_bounds__(BWD_THREADS, 2)
neg_bwd_kernel(const TO* __restrict__ o, const float* __restrict__ pos,
               const TT* __restrict__ table, const int* __restrict__ ids,
               const float* __restrict__ valid, const int* __restrict__ perms,
               const float* __restrict__ lse, const float* __restrict__ g,
               float* __restrict__ w, float* __restrict__ dout,
               float* __restrict__ dpos, int seg, int R, int E,
               int expansion, float inv_tau, int mode) {
  constexpr int D = NCH * 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctas_per_seg = seg / BWD_WARPS;
  const int s = blockIdx.x / ctas_per_seg;
  const int t = (blockIdx.x % ctas_per_seg) * BWD_WARPS + warp;
  const size_t tok0 = (size_t)s * seg, tok = tok0 + t;
  const int nsh = expansion - 1, nk = (seg + 31) / 32;
  TT* rings = reinterpret_cast<TT*>(smem_raw);
  int* ids_all =
      reinterpret_cast<int*>(rings + (size_t)BWD_WARPS * STAGES * D);
  float* g_s = reinterpret_cast<float*>(ids_all + BWD_WARPS * R);
  float* lse_s = g_s + seg;
  int* perm_s = reinterpret_cast<int*>(lse_s + seg);
  unsigned* cons_all = reinterpret_cast<unsigned*>(perm_s + nsh * seg);
  int* eb_all = reinterpret_cast<int*>(cons_all + BWD_WARPS * nsh * nk);
  int* cnt_s = eb_all + BWD_WARPS * (nsh + 1);
  unsigned* cons = cons_all + warp * nsh * nk;
  int* eb = eb_all + warp * (nsh + 1);
  TT* ring = rings + (size_t)warp * STAGES * D;
  int* ids_s = ids_all + warp * R;
  for (int i = lane; i < R; i += 32) ids_s[i] = ids[tok * R + i];
  if (nsh > 0) {
    for (int i = threadIdx.x; i < seg; i += BWD_THREADS) {
      g_s[i] = g[tok0 + i];
      lse_s[i] = lse[tok0 + i];
    }
    for (int i = threadIdx.x; i < nsh * seg; i += BWD_THREADS)
      perm_s[i] = perms[(size_t)s * E * seg + i];
    __syncthreads();
    for (int e = 0; e < nsh; ++e)
      for (int k = 0; k < nk; ++k) {
        const int c = k * 32 + lane;
        const unsigned m = __ballot_sync(
            0xffffffffu, c < seg && perm_s[e * seg + c] == t);
        if (lane == 0) cons[e * nk + k] = m;
      }
    __syncwarp();
    // this warp's list at the sum of the earlier warps' counts, once every
    // warp's ballots have read perm_s
    int n_w = 0;
    for (int i = 0; i < nsh * nk; ++i) n_w += __popc(cons[i]);
    if (lane == 0) cnt_s[warp] = n_w;
    __syncthreads();
    int off = 0;
    for (int w2 = 0; w2 < warp; ++w2) off += cnt_s[w2];
    for (int e = 0; e < nsh; ++e) {
      if (lane == 0) eb[e] = off;
      for (int k = 0; k < nk; ++k) {
        const unsigned m = cons[e * nk + k];
        if ((m >> lane) & 1u)
          perm_s[off + __popc(m & ((1u << lane) - 1u))] = k * 32 + lane;
        off += __popc(m);
      }
    }
    if (lane == 0) eb[nsh] = off;
  }
  __syncwarp();
  const float g_t = g[tok], lse_t = lse[tok];
  if (lane == 0) dpos[tok] = g_t * expf(pos[tok] - lse_t);
  const bool valid_t = valid[tok] > 0.0f;
  float ov[8 * NCH], acc[8 * NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    load8(o + tok * D + (c * 32 + lane) * 8, ov + 8 * c);
#pragma unroll
  for (int i = 0; i < 8 * NCH; ++i) acc[i] = 0.0f;
  float w_lane = 0.0f;  // w[tok, r] of r = lane (mod 32), stored by 32s
  // the first STAGES - 1 steps only put rows in flight
  for (int r = 1 - STAGES; r < R; ++r) {
    const int ahead = r + STAGES - 1;
    if (ahead < R)  // the one gather of row `ahead`
      stage_row<TT, NCH>(ring + (ahead % STAGES) * D,
                         table + (size_t)ids_s[ahead] * D, lane);
    cp_async_commit();
    if (r < 0) continue;
    cp_async_wait<STAGES - 1>();  // row r has landed
    float x[8 * NCH];
    load_row<TT, NCH>(ring + (r % STAGES) * D, lane, mode, x);
    // the logit, as segment_logits takes it: lanes in i order, the xor
    // tree (the same bits in every lane), then 1/tau
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < 8 * NCH; ++i) part = fmaf(ov[i], x[i], part);
    const float l = __fmul_rn(warp_sum(part), inv_tau);
    // the weight, shared mass folded back onto its source row
    float wv = g_t * expf(l - lse_t);
    if (nsh > 0) {
      const float masked = valid_t ? l : NEG_POOL;
      for (int e = 0; e < nsh; ++e) {
        float fold = 0.0f;
        for (int j = eb[e]; j < eb[e + 1]; ++j) {
          const int c = perm_s[j];
          fold += g_s[c] * expf(masked - lse_s[c]);
        }
        wv += fold;
      }
    }
    if (lane == (r & 31)) w_lane = wv;
    if ((r & 31) == 31 || r == R - 1) {
      const int r0 = r & ~31;
      if (r0 + lane <= r) w[tok * R + r0 + lane] = w_lane;
    }
    // dout = sum_r (w * row) * inv_tau, in r order
#pragma unroll
    for (int i = 0; i < 8 * NCH; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(wv, x[i]), inv_tau));
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    float* dst = dout + tok * D + (c * 32 + lane) * 8;
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(acc[8 * c], acc[8 * c + 1], acc[8 * c + 2],
                    acc[8 * c + 3]);
    reinterpret_cast<float4*>(dst)[1] =
        make_float4(acc[8 * c + 4], acc[8 * c + 5], acc[8 * c + 6],
                    acc[8 * c + 7]);
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

struct Args {
  const void *o, *pos, *table, *ids, *valid, *perms, *lse, *g;
  void *out_lse, *w, *dout, *dpos;
  int n_seg, seg, R, E, expansion, mode;
  float inv_tau;
};

template <typename TO, typename TT, int NCH>
cudaError_t launch(bool backward, const Args& a, cudaStream_t stream) {
  const TO* o = static_cast<const TO*>(a.o);
  const TT* tb = static_cast<const TT*>(a.table);
  const float* pos = static_cast<const float*>(a.pos);
  const int* ids = static_cast<const int*>(a.ids);
  const float* valid = static_cast<const float*>(a.valid);
  const int* perms = static_cast<const int*>(a.perms);
  const size_t perm_words = (size_t)(a.expansion - 1) * a.seg;
  if (!backward) {
    const int smem = (int)(((size_t)a.seg * a.R + perm_words) * 4);
    static int set[MAX_DEVICES] = {};
    auto kern = neg_fwd_kernel<TO, TT, NCH>;
    cudaError_t e = set_smem((const void*)kern, smem, set);
    if (e != cudaSuccess) return e;
    kern<<<a.n_seg, THREADS, smem, stream>>>(
        o, pos, tb, ids, valid, perms, static_cast<float*>(a.out_lse), a.seg,
        a.R, a.E, a.expansion, a.inv_tau, a.mode);
    return cudaGetLastError();
  }
  const int smem =
      (int)bwd_smem_bytes(NCH * 256, (int)sizeof(TT), a.seg, a.R, a.expansion);
  static int set[MAX_DEVICES] = {};
  auto kern = neg_bwd_kernel<TO, TT, NCH>;
  cudaError_t e = set_smem((const void*)kern, smem, set);
  if (e != cudaSuccess) return e;
  kern<<<a.n_seg * (a.seg / BWD_WARPS), BWD_THREADS, smem, stream>>>(
      o, pos, tb, ids, valid, perms, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.g), static_cast<float*>(a.w),
      static_cast<float*>(a.dout), static_cast<float*>(a.dpos), a.seg, a.R,
      a.E, a.expansion, a.inv_tau, a.mode);
  return cudaGetLastError();
}

template <typename TO, typename TT>
cudaError_t launch_width(bool backward, int D, const Args& a,
                         cudaStream_t s) {
  switch (D) {
    case 256: return launch<TO, TT, 1>(backward, a, s);
    case 512: return launch<TO, TT, 2>(backward, a, s);
    case 768: return launch<TO, TT, 3>(backward, a, s);
    case 1024: return launch<TO, TT, 4>(backward, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// o_dtype: 0 float32, 1 bfloat16; table_dtype: 0 float32, 1 float16.
template <typename TO>
cudaError_t launch_table(bool backward, int table_dtype, int D,
                         const Args& a, cudaStream_t s) {
  switch (table_dtype) {
    case 0: return launch_width<TO, float>(backward, D, a, s);
    case 1: return launch_width<TO, __half>(backward, D, a, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool backward, int o_dtype, int table_dtype, int D,
             const Args& a, void* stream) {
  if (a.n_seg <= 0 || a.seg <= 0 || a.R <= 0 || a.expansion < 1 ||
      a.E < 1 || (a.mode != 0 && table_dtype != 0) ||
      (backward && a.seg % BWD_WARPS != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (o_dtype == 0)
    e = launch_table<float>(backward, table_dtype, D, a, s);
  else if (o_dtype == 1)
    e = launch_table<__nv_bfloat16>(backward, table_dtype, D, a, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// o (n_seg * seg, D); pos, valid, lse (n_seg * seg,) float32; table (V, D);
// ids (n_seg * seg * R,) int32 in [0, V); perms (n_seg, E, seg) int32 with
// E >= expansion - 1. D in {256, 512, 768, 1024}; 16-byte aligned rows.
// fetch_round: 0 none, 1 fp16, 2 bf16 (fp32 tables only). Returns the
// launch's cudaError_t.
extern "C" int neg_fused_fwd(const void* o, const float* pos,
                             const void* table, const int* ids,
                             const float* valid, const int* perms, float* lse,
                             int n_seg, int seg, int R, int D, int E,
                             int expansion, float inv_tau, int fetch_round,
                             int o_dtype, int table_dtype, void* stream) {
  Args a{o, pos, table, ids, valid, perms, nullptr, nullptr,
         lse, nullptr, nullptr, nullptr,
         n_seg, seg, R, E, expansion, fetch_round, inv_tau};
  return dispatch(false, o_dtype, table_dtype, D, a, stream);
}

// As neg_fused_fwd, plus lse and g (n_seg * seg,) float32 in; w
// (n_seg * seg, R), dout (n_seg * seg, D), dpos (n_seg * seg,) float32 out;
// seg a multiple of 8 (the tokens of a CTA).
extern "C" int neg_fused_bwd(const void* o, const float* pos,
                             const void* table, const int* ids,
                             const float* valid, const int* perms,
                             const float* lse, const float* g, float* w,
                             float* dout, float* dpos, int n_seg, int seg,
                             int R, int D, int E, int expansion,
                             float inv_tau, int fetch_round, int o_dtype,
                             int table_dtype, void* stream) {
  Args a{o, pos, table, ids, valid, perms, lse, g,
         nullptr, w, dout, dpos,
         n_seg, seg, R, E, expansion, fetch_round, inv_tau};
  return dispatch(true, o_dtype, table_dtype, D, a, stream);
}
