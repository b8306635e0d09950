// The RAB's time bias, shared by K1-fwd (jagged_attn_fwd.cu) and K2
// (jagged_attn_bwd.cu), which must compute it bit for bit alike: fp32,
// true divisions, the precise logf/expf (no fast-math).
#pragma once

// The TPU kernel's time bucket (kernel.py _time_buckets), in fp32.
__device__ __forceinline__ int time_bucket(int qt, int kt, float denom,
                                           int ntb) {
  int dt = qt > kt ? qt - kt : kt - qt;
  float b = floorf(logf(1.0f + (float)dt) / denom);
  int tb = (int)b;
  return min(max(tb, 0), ntb - 1);
}

// FuXi's functional time encoder (kernel.py _functional_time_bias):
// returns E = exp(-z^rho), z = (float(|tq - tk|) + 1e-6) / sigma, and z^rho
// (as exp(rho * ln z)) and ln z through zr and lnz. |tq - tk| is taken in
// int32, then converted, as the TPU kernel does; the division is IEEE.
__device__ __forceinline__ float functional_E(int qt, int kt, float sigma,
                                              float rho, float& zr,
                                              float& lnz) {
  int dt = qt > kt ? qt - kt : kt - qt;
  float z = __fdiv_rn((float)dt + 1e-6f, sigma);
  lnz = logf(z);
  zr = expf(__fmul_rn(rho, lnz));
  return expf(-zr);
}
