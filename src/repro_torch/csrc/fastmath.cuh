// Bitwise-pinned tracker math on the card: the CUDA flavour of
// repro_torch/core/fastmath.py (np_* / t_*), the same algorithms with
// every rounding written out, so that a kernel built from these gives the
// numpy host tracker's f32 bits.
//
//   fm_fmadd   one fused multiply-add (__fmaf_rn): the only multiply that
//              feeds an add without its own rounding;
//   fm_exp     Cody-Waite reduction + the Cephes expf polynomial; every
//              step an fm_fmadd or an exact op (floorf, the clamps, the
//              power of two built from integer exponent bits);
//   fm_sigmoid 1 / (1 + exp(-x)), x clamped to [-30, 30];
//   fm_tanh    2 * sigmoid(2x) - 1;
//   fm_log1p_int  table lookup over integer frame gaps;
//   fm_dot     the pinned matmul column: from 0, acc + a[k] * w[k] in
//              ascending k, the product and the sum each rounded.
//
// Products and sums go through __fmul_rn / __fadd_rn / __fsub_rn and
// quotients through __fdiv_rn, which nvcc never contracts or
// approximates; the sources that include this header are built with
// -fmad=false as well, so a plain operator missed here cannot fuse.
// Never build them with --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2Hi = 0.693359375f;
constexpr float kLn2Lo = -2.12194440e-4f;
constexpr float kP0 = 1.9875691500e-4f;
constexpr float kP1 = 1.3981999507e-3f;
constexpr float kP2 = 8.3334519073e-3f;
constexpr float kP3 = 4.1665795894e-2f;
constexpr float kP4 = 1.6666665459e-1f;
constexpr float kP5 = 5.0000001201e-1f;
constexpr float kExpLo = -87.0f;
constexpr float kExpHi = 88.0f;
constexpr float kSigClamp = 30.0f;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float pow2(float k) {
  return __int_as_float((__float2int_rz(k) + 127) << 23);
}

__device__ __forceinline__ float exp(float x) {
  x = fminf(fmaxf(x, kExpLo), kExpHi);
  const float k = floorf(fmadd(x, kLog2e, 0.5f));
  float r = fmadd(k, -kLn2Hi, x);
  r = fmadd(k, -kLn2Lo, r);
  float p = fmadd(kP0, r, kP1);
  p = fmadd(p, r, kP2);
  p = fmadd(p, r, kP3);
  p = fmadd(p, r, kP4);
  p = fmadd(p, r, kP5);
  const float s = __fadd_rn(fmadd(p, __fmul_rn(r, r), r), 1.0f);
  return __fmul_rn(s, pow2(k));
}

__device__ __forceinline__ float sigmoid(float x) {
  x = fminf(fmaxf(x, -kSigClamp), kSigClamp);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, fm::exp(-x)));
}

__device__ __forceinline__ float tanh(float x) {
  return __fsub_rn(__fmul_rn(2.0f, sigmoid(__fmul_rn(2.0f, x))), 1.0f);
}

// log1p(te) for an integer-valued gap te >= 0; gaps past the table clamp
// to its last entry (float -> int truncates, as numpy's astype does)
__device__ __forceinline__ float log1p_int(float te, const float* table,
                                           int n_table) {
  int idx = __float2int_rz(te);
  idx = idx < 0 ? 0 : (idx > n_table - 1 ? n_table - 1 : idx);
  return table[idx];
}

// one output column of the pinned matmul: sum over k < n of a[k] * w[k *
// ldw] from 0, each product and each partial sum rounded; ``acc`` lets a
// caller continue an accumulation it started (the same order)
__device__ __forceinline__ float dot(const float* a, const float* w, int n,
                                     int ldw, float acc = 0.0f) {
  for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, __fmul_rn(a[k], w[k * ldw]));
  return acc;
}

}  // namespace fm
