// Rounded arithmetic of the real Schur solver's kernels (schur_chase.cu,
// schur_window.cu): every product, sum, difference, quotient and square
// root rounded on its own (no contraction into fused multiply-adds), so
// that a kernel repeats its plain PyTorch version operation for
// operation and agrees with it to the bit.

#pragma once

#include <cuda_runtime.h>

namespace schur_rn {

#define SCHUR_DEV __device__ __forceinline__
SCHUR_DEV float mul(float a, float b) { return __fmul_rn(a, b); }
SCHUR_DEV float add(float a, float b) { return __fadd_rn(a, b); }
SCHUR_DEV float sub(float a, float b) { return __fsub_rn(a, b); }
SCHUR_DEV float dvd(float a, float b) { return __fdiv_rn(a, b); }
SCHUR_DEV float sqr(float a) { return __fsqrt_rn(a); }
SCHUR_DEV float rcp(float a) { return __frcp_rn(a); }
SCHUR_DEV double mul(double a, double b) { return __dmul_rn(a, b); }
SCHUR_DEV double add(double a, double b) { return __dadd_rn(a, b); }
SCHUR_DEV double sub(double a, double b) { return __dsub_rn(a, b); }
SCHUR_DEV double dvd(double a, double b) { return __ddiv_rn(a, b); }
SCHUR_DEV double sqr(double a) { return __dsqrt_rn(a); }
SCHUR_DEV double rcp(double a) { return __drcp_rn(a); }

// the smallest normal number: a smaller |v|^2 counts as zero
SCHUR_DEV float tiny(float) { return 0x1p-126f; }
SCHUR_DEV double tiny(double) { return 0x1p-1022; }
// the machine epsilon (torch.finfo(dtype).eps)
SCHUR_DEV float eps(float) { return 0x1p-23f; }
SCHUR_DEV double eps(double) { return 0x1p-52; }

// tiny / eps, the absolute deflation floor
SCHUR_DEV float tiny_over_eps(float) { return 0x1p-103f; }
SCHUR_DEV double tiny_over_eps(double) { return 0x1p-970; }
SCHUR_DEV float mag(float a) { return fabsf(a); }
SCHUR_DEV double mag(double a) { return fabs(a); }

// PyTorch's `2.0 / t` is `t.reciprocal() * 2.0`: two roundings
template <typename T>
SCHUR_DEV T two_over(T a) {
  return mul(rcp(a), T(2));
}

// torch.maximum: NaN if either operand is NaN
template <typename T>
SCHUR_DEV T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

}  // namespace schur_rn
