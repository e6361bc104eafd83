// Element arithmetic and pivot-order helpers shared by the rrLU kernel
// (rrlu.cu) and the sharded elimination's step kernel (lu_sharded.cu), so
// that both round every element, and order every pivot candidate, alike,
// and reduce candidates across a warp the same way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Arithmetic of an element type T, and of its real type R (the pivot
// metric |a|^2, the magnitudes, err and the tolerances). Every operation is
// one correctly rounded intrinsic, so the plain version in
// tci_tpu_torch/ops/lu_kernel.py, which computes the same formulas one
// rounding at a time, agrees bitwise.
template <typename T>
struct Ops;

template <>
struct Ops<double> {
  using R = double;
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double nan() { return __longlong_as_double(0x7ff8000000000000ULL); }
  __device__ static double abs2(double a) { return __dmul_rn(a, a); }
  __device__ static double zero() { return 0.0; }
  __device__ static double one() { return 1.0; }
  __device__ static bool nonzero(double a) { return a != 0.0; }
};

template <>
struct Ops<float> {
  using R = float;
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
  __device__ static float abs2(float a) { return __fmul_rn(a, a); }
  __device__ static float zero() { return 0.0f; }
  __device__ static float one() { return 1.0f; }
  __device__ static bool nonzero(float a) { return a != 0.0f; }
};

// complex128 as (re, im) = (x, y), the layout of torch.complex128. The
// product is (ac - bd, ad + bc); the quotient is Smith's formula (no
// overflow or underflow of c^2 + d^2 where the quotient itself is
// representable); |z|^2 is re re + im im (tci_tpu's _abs2). Each is written
// on the real and imaginary parts, so that it rounds as the plain version
// does.
template <>
struct Ops<double2> {
  using R = double;
  __device__ static double2 mul(double2 a, double2 b) {
    return make_double2(__dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
                        __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x)));
  }
  __device__ static double2 sub(double2 a, double2 b) {
    return make_double2(__dsub_rn(a.x, b.x), __dsub_rn(a.y, b.y));
  }
  __device__ static double2 div(double2 a, double2 b) {
    double re, im, den;
    if (fabs(b.x) >= fabs(b.y)) {
      const double r = __ddiv_rn(b.y, b.x);
      den = __dadd_rn(b.x, __dmul_rn(b.y, r));
      re = __dadd_rn(a.x, __dmul_rn(a.y, r));
      im = __dsub_rn(a.y, __dmul_rn(a.x, r));
    } else {
      const double r = __ddiv_rn(b.x, b.y);
      den = __dadd_rn(__dmul_rn(b.x, r), b.y);
      re = __dadd_rn(__dmul_rn(a.x, r), a.y);
      im = __dsub_rn(__dmul_rn(a.y, r), a.x);
    }
    return make_double2(__ddiv_rn(re, den), __ddiv_rn(im, den));
  }
  __device__ static double abs2(double2 a) {
    return __dadd_rn(__dmul_rn(a.x, a.x), __dmul_rn(a.y, a.y));
  }
  __device__ static double2 zero() { return make_double2(0.0, 0.0); }
  __device__ static double2 one() { return make_double2(1.0, 0.0); }
  __device__ static bool nonzero(double2 a) { return a.x != 0.0 || a.y != 0.0; }
};

// The order of pivot candidates (metric v, position p): NaN above every
// value, then the larger value, then (equal values, or two NaNs) the
// smaller position. A strict total order, so every reduction tree picks the
// same winner.
template <typename R, typename P>
__device__ __forceinline__ bool ranks_above(R v, P p, R bv, P bp) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || p < bp);
  return v > bv || (v == bv && p < bp);
}

// max(a, b) that propagates NaN, as torch's maximum and amax do.
template <typename R>
__device__ __forceinline__ R nan_max(R a, R b) {
  return (b > a || b != b) ? b : a;
}

// Warp-wide argmax of candidates: every lane ends with the winner (a
// butterfly over a total order, so the lanes agree). K is the key's type:
// 32 bits in rrlu.cu's resident and cluster modes, 64 in its grid mode and
// in lu_sharded.cu.
template <typename T, typename K = unsigned>
__device__ __forceinline__ void warp_argmax(T& v, K& key) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const K okey = __shfl_xor_sync(0xffffffffu, key, off);
    if (ranks_above(ov, okey, v, key)) {
      v = ov;
      key = okey;
    }
  }
}

// v of lane `src`, in every lane.
__device__ __forceinline__ float shfl_from(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double shfl_from(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ double2 shfl_from(double2 v, int src) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, src),
                      __shfl_sync(0xffffffffu, v.y, src));
}

}  // namespace
