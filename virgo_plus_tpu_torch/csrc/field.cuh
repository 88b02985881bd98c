// GF((2^61-1)^2) arithmetic on native uint64_t for the port's CUDA kernels.
//
// Elements are canonical in [0, p) per component.  A base product is the
// 128-bit product from __umul64hi and a plain multiply, reduced by the
// Mersenne fold (x >> 61) + (x & p).  The extension product is the
// reference's 3-mult Karatsuba (fieldElement.cpp:49-78).  Every operation
// returns the canonical representative, so any order of additions gives
// the same bits as the JAX package and the reference.
#pragma once
#include <stdint.h>

namespace vpt {

typedef unsigned long long u64;
constexpr u64 P = 0x1FFFFFFFFFFFFFFFull;

struct F2 {
    u64 re, im;
};

__device__ __forceinline__ u64 addp(u64 a, u64 b) {
    u64 s = a + b;
    return s >= P ? s - P : s;
}

__device__ __forceinline__ u64 subp(u64 a, u64 b) {
    return a >= b ? a - b : a + (P - b);
}

// a * b mod p for a, b < 2^62 (the product is below 2^124)
__device__ __forceinline__ u64 mulp(u64 a, u64 b) {
    u64 lo = a * b;
    u64 hi = __umul64hi(a, b);
    u64 r = (lo & P) + ((lo >> 61) | (hi << 3));   // < 2^63 + 2^61
    r = (r & P) + (r >> 61);                         // < p + 5
    return r >= P ? r - P : r;
}

__device__ __forceinline__ F2 add2(F2 x, F2 y) {
    return {addp(x.re, y.re), addp(x.im, y.im)};
}

__device__ __forceinline__ F2 sub2(F2 x, F2 y) {
    return {subp(x.re, y.re), subp(x.im, y.im)};
}

__device__ __forceinline__ F2 mul2(F2 x, F2 y) {
    u64 ac = mulp(x.re, y.re);
    u64 bd = mulp(x.im, y.im);
    u64 t = mulp(x.re + x.im, y.re + y.im);
    return {subp(ac, bd), subp(subp(t, ac), bd)};
}

}  // namespace vpt
