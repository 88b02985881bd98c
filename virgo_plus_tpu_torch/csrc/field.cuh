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

// a * b folded once, for a, b < 2^62: below 2^61 + 8, not canonical.
// From four 32x32->64 partial products, a b = hh 2^64 + mid 2^32 + ll
// with 2^61 = 1: 2^64 = 8, mid 2^32 = (mid >> 29) + ((mid << 32) & p) and
// ll = (ll & p) + (ll >> 61); their sum stays below 2^64.
__device__ __forceinline__ u64 mulp_fold(u64 a, u64 b) {
    const unsigned a0 = (unsigned)a, a1 = (unsigned)(a >> 32);
    const unsigned b0 = (unsigned)b, b1 = (unsigned)(b >> 32);
    const u64 ll = (u64)a0 * b0;
    const u64 mid = (u64)a0 * b1 + (u64)a1 * b0;   // < 2^63
    const u64 hh = (u64)a1 * b1;                   // < 2^60
    const u64 t = (hh << 3) + (mid >> 29) + ((mid << 32) & P) + (ll & P) + (ll >> 61);
    return (t & P) + (t >> 61);
}

// x < 2^64 folded once: congruent, below p + 8
__device__ __forceinline__ u64 fold(u64 x) { return (x & P) + (x >> 61); }

// the canonical representative of x < 2^64
__device__ __forceinline__ u64 canon(u64 x) {
    const u64 r = fold(x);
    return r >= P ? r - P : r;
}

// the field product of canonical x, y with each component folded once
// and not made canonical: below p + 8.  The three products folded
// (mulp_fold), then re = ac + 2p - bd and im = t + 4p - ac - bd, both
// below 2^64.
__device__ __forceinline__ F2 mul2_fold(F2 x, F2 y) {
    const u64 ac = mulp_fold(x.re, y.re);
    const u64 bd = mulp_fold(x.im, y.im);
    const u64 t = mulp_fold(x.re + x.im, y.re + y.im);
    return {fold(ac + (2 * P - bd)), fold(t + (4 * P - ac - bd))};
}

// mul2 with each component reduced once (mul2_fold, then one conditional
// subtraction).  The same field product, so on canonical inputs the same
// bits as mul2.
__device__ __forceinline__ F2 mul2_split(F2 x, F2 y) {
    const F2 r = mul2_fold(x, y);
    return {r.re >= P ? r.re - P : r.re, r.im >= P ? r.im - P : r.im};
}

}  // namespace vpt
