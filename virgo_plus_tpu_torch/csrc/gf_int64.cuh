// GF((2^61-1)^2) arithmetic on the int64 steps of the port's plain field ops
// (virgo_plus_tpu_torch/field/gf.py: mul_plain, add_plain, sub_plain,
// neg_plain, reduce_lazy_plain), for the kernels whose results must equal
// those ops' on any input.
//
// +, * and << wrap modulo 2^64; a shift the plain op makes on an int64 is
// arithmetic (sra), one it masks (_srl) logical; _cond_sub_p compares as
// int64.  So each function equals its plain twin on every int64 input,
// canonical or not.  field.cuh's mulp / mul2 reduce otherwise and assume
// inputs below 2^62: they give the same bits only on canonical inputs.
#pragma once
#include <stdint.h>

namespace vpt64 {

typedef unsigned long long u64;
typedef long long i64;

constexpr u64 MOD = 0x1FFFFFFFFFFFFFFFull;   // 2^61 - 1
constexpr u64 LO32 = 0xFFFFFFFFull;

// gf_lin's op codes, as gf.LIN_OPS
enum { LIN_ADD = 0, LIN_SUB = 1, LIN_NEG = 2, LIN_REDUCE = 3 };

// int64 >> s as PyTorch shifts an int64 (arithmetic)
__device__ __forceinline__ u64 sra(u64 x, int s) { return (u64)((i64)x >> s); }

// gf._cond_sub_p: torch.where(x >= MOD, x - MOD, x) on int64
__device__ __forceinline__ u64 cond_sub_p(u64 x) {
    return (i64)x >= (i64)MOD ? x - MOD : x;
}

// gf._mymult, step for step
__device__ __forceinline__ u64 mymult(u64 x, u64 y) {
    const u64 xl = x & LO32, xh = sra(x, 32);
    const u64 yl = y & LO32, yh = sra(y, 32);
    const u64 bd = xl * yl;
    const u64 ac = xh * yh;
    const u64 ad_bc = xh * yl + xl * yh;
    const u64 hi = ac + sra(ad_bc + (bd >> 32), 32);
    const u64 lo = bd + (ad_bc << 32);
    return ((hi << 3) | (lo >> 61)) + (lo & MOD);
}

// gf.mul_plain: (a + bi)(c + di), 3-mult Karatsuba
__device__ __forceinline__ void mul(u64 a, u64 b, u64 c, u64 d, u64& re, u64& im) {
    const u64 all_prod = mymult(a + b, c + d);
    const u64 ac = mymult(a, c);
    const u64 bd = mymult(b, d);
    const u64 nac = cond_sub_p(ac) ^ MOD;
    const u64 nbd = cond_sub_p(bd) ^ MOD;
    const u64 t = all_prod + nac + nbd;
    im = cond_sub_p((t >> 61) + (t & MOD));
    re = cond_sub_p(cond_sub_p(ac + nbd));
}

// gf.add_plain, sub_plain, neg_plain, reduce_lazy_plain on one plane
template <int OP>
__device__ __forceinline__ u64 lin(u64 x, u64 y) {
    if constexpr (OP == LIN_ADD) return cond_sub_p(x + y);
    if constexpr (OP == LIN_SUB) return cond_sub_p(x + (y ^ MOD));
    if constexpr (OP == LIN_NEG) return cond_sub_p(x ^ MOD);
    return cond_sub_p((x >> 61) + (x & MOD));
}

// An element as its two plane words, and the ops above on elements
struct E {
    u64 re, im;
};

__device__ __forceinline__ E mul(E x, E y) {
    E r;
    mul(x.re, x.im, y.re, y.im, r.re, r.im);
    return r;
}

__device__ __forceinline__ E add(E x, E y) {
    return {lin<LIN_ADD>(x.re, y.re), lin<LIN_ADD>(x.im, y.im)};
}

__device__ __forceinline__ E sub(E x, E y) {
    return {lin<LIN_SUB>(x.re, y.re), lin<LIN_SUB>(x.im, y.im)};
}

// element i of (2, plane) words
__device__ __forceinline__ E load(const u64* p, i64 plane, i64 i) {
    return {p[i], p[plane + i]};
}

__device__ __forceinline__ void store(u64* p, i64 plane, i64 i, E x) {
    p[i] = x.re;
    p[plane + i] = x.im;
}

}  // namespace vpt64
