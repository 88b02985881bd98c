// X1: GF((2^61-1)^2) elementwise arithmetic on Hopper (sm_90a): the product
// (gf_mul) and the sum family (gf_lin: add, sub, neg, reduce_lazy).
//
// Replaces X1, which is no Pallas kernel: inside the JAX package's jitted
// programs XLA fuses each GF(p^2) product (virgo_plus_tpu/field/gf.py:151,
// with _mymult :103 and _cond_sub_p :99) and each add, reduce_lazy, sub and
// neg (:131-147) into one elementwise loop.  Written as PyTorch ops, a
// product is about 45 kernels and a sum 3-5; here each call is one launch.
//
// Bits.  Each kernel repeats the int64 steps of its plain twin in
// virgo_plus_tpu_torch/field/gf.py (mul_plain, add_plain, sub_plain,
// neg_plain, reduce_lazy_plain), through gf_int64.cuh, which the fused
// kernels gf_evaluate and fg_stage_tables share: so a kernel equals its
// twin on every int64 input, canonical or not.
//
// Layout.  The output is (P, d0, d1, d2, d3) contiguous (fewer axes are
// padded after the first with 1): for the product P = 2, the plane axis;
// the sums are elementwise, so their first axis may have any size (a mesh
// reduces (bl, K, 2, 3) round polynomials).  Each input comes as its
// first-axis stride and an element stride per axis, 0 where it is
// broadcast, so a (2, K, 1) challenge against (2, K, n) tables, or
// x[..., 0::2], is read in place without a copy.  The strides are kernel
// arguments, passed by value: no host-to-device copy, so a CUDA graph
// captures the launch.
//
// What bounds it on the H100: 48 bytes an element of a product or a binary
// sum (two inputs of 16 bytes, one output of 16), at 3.35 TB/s, against 12
// 32-bit multiplies a product.  Most calls on the main paths hold at most
// 64 elements and a few more than 65,536, so below some thousands of
// elements the launch itself (a few microseconds) bounds it.  One thread
// an element of a product, both planes read and both written; one a word
// of a sum; a grid-stride loop over at most MAX_BLOCKS blocks.
//
// Why CUDA and not Triton: the pass needs exact 64-bit wrap-around and
// signed and unsigned shifts on the same words, and the CUDA path, its
// loader and its launch counting are in place (kernels.py).
#include <cuda_runtime.h>
#include <stdint.h>
#include "gf_int64.cuh"

namespace {

using namespace vpt64;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

struct Layout {
    unsigned size[4];   // output sizes after the first axis
    i64 xs[5], ys[5];   // first-axis stride, then one stride per axis
};

// element i of the output -> offsets of its plane-0 words in x and y
__device__ __forceinline__ void offsets(const Layout& L, unsigned i, i64& ox, i64& oy) {
    const unsigned c3 = i % L.size[3];
    i /= L.size[3];
    const unsigned c2 = i % L.size[2];
    i /= L.size[2];
    const unsigned c1 = i % L.size[1];
    const unsigned c0 = i / L.size[1];
    ox = c0 * L.xs[1] + c1 * L.xs[2] + c2 * L.xs[3] + c3 * L.xs[4];
    oy = c0 * L.ys[1] + c1 * L.ys[2] + c2 * L.ys[3] + c3 * L.ys[4];
}

__global__ void __launch_bounds__(THREADS)
gf_mul(const u64* __restrict__ x, const u64* __restrict__ y, u64* __restrict__ out,
       unsigned n, Layout L) {
    for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) {
        i64 ox, oy;
        offsets(L, i, ox, oy);
        u64 re, im;
        mul(x[ox], x[ox + L.xs[0]], y[oy], y[oy + L.ys[0]], re, im);
        out[i] = re;
        out[n + i] = im;
    }
}

// word i = p n + j of the (P, n) output, p along the first axis
template <int OP>
__global__ void __launch_bounds__(THREADS)
gf_lin(const u64* __restrict__ x, const u64* __restrict__ y, u64* __restrict__ out,
       unsigned words, unsigned n, Layout L) {
    constexpr bool binary = OP == LIN_ADD || OP == LIN_SUB;
    for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < words;
         i += gridDim.x * THREADS) {
        const unsigned p = i / n;
        i64 ox, oy;
        offsets(L, i - p * n, ox, oy);
        out[i] = lin<OP>(x[ox + p * L.xs[0]], binary ? y[oy + p * L.ys[0]] : 0);
    }
}

Layout layout(int d0, int d1, int d2, int d3, i64 xp, i64 x0, i64 x1, i64 x2, i64 x3,
              i64 yp, i64 y0, i64 y1, i64 y2, i64 y3) {
    return Layout{{(unsigned)d0, (unsigned)d1, (unsigned)d2, (unsigned)d3},
                  {xp, x0, x1, x2, x3},
                  {yp, y0, y1, y2, y3}};
}

int blocks(int n) {
    const int b = (n + THREADS - 1) / THREADS;
    return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

}  // namespace

// out (2, n) = x * y, n = d0 d1 d2 d3 elements; one launch, none for n = 0.
extern "C" int vpt_gf_mul(const u64* x, const u64* y, u64* out, int n,
                          int d0, int d1, int d2, int d3,
                          i64 xp, i64 x0, i64 x1, i64 x2, i64 x3,
                          i64 yp, i64 y0, i64 y1, i64 y2, i64 y3, void* stream_ptr) {
    if (n <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    gf_mul<<<blocks(n), THREADS, 0, stream>>>(
        x, y, out, (unsigned)n, layout(d0, d1, d2, d3, xp, x0, x1, x2, x3, yp, y0, y1, y2, y3));
    return (int)cudaGetLastError();
}

// out (P, n) = op(x, y), op one of LIN_*, words = P n; y is not read by
// neg and reduce_lazy.  One launch, none for words = 0.
extern "C" int vpt_gf_lin(int op, const u64* x, const u64* y, u64* out, int words,
                          int d0, int d1, int d2, int d3,
                          i64 xp, i64 x0, i64 x1, i64 x2, i64 x3,
                          i64 yp, i64 y0, i64 y1, i64 y2, i64 y3, void* stream_ptr) {
    if (words <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const Layout L = layout(d0, d1, d2, d3, xp, x0, x1, x2, x3, yp, y0, y1, y2, y3);
    const unsigned w = (unsigned)words, n = (unsigned)d0 * d1 * d2 * d3;
    const int b = blocks(words);
    switch (op) {
        case LIN_ADD: gf_lin<LIN_ADD><<<b, THREADS, 0, stream>>>(x, y, out, w, n, L); break;
        case LIN_SUB: gf_lin<LIN_SUB><<<b, THREADS, 0, stream>>>(x, y, out, w, n, L); break;
        case LIN_NEG: gf_lin<LIN_NEG><<<b, THREADS, 0, stream>>>(x, y, out, w, n, L); break;
        case LIN_REDUCE: gf_lin<LIN_REDUCE><<<b, THREADS, 0, stream>>>(x, y, out, w, n, L); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
