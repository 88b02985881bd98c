// K1: the GKR sumcheck fold on Hopper (sm_90a).
//
// Replaces the TPU kernel virgo_plus_tpu/pallas_kernels/sumcheck_fold.py
// (_fold_call :118, body _make_kernel :71, entry
// scan_sumcheck_batched_pallas :179).  It computes the same thing as
// virgo_plus_tpu_torch/gkr/sumcheck.py:fold_plain: all bl rounds of the
// sumcheck for K independent tables (v, a, m) of 2^bl elements.  Per round
// and natural pair (2i, 2i+1):
//     pa = dm*dv,  pb = dm*v0 + m0*dv + da,  pc = m0*v0 + a0
// summed over the pairs, then every pair is bound at the round challenge:
//     v' = v0 + dv*r  (same for a, m).
//
// What is dropped from the TPU design: the u32 limb planes, the 16-bit digit
// sums and the bit-reversal gather, which exist because Mosaic has no 64-bit
// integers.  Here the field is native uint64_t (field.cuh).
//
// Design (simple first): one launch per round over (pairs x K), one thread
// per pair.  The thread writes its bound values into a ping-pong buffer and
// its six coefficient words go through a warp-shuffle + shared-memory tree
// reduction; a second small launch sums the block partials of each table.
// Every addition reduces mod p, so the sums are canonical and the order of
// the reduction does not change a bit (no 64-bit atomicAdd, which would
// wrap mod 2^64).  2 * bl launches per call.
//
// Bound on the H100: each round reads the live half of three tables and
// writes a quarter; over all rounds the data is read about twice
// (3 tables * 16 B * 2^bl * K in, bound out).  Seven extension products per
// pair per round (21 64x64->128-bit products) make it close to balanced
// between memory and the integer-multiply rate; at the main path's shapes
// (2^13 entries, up to 26 tables) the 2*bl launches dominate.  A
// shared-memory-resident tail that finishes the small rounds in one block
// is the planned redesign.
#include <cuda_runtime.h>
#include "field.cuh"

using vpt::F2;
using vpt::u64;

namespace {

constexpr int THREADS = 256;  // the wrapper sizes `partials` from it (FOLD_THREADS)

__device__ __forceinline__ void block_reduce6(u64 acc[6], u64 (*sh)[THREADS / 32]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < 6; ++t)
            acc[t] = vpt::addp(acc[t], __shfl_down_sync(0xffffffffu, acc[t], off));
    }
    if (lane == 0) {
#pragma unroll
        for (int t = 0; t < 6; ++t) sh[t][warp] = acc[t];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int t = 0; t < 6; ++t) acc[t] = lane < THREADS / 32 ? sh[t][lane] : 0ull;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int t = 0; t < 6; ++t)
                acc[t] = vpt::addp(acc[t], __shfl_down_sync(0xffffffffu, acc[t], off));
        }
    }
}

__device__ __forceinline__ void load_pair(const u64* __restrict__ src, size_t plane,
                                          size_t off, F2& x0, F2& x1) {
    const ulonglong2 re = *reinterpret_cast<const ulonglong2*>(src + off);
    const ulonglong2 im = *reinterpret_cast<const ulonglong2*>(src + plane + off);
    x0 = {re.x, im.x};
    x1 = {re.y, im.y};
}

// src tables: (2, K, n); dst tables: (2, K, n/2); partials: (K, gridDim.x, 6)
__global__ void fold_round(const u64* __restrict__ sv, const u64* __restrict__ sa,
                           const u64* __restrict__ sm, u64* __restrict__ dv,
                           u64* __restrict__ da, u64* __restrict__ dm,
                           const u64* __restrict__ rs, int bl, int j,
                           u64* __restrict__ partials, int K, size_t n) {
    __shared__ u64 sh[6][THREADS / 32];
    const int k = blockIdx.y;
    const size_t half = n >> 1;
    const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
    u64 acc[6] = {0, 0, 0, 0, 0, 0};
    if (i < half) {
        const size_t plane = (size_t)K * n;
        const size_t off = (size_t)k * n + 2 * i;
        F2 v0, v1, a0, a1, m0, m1;
        load_pair(sv, plane, off, v0, v1);
        load_pair(sa, plane, off, a0, a1);
        load_pair(sm, plane, off, m0, m1);
        const F2 dvv = vpt::sub2(v1, v0);
        const F2 daa = vpt::sub2(a1, a0);
        const F2 dmm = vpt::sub2(m1, m0);
        const F2 pa = vpt::mul2(dmm, dvv);
        const F2 pb = vpt::add2(vpt::add2(vpt::mul2(dmm, v0), vpt::mul2(m0, dvv)), daa);
        const F2 pc = vpt::add2(vpt::mul2(m0, v0), a0);
        const F2 r = {rs[(size_t)k * bl + j], rs[(size_t)K * bl + (size_t)k * bl + j]};
        const F2 nv = vpt::add2(v0, vpt::mul2(dvv, r));
        const F2 na = vpt::add2(a0, vpt::mul2(daa, r));
        const F2 nm = vpt::add2(m0, vpt::mul2(dmm, r));
        const size_t dplane = (size_t)K * half;
        const size_t d0 = (size_t)k * half + i;
        dv[d0] = nv.re;
        dv[dplane + d0] = nv.im;
        da[d0] = na.re;
        da[dplane + d0] = na.im;
        dm[d0] = nm.re;
        dm[dplane + d0] = nm.im;
        acc[0] = pa.re; acc[1] = pa.im;
        acc[2] = pb.re; acc[3] = pb.im;
        acc[4] = pc.re; acc[5] = pc.im;
    }
    block_reduce6(acc, sh);
    if (threadIdx.x == 0) {
        u64* out = partials + ((size_t)k * gridDim.x + blockIdx.x) * 6;
#pragma unroll
        for (int t = 0; t < 6; ++t) out[t] = acc[t];
    }
}

// partials (K, nb, 6) -> polys[j] of (bl, K, 2, 3): [coef a/b/c] per plane
__global__ void reduce_partials(const u64* __restrict__ partials, int nb,
                                u64* __restrict__ polys, int K, int j) {
    __shared__ u64 sh[6][THREADS / 32];
    const int k = blockIdx.x;
    u64 acc[6] = {0, 0, 0, 0, 0, 0};
    for (int b = threadIdx.x; b < nb; b += THREADS) {
        const u64* p = partials + ((size_t)k * nb + b) * 6;
#pragma unroll
        for (int t = 0; t < 6; ++t) acc[t] = vpt::addp(acc[t], p[t]);
    }
    block_reduce6(acc, sh);
    if (threadIdx.x == 0) {
        u64* out = polys + ((size_t)j * K + k) * 6;
#pragma unroll
        for (int coef = 0; coef < 3; ++coef) {
            out[coef] = acc[2 * coef];          // real plane
            out[3 + coef] = acc[2 * coef + 1];  // imaginary plane
        }
    }
}

}  // namespace

// v, a, m: (2, K, 2^bl); rs: (2, K, bl); polys: (bl, K, 2, 3);
// bound: (3, 2, K) = bound v, a, m; work0, work1: 3 * 2 * K * 2^(bl-1)
// words each; partials: K * ceil(2^(bl-1) / THREADS) * 6 words.  bl >= 1.
extern "C" int vpt_sumcheck_fold(const u64* v, const u64* a, const u64* m,
                                 const u64* rs, u64* polys, u64* bound,
                                 u64* work0, u64* work1, u64* partials,
                                 int K, int bl, void* stream_ptr) {
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const u64 *sv = v, *sa = a, *sm = m;
    size_t n = (size_t)1 << bl;
    for (int j = 0; j < bl; ++j) {
        const size_t half = n >> 1;
        u64* dst = (j == bl - 1) ? bound : ((j & 1) ? work1 : work0);
        u64* dv = dst;
        u64* da = dst + 2 * (size_t)K * half;
        u64* dm = dst + 4 * (size_t)K * half;
        const int nb = (int)((half + THREADS - 1) / THREADS);
        fold_round<<<dim3(nb, K), THREADS, 0, stream>>>(sv, sa, sm, dv, da, dm, rs, bl,
                                                        j, partials, K, n);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        reduce_partials<<<K, THREADS, 0, stream>>>(partials, nb, polys, K, j);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        sv = dv;
        sa = da;
        sm = dm;
        n = half;
    }
    return (int)cudaGetLastError();
}
