// X1: the fft_gkr tape's ifft-stage tables on Hopper (sm_90a):
// fg_stage_tables, every stage's phase-1 or phase-2 tables in one launch.
//
// Replaces X1, which is no Pallas kernel: in the JAX package's tape
// (virgo_plus_tpu/pc/fft_gkr.py:202 prove_messages, the stage loop at
// :244-275) XLA fuses each stage's table formulas (:255-259 and :264-269)
// and their interleaving stacks into a few loops inside the jit.  Written
// as field ops, a stage's two table pairs were 11 gf_mul / gf_lin calls
// and four stacks; here one launch makes every stage's pair of a phase.
//
// What a call computes.  Stage s of the call is ifft stage dep = dep0 + s
// of a tape of n = 2^lg points: m = 2^dep, K = n / (2m), and for j < n/2,
// k = j >> dep, t = j mod m, the slots e = 2km + t and o = e + m.  bg (2,
// S, n) are the stages' two-point beta tables (bgA = bg[j], bgB =
// bg[n/2 + j]); xp (2, n - 1) every stage's twiddles, stage dep's K of them
// at n - n/2^dep; the output (2 tables, 2, S, n) holds addV, then am.
//   phase 1 (src: the stages' pre-layers V):
//     addV[e] = ((bgA - bgB) xp[k]) V[o], am[e] = bgA + bgB, 0 at o;
//   phase 2 (src: the stages' bu tables, vu (2, S) the bound v of the
//   phase-1 sumchecks):
//     gA = bgA bu[e], gB = bgB bu[e],
//     am[o] = (gA - gB) xp[k], addV[o] = (gA + gB) vu, 0 at e;
// in the JAX package's order of operations.  Every output word is written
// once, so the launch needs no zero fill.
//
// Bits.  The field steps are gf_int64.cuh's, the int64 steps of gf.py's
// plain ops, so the tables equal the plain twin's on any input.
//
// Design.  A thread an (s, j), grid-stride over the S n/2 of them: it reads
// bgA, bgB, its twiddle and one V or bu word and writes its two slots of
// both tables.  Neighbouring threads read neighbouring bg words and, for m
// >= 32, write neighbouring slots.  The stage, its dep and its slots come
// from the thread's index and lg, dep0 by value; no host copy, so a CUDA
// graph captures the launch.
//
// What bounds it: at the tape's sizes (lg = 7: 7 x 64 items) the launch.
// In bytes, 2 x 16 read and 4 x 16 written an item, plus the twiddles:
// ~44 KB at lg = 7, ~0.01 us at 3.35 TB/s; 2-4 products an item.
//
// Why CUDA and not Triton: exact 64-bit wrap-around and signed and
// unsigned shifts on the same words, and kernels.py's loader and launch
// counting.
#include <cuda_runtime.h>
#include <stdint.h>
#include "gf_int64.cuh"

namespace {

using namespace vpt64;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

template <int PHASE>
__global__ void __launch_bounds__(THREADS)
fg_stage_tables_kernel(const u64* __restrict__ bg, const u64* __restrict__ xp,
                       const u64* __restrict__ src, const u64* __restrict__ vu,
                       u64* __restrict__ out, int stages, int lg, int dep0) {
    const i64 n = (i64)1 << lg, half = n >> 1;
    const i64 plane = stages * n;          // plane stride of bg, src and a table
    const i64 items = stages * half;
    for (i64 i = (i64)blockIdx.x * THREADS + threadIdx.x; i < items;
         i += (i64)gridDim.x * THREADS) {
        const int s = (int)(i >> (lg - 1));
        const i64 j = i & (half - 1);
        const int dep = dep0 + s;
        const i64 k = j >> dep, m = (i64)1 << dep;
        const i64 base = s * n;
        const i64 e = base + (k << (dep + 1)) + (j & (m - 1)), o = e + m;
        const E bgA = load(bg, plane, base + j), bgB = load(bg, plane, base + half + j);
        const E xk = load(xp, n - 1, n - (n >> dep) + k);
        u64* addV = out;
        u64* am = out + 2 * plane;
        const E zero = {0, 0};
        if constexpr (PHASE == 1) {
            const E v = load(src, plane, o);
            store(addV, plane, e, mul(mul(sub(bgA, bgB), xk), v));
            store(addV, plane, o, zero);
            store(am, plane, e, add(bgA, bgB));
            store(am, plane, o, zero);
        } else {
            const E bu = load(src, plane, e);
            const E gA = mul(bgA, bu), gB = mul(bgB, bu);
            store(am, plane, e, zero);
            store(am, plane, o, mul(sub(gA, gB), xk));
            store(addV, plane, e, zero);
            store(addV, plane, o, mul(add(gA, gB), load(vu, stages, s)));
        }
    }
}

}  // namespace

// Phase 1 or 2 of `stages` ifft stages dep0 ... of a 2^lg-point tape: bg
// and src (2, stages, 2^lg), xp (2, 2^lg - 1), vu (2, stages) (phase 2
// only), out (2, 2, stages, 2^lg).  One launch, none for no stage.
extern "C" int vpt_fg_stage_tables(int phase, const u64* bg, const u64* xp, const u64* src,
                                   const u64* vu, u64* out, int stages, int lg, int dep0,
                                   void* stream_ptr) {
    if (stages <= 0) return 0;
    if (lg < 1 || lg > 30 || dep0 < 0 || dep0 + stages > lg)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const i64 items = (i64)stages << (lg - 1);
    const i64 want = (items + THREADS - 1) / THREADS;
    const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
    switch (phase) {
        case 1:
            fg_stage_tables_kernel<1><<<blocks, THREADS, 0, stream>>>(bg, xp, src, vu, out,
                                                                      stages, lg, dep0);
            break;
        case 2:
            fg_stage_tables_kernel<2><<<blocks, THREADS, 0, stream>>>(bg, xp, src, vu, out,
                                                                      stages, lg, dep0);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
