// X1: the fft_gkr tape on Hopper (sm_90a), two entries: fg_stage_tables,
// every ifft stage's phase-1 or phase-2 tables in one launch, and (below
// it) fg_build_circuit, every layer of the tape's circuit and the
// evaluation points' power table in one launch up to lg = ONE_LAUNCH_LOG.
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
#include "field.cuh"
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

// ---------------------------------------------------------------------------
// fg_build_circuit: the fft_gkr circuit's layers.
//
// Replaces X1, which is no Pallas kernel: the JAX package's build_circuit
// (virgo_plus_tpu/pc/fft_gkr.py:107-147), whose tensor layers, ifft stages,
// scale, expansion and sum XLA fuses into a few loops inside the tape's
// jit.  Written as field ops it was ~62 launches at lg = 7 (23 gf_mul, 21
// gf_lin, a stack or cat a layer, two power tables and a tree sum), every
// layer 2-128 words but the 8,192-word expansion.
//
// What a call computes, for n = 2^lg, r (2, lg), the 64 evaluation points
// ep, the stage twiddles xp (2, n - 1) (fft_gkr.stage_powers) and inv_n:
//   tensor layer i + 1 (2^(i+1) words): [2j] = t[j] r_i, [2j+1] = t[j]
//     (1 - r_i), from layer 0 = [1];
//   ifft layer d (dep = lg - 1 - d, m = 2^dep): for u = km + t < n/2,
//     e = p[2km + t], o = p[2km + m + t], w = xp[n - n/2^dep + k]:
//     [u] = e + w o, [n/2 + u] = e - w o;
//   scale [j] = p[j] inv_n; powers pw[b][j] = ep_b^j; expansion [b n + j]
//     = scale[j] pw[b][j]; sums [b] = the sum of expansion row b;
// into one buffer, every layer (2, size) with its two planes back to back,
// in that order (tensor layers 0..lg, ifft layers, scale, expansion, sums),
// then pw (2, 64, n).
//
// Bits.  The products and sums are field.cuh's, each returning the
// canonical representative, so on canonical r, points, twiddles and inv_n
// the buffer equals the plain twin's layers and table
// (fft_gkr.build_circuit_plain) whatever the order of the products and
// sums.  Its callers pass canonical words: the tape's r and points are
// glibc-stream or sponge draws below p (fft_gkr.draw_schedule,
// gkr/fs.py), the twiddles are host powers (fft_gkr.stage_powers) and
// inv_n is computed on the host.
//
// Design.  Three routes by lg.  Up to WARP_LOG, the register route: a
// block a point of 2^WLOG warps (as many as the point's slots fill, up to
// 2^POINT_WARPS_LOG), thread h holding the slots t = h V + e, e < V = n /
// (32 2^WLOG) (one slot, threads below n, for lg < 5), in registers.  The
// tensor layers are thread chains: the thread's prefixes over its U = lg
// - log2 V bits (t's top bits, pairs first), then V slots by doubling
// over e's bits.  The ifft stages are the self-sorting schedule on fixed
// slots (gf_fft.cu's derivation): stage s pairs t and t | 2^p, p = lg - 1
// - s, with the twiddle xp[n - n/2^p + bitrev_s(t >> (p + 1))]; a warp
// bit p is an exchange through shared memory (a barrier), a lane bit a
// __shfl_xor_sync (the upper thread makes the product and sends it, the
// lower sends its value), a register bit a butterfly in the thread; slot
// t sits at (t mod 2^p) + bitrev_(s+1)(t >> p) 2^p of layer s, and at
// bitrev_lg(t) after the last stage.  The twiddles are copied to shared
// memory by cp.async at the start, under the tensor chain.  The power
// table is built thread-local, a chain beside the tensor chain: ep_b^j
// for the thread's own j = bitrev_lg(t) (its U low bits' squarings, then
// V powers of ep_b^(2^U) by doubling), so no slot moves; the expansion
// sum is an in-thread sum, five shuffles and the warps' sums.  Block 0
// writes the shared layers, every block its point's powers, expansion
// row and sum.  One warp a point (a lane n/32 slots) issues the whole
// point's ~40 products a lane from one scheduler; four warps (the tape's
// lg = 7: a slot a thread) spread them over the SM's four.  Up to
// ONE_LAUNCH_LOG, the block route: one launch of 64 blocks of
// BUILD_THREADS, one an evaluation point: each block builds the tensor
// layers and, at the same barriers, its point's powers, then the ifft
// stages, in shared memory (two buffers of n elements and one for the
// powers: 48 n bytes, 96 KB at lg = 11), a barrier between layers; r, 1 -
// r and (up to lg = SHARED_TW_LOG) the twiddles are copied to shared
// memory first; block 0 alone writes the layers out; each block writes its
// point's powers, expansion row and sum (a tree in shared memory, a level
// a barrier).  Above it the layers do not fit, and the same entry makes lg
// + 3 launches: the tensor layers (a thread an element of the last,
// running its chain of lg products and writing each prefix that is an
// element of an earlier layer), one launch an ifft stage (through device
// memory), the expansion (a block a 2^CHUNK_LOG-word chunk of a point: the
// powers of its low bits by doubling, then its high bits' squarings; a
// chunk's tree to a partial sum) and the partial sums' tree (a block a
// point).  MAX_BUILD_LOG bounds the partial sums a point in one block.
//
// What bounds it: at the tape's lg = 7 the launch and each warp's issue of
// its products (~100 instructions each, ~200 cycles of latency: a chain
// of ~2 lg + 2 of them, the tensor chain, a product and an exchange a
// stage, the scale and the expansion); ~0.3 MB written, ~0.1 us at 3.35
// TB/s, and ~30k products and sums.
//
// Why CUDA and not Triton: warp shuffles between dependent layers held in
// registers, block-wide barriers between layers in shared memory, exact
// 64-bit products, and kernels.py's loader and launch counting.
namespace {

using vpt::F2;

constexpr int POINTS = 64;            // evaluation points
constexpr int BUILD_THREADS = 256;
constexpr int BUILD_MAX_BLOCKS = 132 * 8;
constexpr int WARP_LOG = 8;           // the largest lg of the register route
constexpr int POINT_WARPS_LOG = 2;    // its most warps a point (log2)
constexpr int ONE_LAUNCH_LOG = 11;    // the largest lg built in one launch
constexpr int SHARED_TW_LOG = 11;     // the largest lg whose twiddles go to shared memory
constexpr int CHUNK_LOG = 10;         // words of a point an expansion block takes
constexpr int PARTS_LOG = 11;         // the most partial sums of a point
constexpr int MAX_BUILD_LOG = CHUNK_LOG + PARTS_LOG;
constexpr unsigned FULL = 0xffffffffu;
static_assert(ONE_LAUNCH_LOG >= CHUNK_LOG, "the multi-launch route takes lg > CHUNK_LOG");
static_assert(5 <= WARP_LOG && WARP_LOG <= ONE_LAUNCH_LOG, "the register route's lg");
static_assert(POINT_WARPS_LOG <= 5, "at most 1024 threads a point");

// element offsets of the layers in the buffer
__host__ __device__ __forceinline__ i64 tensor_at(int layer) { return ((i64)1 << layer) - 1; }
__host__ __device__ __forceinline__ i64 ifft_at(int lg, int d) {
    return ((i64)2 << lg) - 1 + ((i64)d << lg);
}
// ifft_at(lg, lg) is the scale layer, ifft_at(lg, lg + 1) the expansion,
// ifft_at(lg, lg + 1 + POINTS) the sums and POINTS after them the powers
__host__ __device__ __forceinline__ i64 sums_at(int lg) { return ifft_at(lg, lg + 1 + POINTS); }

__device__ __forceinline__ F2 ld2(const u64* p, i64 plane, i64 i) { return {p[i], p[plane + i]}; }

__device__ __forceinline__ void st2(u64* p, i64 plane, i64 i, F2 x) {
    p[i] = x.re;
    p[plane + i] = x.im;
}

__device__ __forceinline__ F2 elem(const u64* p, i64 plane, i64 step, i64 i) {
    return {p[i * step], p[plane + i * step]};
}

__device__ __forceinline__ F2 one2() { return {1, 0}; }

__device__ __forceinline__ void swap_ptr(u64*& a, u64*& b) {
    u64* t = a;
    a = b;
    b = t;
}

// the low k bits of x reversed
__device__ __forceinline__ unsigned rev(unsigned x, int k) { return k ? __brev(x) >> (32 - k) : 0; }

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ F2 shfl2(F2 x, int mask) {
    return {__shfl_xor_sync(FULL, x.re, mask), __shfl_xor_sync(FULL, x.im, mask)};
}

// ifft stage d's butterfly u of the n-point layer src (plane stride sp) into
// dst (plane stride dp); also into out (plane n) when out is not null; the
// twiddles xp (plane stride xs, n - 1 of them)
__device__ __forceinline__ void butterfly(const u64* xp, i64 xs, const u64* src, i64 sp, u64* dst,
                                          i64 dp, u64* out, int lg, int d, i64 u) {
    const i64 n = (i64)1 << lg, half = n >> 1;
    const int dep = lg - 1 - d;
    const i64 m = (i64)1 << dep, k = u >> dep;
    const i64 e_at = (k << (dep + 1)) + (u & (m - 1));
    const F2 e = ld2(src, sp, e_at), o = ld2(src, sp, e_at + m);
    const F2 t = vpt::mul2_split(ld2(xp, xs, n - (n >> dep) + k), o);
    const F2 s = vpt::add2(e, t), df = vpt::sub2(e, t);
    st2(dst, dp, u, s);
    st2(dst, dp, half + u, df);
    if (out != nullptr) {
        st2(out, n, u, s);
        st2(out, n, half + u, df);
    }
}

// the register route's shape at lg: 2^WLOG warps a point (up to
// POINT_WARPS_LOG) and 2^VLOG slots a thread
__host__ __device__ constexpr int route_wlog(int lg) {
    return lg <= 5 ? 0 : (lg - 5 < POINT_WARPS_LOG ? lg - 5 : POINT_WARPS_LOG);
}
__host__ __device__ constexpr int route_vlog(int lg) {
    return lg <= 5 + POINT_WARPS_LOG ? 0 : lg - 5 - POINT_WARPS_LOG;
}

// one block a point: thread h (2^WLOG warps) holds slots t = h V + e, e <
// V = 2^VLOG (lg = VLOG + 5 + WLOG; WLOG = VLOG = 0 also for lg < 5,
// threads below n); t's bits: e, then the lane, then the warp
template <int VLOG, int WLOG>
__global__ void __launch_bounds__(32 << WLOG)
fg_build_warp(const u64* __restrict__ r, i64 r_plane, i64 r_step, const u64* __restrict__ ep,
              i64 ep_plane, i64 ep_step, const u64* __restrict__ xp, F2 inv_n,
              u64* __restrict__ out, int lg_arg) {
    constexpr int V = 1 << VLOG, T = 32 << WLOG, LGM = VLOG + 5 + WLOG;
    constexpr bool FULL_LANES = VLOG + WLOG > 0;
    __shared__ u64 tw[2][T * V];           // the stages' twiddles, n - 1
    __shared__ F2 xch[2][T * V];           // the warp bits' exchanges
    __shared__ F2 part[1 << WLOG];         // the warps' sums
    const int h = threadIdx.x, lane = h & 31, b = blockIdx.x;
    const bool writer = b == 0;
    // a constant where every lane holds slots, so every register index
    // below is one
    const int lg = FULL_LANES ? LGM : lg_arg;
    const int n = 1 << lg, U = lg - VLOG;  // U: the thread bits of a slot
    const bool live = h < (1 << U);
    const F2 one = one2();
    // every load first: r, the point, then the twiddles (to shared memory,
    // asynchronously: the stages wait on them, the chains do not)
    F2 f0[LGM], f1[LGM];                   // r_i and 1 - r_i
#pragma unroll
    for (int i = 0; i < LGM; ++i)
        if (i < lg) f0[i] = elem(r, r_plane, r_step, i);
    F2 sq[LGM];                            // ep_b^(2^i)
    sq[0] = elem(ep, ep_plane, ep_step, b);
    for (int i = h; i < n - 1; i += T) {
        cp_async8(&tw[0][i], xp + i);
        cp_async8(&tw[1][i], xp + (n - 1) + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < LGM; ++i)
        if (i < lg) f1[i] = vpt::sub2(one, f0[i]);
    // the powers, a chain beside the tensor chain: slot e is entry j =
    // bitrev_lg(h V + e) = bitrev_U(h) + bitrev_VLOG(e) 2^U, so pw[e] =
    // ep_b^bitrev_U(h) times sq[U + VLOG - 1 - i] for each bit i of e
#pragma unroll
    for (int i = 1; i < LGM; ++i)
        if (i < lg) sq[i] = vpt::mul2_split(sq[i - 1], sq[i - 1]);
    const unsigned jl = rev((unsigned)h, U);
    F2 pw[V];
    pw[0] = one;
#pragma unroll
    for (int i = 0; i < 5 + WLOG; ++i)
        if (i < U && ((jl >> i) & 1)) pw[0] = vpt::mul2_split(pw[0], sq[i]);
#pragma unroll
    for (int i = 0; i < VLOG; ++i)
#pragma unroll
        for (int e = 0; e < (1 << i); ++e)
            pw[e + (1 << i)] = vpt::mul2_split(pw[e], sq[U + VLOG - 1 - i]);
    // the tensor layers: the thread's prefixes over its U bits (layer i +
    // 1 is the product of factors 0..i, pairs first: depth 4 for 7), then
    // V slots by doubling
    if (writer && h == 0) st2(out + 2 * tensor_at(0), 1, 0, one);
    constexpr int UM = 5 + WLOG;
    F2 fa[UM], pre[UM];
#pragma unroll
    for (int i = 0; i < UM; ++i)
        if (i < U) fa[i] = (h >> (U - 1 - i)) & 1 ? f1[i] : f0[i];
    if (U > 0) pre[0] = fa[0];
    if (U > 1) pre[1] = vpt::mul2_split(fa[0], fa[1]);
    if (U > 2) pre[2] = vpt::mul2_split(pre[1], fa[2]);
    if (U > 3) pre[3] = vpt::mul2_split(pre[1], vpt::mul2_split(fa[2], fa[3]));
    if (U > 4) pre[4] = vpt::mul2_split(pre[3], fa[4]);
    if constexpr (UM > 5) {
        if (U > 5) pre[5] = vpt::mul2_split(pre[3], vpt::mul2_split(fa[4], fa[5]));
    }
    if constexpr (UM > 6) {
        if (U > 6) pre[6] = vpt::mul2_split(pre[5], fa[6]);
    }
#pragma unroll
    for (int i = 7; i < UM; ++i)
        if (i < U) pre[i] = vpt::mul2_split(pre[i - 1], fa[i]);
#pragma unroll
    for (int i = 0; i < UM; ++i) {
        if (i >= U) break;
        const int sh = U - 1 - i;
        if (writer && live && (h & ((1 << sh) - 1)) == 0)
            st2(out + 2 * tensor_at(i + 1), (i64)2 << i, h >> sh, pre[i]);
    }
    F2 x[V];
    x[0] = U > 0 ? pre[U - 1] : one;
#pragma unroll
    for (int s = 0; s < VLOG; ++s) {
#pragma unroll
        for (int e = (1 << s) - 1; e >= 0; --e) {
            x[2 * e + 1] = vpt::mul2_split(x[e], f1[U + s]);
            x[2 * e] = vpt::mul2_split(x[e], f0[U + s]);
        }
        if (writer) {
            u64* layer = out + 2 * tensor_at(U + s + 1);
#pragma unroll
            for (int e = 0; e < (2 << s); ++e)
                st2(layer, (i64)2 << (U + s), (h << (s + 1)) + e, x[e]);
        }
    }
    // the ifft stages, on the twiddles in shared memory: stage s pairs t
    // and t | 2^p, p = lg - 1 - s, a warp bit (an exchange through shared
    // memory, a barrier), a lane bit (a shuffle) or a register bit (a
    // butterfly in the thread)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int s = 0; s < LGM; ++s) {
        if (s >= lg) break;
        const int p = lg - 1 - s;
        const int kb = n - (n >> p);   // stage p's twiddles
        if (p >= VLOG) {
            const int hb = p - VLOG;   // the thread bit
            const unsigned k = rev((unsigned)h >> (hb + 1), s);
            const F2 w = {tw[0][kb + k], tw[1][kb + k]};
            const bool hi = (h >> hb) & 1;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const F2 prod = vpt::mul2_split(w, x[e]);
                F2 got;
                if (hb >= 5) {
                    xch[s & 1][h * V + e] = hi ? prod : x[e];
                    __syncthreads();
                    got = xch[s & 1][(h ^ (1 << hb)) * V + e];
                } else {
                    got = shfl2(hi ? prod : x[e], 1 << hb);
                }
                x[e] = hi ? vpt::sub2(got, prod) : vpt::add2(x[e], got);
            }
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) {
                if (e & (1 << p)) continue;
                const unsigned k = rev(((unsigned)h << (VLOG - p - 1)) | (e >> (p + 1)), s);
                const F2 w = {tw[0][kb + k], tw[1][kb + k]};
                const F2 t = vpt::mul2_split(w, x[e | (1 << p)]);
                x[e | (1 << p)] = vpt::sub2(x[e], t);
                x[e] = vpt::add2(x[e], t);
            }
        }
        if (writer && live) {
            u64* layer = out + 2 * ifft_at(lg, s);
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const unsigned t = ((unsigned)h << VLOG) | e;
                st2(layer, n, (t & ((1u << p) - 1)) | (rev(t >> p, s + 1) << p), x[e]);
            }
        }
    }
    u64* scale = out + 2 * ifft_at(lg, lg);
    u64* expn = out + 2 * ifft_at(lg, lg + 1);
    u64* sums = out + 2 * sums_at(lg);
    u64* pws = sums + 2 * POINTS;
    const i64 wide = (i64)n * POINTS;
    F2 acc = {0, 0};
#pragma unroll
    for (int e = 0; e < V; ++e) {
        const i64 j = jl + ((i64)rev(e, VLOG) << U);
        const F2 s = vpt::mul2_split(x[e], inv_n);
        const F2 v = vpt::mul2_split(s, pw[e]);
        if (live) {
            if (writer) st2(scale, n, j, s);
            st2(pws, wide, (i64)b * n + j, pw[e]);
            st2(expn, wide, (i64)b * n + j, v);
            acc = vpt::add2(acc, v);
        }
    }
    // the sum: the thread's, five shuffles, then the warps' in shared memory
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc = vpt::add2(acc, shfl2(acc, o));
    if (WLOG == 0) {
        if (h == 0) st2(sums, POINTS, b, acc);
        return;
    }
    if (lane == 0) part[h >> 5] = acc;
    __syncthreads();
    if (h == 0) {
        acc = part[0];
#pragma unroll
        for (int w = 1; w < (1 << WLOG); ++w) acc = vpt::add2(acc, part[w]);
        st2(sums, POINTS, b, acc);
    }
}

// one block an evaluation point; dynamic shared memory: three (2, n)
// buffers, then (up to SHARED_TW_LOG) a copy of the twiddles; r and 1 - r
// in static shared memory, so no load of the layer chain waits on device
// memory
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_one(const u64* __restrict__ r, i64 r_plane, i64 r_step, const u64* __restrict__ ep,
             i64 ep_plane, i64 ep_step, const u64* __restrict__ xp, F2 inv_n,
             u64* __restrict__ out, int lg) {
    extern __shared__ u64 smem[];
    __shared__ F2 rs[ONE_LAUNCH_LOG][2];    // r_i, 1 - r_i
    const i64 n = (i64)1 << lg, half = n >> 1;
    const int b = blockIdx.x, tid = threadIdx.x;
    const bool writer = b == 0;            // block 0 writes the layers
    u64* cur = smem;
    u64* nxt = smem + 2 * n;
    u64* pw = smem + 4 * n;
    const F2 one = one2();
    const u64* tw = xp;
    if (lg <= SHARED_TW_LOG && n > 1) {
        u64* copy = smem + 6 * n;
        for (i64 i = tid; i < 2 * (n - 1); i += BUILD_THREADS) copy[i] = xp[i];
        tw = copy;
    }
    if (tid < lg) {
        rs[tid][0] = elem(r, r_plane, r_step, tid);
        rs[tid][1] = vpt::sub2(one, rs[tid][0]);
    }
    if (tid == 0) {
        st2(cur, n, 0, one);
        st2(pw, n, 0, one);
        if (writer) st2(out + 2 * tensor_at(0), 1, 0, one);
    }
    F2 sq = elem(ep, ep_plane, ep_step, b);  // ep_b^(2^i) at step i
    __syncthreads();
    for (int i = 0; i < lg; ++i) {
        const i64 width = (i64)1 << i;
        const F2 ri = rs[i][0], ri1 = rs[i][1];
        u64* layer = out + 2 * tensor_at(i + 1);
        for (i64 j = tid; j < width; j += BUILD_THREADS) {
            const F2 x = ld2(cur, n, j);
            const F2 hi = vpt::mul2_split(x, ri), lo = vpt::mul2_split(x, ri1);
            st2(nxt, n, 2 * j, hi);
            st2(nxt, n, 2 * j + 1, lo);
            if (writer) {
                st2(layer, 2 * width, 2 * j, hi);
                st2(layer, 2 * width, 2 * j + 1, lo);
            }
            st2(pw, n, width + j, vpt::mul2_split(ld2(pw, n, j), sq));
        }
        sq = vpt::mul2_split(sq, sq);
        __syncthreads();
        swap_ptr(cur, nxt);
    }
    for (int d = 0; d < lg; ++d) {
        u64* layer = writer ? out + 2 * ifft_at(lg, d) : nullptr;
        for (i64 u = tid; u < half; u += BUILD_THREADS)
            butterfly(tw, n - 1, cur, n, nxt, n, layer, lg, d, u);
        __syncthreads();
        swap_ptr(cur, nxt);
    }
    u64* scale = out + 2 * ifft_at(lg, lg);
    u64* expn = out + 2 * ifft_at(lg, lg + 1);
    u64* sums = out + 2 * sums_at(lg);
    u64* pws = sums + 2 * POINTS;
    const i64 wide = n * POINTS;
    for (i64 j = tid; j < n; j += BUILD_THREADS) {
        const F2 s = vpt::mul2_split(ld2(cur, n, j), inv_n);
        if (writer) st2(scale, n, j, s);
        const F2 p = ld2(pw, n, j);
        st2(pws, wide, b * n + j, p);
        const F2 x = vpt::mul2_split(s, p);
        st2(expn, wide, b * n + j, x);
        st2(nxt, n, j, x);
    }
    __syncthreads();
    swap_ptr(cur, nxt);
    for (i64 cnt = half; cnt > 0; cnt >>= 1) {
        for (i64 i = tid; i < cnt; i += BUILD_THREADS)
            st2(nxt, n, i, vpt::add2(ld2(cur, n, 2 * i), ld2(cur, n, 2 * i + 1)));
        __syncthreads();
        swap_ptr(cur, nxt);
    }
    if (tid == 0) st2(sums, POINTS, b, ld2(cur, n, 0));
}

// multi-launch route, 1: every tensor layer, a thread an element j of the
// last; its chain's prefix after step i is element j >> (lg - 1 - i) of
// layer i + 1, written by the thread whose j has those low bits zero
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_tensor(const u64* __restrict__ r, i64 r_plane, i64 r_step, u64* __restrict__ out,
                int lg) {
    const i64 n = (i64)1 << lg;
    const F2 one = one2();
    for (i64 j = (i64)blockIdx.x * BUILD_THREADS + threadIdx.x; j < n;
         j += (i64)gridDim.x * BUILD_THREADS) {
        if (j == 0) st2(out + 2 * tensor_at(0), 1, 0, one);
        F2 v = one;
        for (int i = 0; i < lg; ++i) {
            const int low = lg - 1 - i;
            const i64 idx = j >> low;
            const F2 ri = elem(r, r_plane, r_step, i);
            v = vpt::mul2_split(v, (idx & 1) ? vpt::sub2(one, ri) : ri);
            if ((j & (((i64)1 << low) - 1)) == 0)
                st2(out + 2 * tensor_at(i + 1), (i64)2 << i, idx, v);
        }
    }
}

// 2: ifft layer d from the layer before it, through device memory
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_stage(const u64* __restrict__ xp, u64* out, int lg, int d) {
    const i64 n = (i64)1 << lg;
    const u64* src = out + 2 * (d == 0 ? tensor_at(lg) : ifft_at(lg, d - 1));
    u64* dst = out + 2 * ifft_at(lg, d);
    for (i64 u = (i64)blockIdx.x * BUILD_THREADS + threadIdx.x; u < (n >> 1);
         u += (i64)gridDim.x * BUILD_THREADS)
        butterfly(xp, n - 1, src, n, dst, n, nullptr, lg, d, u);
}

// 3: block (c, b) takes words [c 2^CHUNK_LOG, (c + 1) 2^CHUNK_LOG) of point
// b: its powers, the scale words (point 0's blocks write them), the
// expansion words and the chunk's tree, to parts (2, POINTS, n >> CHUNK_LOG)
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_expand(const u64* __restrict__ ep, i64 ep_plane, i64 ep_step, F2 inv_n, u64* out,
                u64* __restrict__ parts, int lg) {
    constexpr int CH = 1 << CHUNK_LOG;
    __shared__ u64 pw[2 * CH], xs[2 * CH];
    const i64 n = (i64)1 << lg;
    const i64 c = blockIdx.x;
    const int b = blockIdx.y, tid = threadIdx.x;
    if (tid == 0) st2(pw, CH, 0, one2());
    F2 sq = elem(ep, ep_plane, ep_step, b);
    __syncthreads();
    for (int i = 0; i < CHUNK_LOG; ++i) {
        const int width = 1 << i;
        for (int j = tid; j < width; j += BUILD_THREADS)
            st2(pw, CH, width + j, vpt::mul2_split(ld2(pw, CH, j), sq));
        sq = vpt::mul2_split(sq, sq);
        __syncthreads();
    }
    // the chunk's high bits, lowest first; a thread keeps to its own words
    for (int i = CHUNK_LOG; i < lg; ++i) {
        if ((c >> (i - CHUNK_LOG)) & 1)
            for (int l = tid; l < CH; l += BUILD_THREADS)
                st2(pw, CH, l, vpt::mul2_split(ld2(pw, CH, l), sq));
        sq = vpt::mul2_split(sq, sq);
    }
    const u64* last = out + 2 * ifft_at(lg, lg - 1);
    u64* scale = out + 2 * ifft_at(lg, lg);
    u64* expn = out + 2 * ifft_at(lg, lg + 1);
    u64* pws = out + 2 * (sums_at(lg) + POINTS);
    const i64 wide = n * POINTS;
    for (int l = tid; l < CH; l += BUILD_THREADS) {
        const i64 j = c * CH + l;
        const F2 p = ld2(pw, CH, l);
        st2(pws, wide, b * n + j, p);
        const F2 s = vpt::mul2_split(ld2(last, n, j), inv_n);
        if (b == 0) st2(scale, n, j, s);
        const F2 x = vpt::mul2_split(s, p);
        st2(expn, wide, b * n + j, x);
        st2(xs, CH, l, x);
    }
    __syncthreads();
    u64* src = xs;
    u64* dst = pw;
    for (int cnt = CH >> 1; cnt > 0; cnt >>= 1) {
        for (int i = tid; i < cnt; i += BUILD_THREADS)
            st2(dst, CH, i, vpt::add2(ld2(src, CH, 2 * i), ld2(src, CH, 2 * i + 1)));
        __syncthreads();
        swap_ptr(src, dst);
    }
    const i64 chunks = n >> CHUNK_LOG;
    if (tid == 0) st2(parts, POINTS * chunks, b * chunks + c, ld2(src, CH, 0));
}

// 4: point b's partial sums' tree (the first level read from device memory)
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_sum(const u64* __restrict__ parts, u64* __restrict__ out, int lg) {
    constexpr int HALF = 1 << (PARTS_LOG - 1);
    __shared__ u64 a[2 * HALF], bb[2 * HALF];
    const int chunks = 1 << (lg - CHUNK_LOG);
    const int b = blockIdx.x, tid = threadIdx.x;
    const i64 plane = (i64)POINTS * chunks;
    const u64* row = parts + (i64)b * chunks;
    for (int i = tid; i < chunks / 2; i += BUILD_THREADS)
        st2(a, HALF, i, vpt::add2(ld2(row, plane, 2 * i), ld2(row, plane, 2 * i + 1)));
    __syncthreads();
    u64* src = a;
    u64* dst = bb;
    for (int cnt = chunks >> 2; cnt > 0; cnt >>= 1) {
        for (int i = tid; i < cnt; i += BUILD_THREADS)
            st2(dst, HALF, i, vpt::add2(ld2(src, HALF, 2 * i), ld2(src, HALF, 2 * i + 1)));
        __syncthreads();
        swap_ptr(src, dst);
    }
    if (tid == 0) st2(out + 2 * sums_at(lg), POINTS, b, ld2(src, HALF, 0));
}

int build_blocks(i64 items) {
    const i64 want = (items + BUILD_THREADS - 1) / BUILD_THREADS;
    return want < BUILD_MAX_BLOCKS ? (int)want : BUILD_MAX_BLOCKS;
}

// the register route's launch at lg (the kernels of lg <= WARP_LOG only
// are built)
template <int LG>
cudaError_t launch_warp(int lg, const u64* r, i64 r_plane, i64 r_step, const u64* ep,
                        i64 ep_plane, i64 ep_step, const u64* xp, F2 inv_n, u64* out,
                        cudaStream_t stream) {
    if constexpr (LG > WARP_LOG) {
        return cudaErrorInvalidValue;
    } else {
        if (lg != LG)
            return launch_warp<LG + 1>(lg, r, r_plane, r_step, ep, ep_plane, ep_step, xp, inv_n,
                                       out, stream);
        // lg < 5 shares lg = 5's kernel (a warp, threads below n)
        constexpr int K = LG < 5 ? 5 : LG, VL = route_vlog(K), WL = route_wlog(K);
        fg_build_warp<VL, WL><<<POINTS, 32 << WL, 0, stream>>>(r, r_plane, r_step, ep, ep_plane,
                                                              ep_step, xp, inv_n, out, lg);
        return cudaGetLastError();
    }
}

}  // namespace

// The fft_gkr circuit of 2^lg points: r (2, lg) and ep (2, 64) by plane and
// element strides, xp (2, 2^lg - 1), inv_n by value; out the buffer above,
// parts (2, 64, 2^(lg - CHUNK_LOG)) scratch above ONE_LAUNCH_LOG (else
// unused).  One launch up to ONE_LAUNCH_LOG (in registers up to
// WARP_LOG), lg + 3 above it.
extern "C" int vpt_fg_build_circuit(const u64* r, i64 r_plane, i64 r_step, const u64* ep,
                                    i64 ep_plane, i64 ep_step, const u64* xp, u64 inv_re,
                                    u64 inv_im, u64* out, u64* parts, int lg, void* stream_ptr) {
    if (lg < 0 || lg > MAX_BUILD_LOG) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const F2 inv_n = {inv_re, inv_im};
    const i64 n = (i64)1 << lg;
    cudaError_t err;
    if (lg <= WARP_LOG)
        return (int)launch_warp<0>(lg, r, r_plane, r_step, ep, ep_plane, ep_step, xp, inv_n, out,
                                   stream);
    if (lg <= ONE_LAUNCH_LOG) {
        const size_t smem =
            sizeof(u64) * (6 * (size_t)n + (lg <= SHARED_TW_LOG ? 2 * (size_t)(n - 1) : 0));
        // above 48 KB of static and dynamic shared memory a block needs
        // the opt-in (the static part: r and 1 - r)
        if (smem + sizeof(F2) * 2 * ONE_LAUNCH_LOG > 48 * 1024) {
            err = cudaFuncSetAttribute(fg_build_one, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        fg_build_one<<<POINTS, BUILD_THREADS, smem, stream>>>(r, r_plane, r_step, ep, ep_plane, ep_step, xp, inv_n, out, lg);
        return (int)cudaGetLastError();
    }
    fg_build_tensor<<<build_blocks(n), BUILD_THREADS, 0, stream>>>(r, r_plane, r_step, out, lg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int d = 0; d < lg; ++d) {
        fg_build_stage<<<build_blocks(n >> 1), BUILD_THREADS, 0, stream>>>(xp, out, lg, d);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    fg_build_expand<<<dim3((unsigned)(n >> CHUNK_LOG), POINTS), BUILD_THREADS, 0, stream>>>(ep, ep_plane, ep_step, inv_n, out, parts, lg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fg_build_sum<<<POINTS, BUILD_THREADS, 0, stream>>>(parts, out, lg);
    return (int)cudaGetLastError();
}
