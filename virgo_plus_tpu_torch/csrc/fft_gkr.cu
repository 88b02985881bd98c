// X1: the fft_gkr tape on Hopper (sm_90a), two entries: fg_stage_tables,
// every ifft stage's phase-1 or phase-2 tables in one launch, and (below
// it) fg_build_circuit, every layer of the tape's circuit and the
// evaluation points' power table in one launch up to lg = 12.
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
//   scale [j] = p[j] inv_n; powers pw[b][j] = ep_b^j by doubling (pw[2^i +
//     j] = pw[j] ep_b^(2^i), the squarings chained); expansion [b n + j] =
//     scale[j] pw[b][j]; sums [b] = the log tree (pairs (2i, 2i + 1) a
//     level) of expansion row b;
// into one buffer, every layer (2, size) with its two planes back to back,
// in that order (tensor layers 0..lg, ifft layers, scale, expansion, sums),
// then pw (2, 64, n).  Each product, sum and tree pair is the plain twin's
// (fft_gkr.build_circuit_plain), in its order, on gf_int64.cuh's steps, so
// the buffer equals the twin's layers and table on any input.
//
// Design.  Up to lg = ONE_LAUNCH_LOG, one launch of 64 blocks, one an
// evaluation point: each block builds the tensor layers and, at the same
// barriers, its point's powers, then the ifft stages, in shared memory (two
// buffers of n elements and one for the powers: 48 n bytes, 192 KB at lg =
// 12), a barrier between layers; r, 1 - r and (up to lg = SHARED_TW_LOG)
// the twiddles are copied to shared memory first, so the chain of layers
// waits on no device-memory load; block 0 alone writes the layers out; each
// block writes its point's powers, expansion row and sum (the tree in
// shared memory, a level a barrier).  Above it the layers do not fit, and
// the same entry makes lg + 3 launches: the tensor layers (a thread an
// element of the last, running its chain of lg products and writing each
// prefix that is an element of an earlier layer), one launch an ifft stage
// (through device memory), the expansion (a block a 2^CHUNK_LOG-word chunk
// of a point: the powers of its low bits by doubling, then its high bits'
// squarings in increasing order, as the doubling makes them; a chunk's
// tree to a partial sum) and the partial sums' tree (a block a point).
// The chunks' trees are the subtrees of the whole tree, so the sums are
// the twin's.  MAX_BUILD_LOG bounds the partial sums a point in one block.
//
// What bounds it: at the tape's lg = 7 the launch and a chain of ~2 lg + 2
// dependent products (~200 cycles each on the H100) and 3 lg + 1 barriers;
// ~0.3 MB written, ~0.1 us at 3.35 TB/s, and ~30k products and sums.
//
// Why CUDA and not Triton: as fg_stage_tables, and block-wide barriers
// between dependent layers in shared memory.
namespace {

using namespace vpt64;

constexpr int POINTS = 64;            // evaluation points
constexpr int BUILD_THREADS = 256;
constexpr int BUILD_MAX_BLOCKS = 132 * 8;
constexpr int ONE_LAUNCH_LOG = 12;    // the largest lg built in one launch
constexpr int SHARED_TW_LOG = 11;     // the largest lg whose twiddles go to shared memory
constexpr int CHUNK_LOG = 10;         // words of a point an expansion block takes
constexpr int PARTS_LOG = 11;         // the most partial sums of a point
constexpr int MAX_BUILD_LOG = CHUNK_LOG + PARTS_LOG;
static_assert(ONE_LAUNCH_LOG >= CHUNK_LOG, "the multi-launch route takes lg > CHUNK_LOG");

// element offsets of the layers in the buffer
__host__ __device__ __forceinline__ i64 tensor_at(int layer) { return ((i64)1 << layer) - 1; }
__host__ __device__ __forceinline__ i64 ifft_at(int lg, int d) {
    return ((i64)2 << lg) - 1 + ((i64)d << lg);
}
// ifft_at(lg, lg) is the scale layer, ifft_at(lg, lg + 1) the expansion,
// ifft_at(lg, lg + 1 + POINTS) the sums and POINTS after them the powers
__host__ __device__ __forceinline__ i64 sums_at(int lg) { return ifft_at(lg, lg + 1 + POINTS); }

__device__ __forceinline__ E elem(const u64* p, i64 plane, i64 step, i64 i) {
    return {p[i * step], p[plane + i * step]};
}

__device__ __forceinline__ void swap_ptr(u64*& a, u64*& b) {
    u64* t = a;
    a = b;
    b = t;
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
    const E e = load(src, sp, e_at), o = load(src, sp, e_at + m);
    const E t = mul(load(xp, xs, n - (n >> dep) + k), o);
    const E s = add(e, t), df = sub(e, t);
    store(dst, dp, u, s);
    store(dst, dp, half + u, df);
    if (out != nullptr) {
        store(out, n, u, s);
        store(out, n, half + u, df);
    }
}

// one block an evaluation point; dynamic shared memory: three (2, n)
// buffers, then (up to SHARED_TW_LOG) a copy of the twiddles; r and 1 - r
// in static shared memory, so no load of the layer chain waits on device
// memory
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_one(const u64* __restrict__ r, i64 r_plane, i64 r_step, const u64* __restrict__ ep,
             i64 ep_plane, i64 ep_step, const u64* __restrict__ xp, E inv_n,
             u64* __restrict__ out, int lg) {
    extern __shared__ u64 smem[];
    __shared__ E rs[ONE_LAUNCH_LOG][2];    // r_i, 1 - r_i
    const i64 n = (i64)1 << lg, half = n >> 1;
    const int b = blockIdx.x, tid = threadIdx.x;
    const bool writer = b == 0;            // block 0 writes the layers
    u64* cur = smem;
    u64* nxt = smem + 2 * n;
    u64* pw = smem + 4 * n;
    const E one = {1, 0};
    const u64* tw = xp;
    if (lg <= SHARED_TW_LOG && n > 1) {
        u64* copy = smem + 6 * n;
        for (i64 i = tid; i < 2 * (n - 1); i += BUILD_THREADS) copy[i] = xp[i];
        tw = copy;
    }
    if (tid < lg) {
        rs[tid][0] = elem(r, r_plane, r_step, tid);
        rs[tid][1] = sub(one, rs[tid][0]);
    }
    if (tid == 0) {
        store(cur, n, 0, one);
        store(pw, n, 0, one);
        if (writer) store(out + 2 * tensor_at(0), 1, 0, one);
    }
    E sq = elem(ep, ep_plane, ep_step, b);  // ep_b^(2^i) at step i
    __syncthreads();
    for (int i = 0; i < lg; ++i) {
        const i64 width = (i64)1 << i;
        const E ri = rs[i][0], ri1 = rs[i][1];
        u64* layer = out + 2 * tensor_at(i + 1);
        for (i64 j = tid; j < width; j += BUILD_THREADS) {
            const E x = load(cur, n, j);
            const E hi = mul(x, ri), lo = mul(x, ri1);
            store(nxt, n, 2 * j, hi);
            store(nxt, n, 2 * j + 1, lo);
            if (writer) {
                store(layer, 2 * width, 2 * j, hi);
                store(layer, 2 * width, 2 * j + 1, lo);
            }
            store(pw, n, width + j, mul(load(pw, n, j), sq));
        }
        sq = mul(sq, sq);
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
        const E s = mul(load(cur, n, j), inv_n);
        if (writer) store(scale, n, j, s);
        const E p = load(pw, n, j);
        store(pws, wide, b * n + j, p);
        const E x = mul(s, p);
        store(expn, wide, b * n + j, x);
        store(nxt, n, j, x);
    }
    __syncthreads();
    swap_ptr(cur, nxt);
    for (i64 cnt = half; cnt > 0; cnt >>= 1) {
        for (i64 i = tid; i < cnt; i += BUILD_THREADS)
            store(nxt, n, i, add(load(cur, n, 2 * i), load(cur, n, 2 * i + 1)));
        __syncthreads();
        swap_ptr(cur, nxt);
    }
    if (tid == 0) store(sums, POINTS, b, load(cur, n, 0));
}

// multi-launch route, 1: every tensor layer, a thread an element j of the
// last; its chain's prefix after step i is element j >> (lg - 1 - i) of
// layer i + 1, written by the thread whose j has those low bits zero
__global__ void __launch_bounds__(BUILD_THREADS)
fg_build_tensor(const u64* __restrict__ r, i64 r_plane, i64 r_step, u64* __restrict__ out,
                int lg) {
    const i64 n = (i64)1 << lg;
    const E one = {1, 0};
    for (i64 j = (i64)blockIdx.x * BUILD_THREADS + threadIdx.x; j < n;
         j += (i64)gridDim.x * BUILD_THREADS) {
        if (j == 0) store(out + 2 * tensor_at(0), 1, 0, one);
        E v = one;
        for (int i = 0; i < lg; ++i) {
            const int low = lg - 1 - i;
            const i64 idx = j >> low;
            const E ri = elem(r, r_plane, r_step, i);
            v = mul(v, (idx & 1) ? sub(one, ri) : ri);
            if ((j & (((i64)1 << low) - 1)) == 0)
                store(out + 2 * tensor_at(i + 1), (i64)2 << i, idx, v);
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
fg_build_expand(const u64* __restrict__ ep, i64 ep_plane, i64 ep_step, E inv_n, u64* out,
                u64* __restrict__ parts, int lg) {
    constexpr int CH = 1 << CHUNK_LOG;
    __shared__ u64 pw[2 * CH], xs[2 * CH];
    const i64 n = (i64)1 << lg;
    const i64 c = blockIdx.x;
    const int b = blockIdx.y, tid = threadIdx.x;
    const E one = {1, 0};
    if (tid == 0) store(pw, CH, 0, one);
    E sq = elem(ep, ep_plane, ep_step, b);
    __syncthreads();
    for (int i = 0; i < CHUNK_LOG; ++i) {
        const int width = 1 << i;
        for (int j = tid; j < width; j += BUILD_THREADS)
            store(pw, CH, width + j, mul(load(pw, CH, j), sq));
        sq = mul(sq, sq);
        __syncthreads();
    }
    // the chunk's high bits, lowest first; a thread keeps to its own words
    for (int i = CHUNK_LOG; i < lg; ++i) {
        if ((c >> (i - CHUNK_LOG)) & 1)
            for (int l = tid; l < CH; l += BUILD_THREADS) store(pw, CH, l, mul(load(pw, CH, l), sq));
        sq = mul(sq, sq);
    }
    const u64* last = out + 2 * ifft_at(lg, lg - 1);
    u64* scale = out + 2 * ifft_at(lg, lg);
    u64* expn = out + 2 * ifft_at(lg, lg + 1);
    u64* pws = out + 2 * (sums_at(lg) + POINTS);
    const i64 wide = n * POINTS;
    for (int l = tid; l < CH; l += BUILD_THREADS) {
        const i64 j = c * CH + l;
        const E p = load(pw, CH, l);
        store(pws, wide, b * n + j, p);
        const E s = mul(load(last, n, j), inv_n);
        if (b == 0) store(scale, n, j, s);
        const E x = mul(s, p);
        store(expn, wide, b * n + j, x);
        store(xs, CH, l, x);
    }
    __syncthreads();
    u64* src = xs;
    u64* dst = pw;
    for (int cnt = CH >> 1; cnt > 0; cnt >>= 1) {
        for (int i = tid; i < cnt; i += BUILD_THREADS)
            store(dst, CH, i, add(load(src, CH, 2 * i), load(src, CH, 2 * i + 1)));
        __syncthreads();
        swap_ptr(src, dst);
    }
    const i64 chunks = n >> CHUNK_LOG;
    if (tid == 0) store(parts, POINTS * chunks, b * chunks + c, load(src, CH, 0));
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
        store(a, HALF, i, add(load(row, plane, 2 * i), load(row, plane, 2 * i + 1)));
    __syncthreads();
    u64* src = a;
    u64* dst = bb;
    for (int cnt = chunks >> 2; cnt > 0; cnt >>= 1) {
        for (int i = tid; i < cnt; i += BUILD_THREADS)
            store(dst, HALF, i, add(load(src, HALF, 2 * i), load(src, HALF, 2 * i + 1)));
        __syncthreads();
        swap_ptr(src, dst);
    }
    if (tid == 0) store(out + 2 * sums_at(lg), POINTS, b, load(src, HALF, 0));
}

int build_blocks(i64 items) {
    const i64 want = (items + BUILD_THREADS - 1) / BUILD_THREADS;
    return want < BUILD_MAX_BLOCKS ? (int)want : BUILD_MAX_BLOCKS;
}

}  // namespace

// The fft_gkr circuit of 2^lg points: r (2, lg) and ep (2, 64) by plane and
// element strides, xp (2, 2^lg - 1), inv_n by value; out the buffer above,
// parts (2, 64, 2^(lg - CHUNK_LOG)) scratch above ONE_LAUNCH_LOG (else
// unused).  One launch up to ONE_LAUNCH_LOG, lg + 3 above it.
extern "C" int vpt_fg_build_circuit(const u64* r, i64 r_plane, i64 r_step, const u64* ep,
                                    i64 ep_plane, i64 ep_step, const u64* xp, u64 inv_re,
                                    u64 inv_im, u64* out, u64* parts, int lg, void* stream_ptr) {
    if (lg < 0 || lg > MAX_BUILD_LOG) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const E inv_n = {inv_re, inv_im};
    const i64 n = (i64)1 << lg;
    cudaError_t err;
    if (lg <= ONE_LAUNCH_LOG) {
        const size_t smem =
            sizeof(u64) * (6 * (size_t)n + (lg <= SHARED_TW_LOG ? 2 * (size_t)(n - 1) : 0));
        // above 48 KB of static and dynamic shared memory a block needs
        // the opt-in (the static part: r and 1 - r)
        if (smem + sizeof(E) * 2 * ONE_LAUNCH_LOG > 48 * 1024) {
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
