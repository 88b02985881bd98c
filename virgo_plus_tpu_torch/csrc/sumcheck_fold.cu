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
// What bounds it on the H100: each round reads the live half of three
// tables and writes a quarter; seven extension products per pair per round
// (21 64x64->128-bit products) put it near the balance of memory and the
// integer-multiply rate, and bytes bound it at every main-path shape.  At
// those shapes (2^7 to 2^13 entries, K up to 63) a call is a few
// microseconds of work spread over bl dependent rounds, so what it costs is
// launches (a few microseconds each) and then the latency of each round.
//
// Design: one launch per call, whatever bl.
// - Natural pairs never cross a chunk of 2^c entries, and the challenges
//   are known before the call, so a table splits into B = 2^(bl-c)
//   contiguous chunks that fold independently for c rounds.  Block (k, b)
//   folds chunk b of table k in dynamic shared memory (six u64 planes,
//   v/a/m x re/im: 3 * 2^c * 16 B, 196,608 B at c = 12), writes its round
//   sums as partial rows and its folded (v, a, m) to device memory, then
//   takes a ticket (device-scope fence, atomicInc).  The last block of a
//   table sums the B partial rows of each of the c rounds, loads the B
//   chunk results as a table of its own and folds the last bl - c rounds.
//   atomicInc wraps the last block's ticket back to 0, so the tickets,
//   zeroed once when the wrapper allocates them, need no reset per call.
//   The wrapper picks c (sumcheck.fold_chunk_log) so that the grid spreads
//   over the SMs; with B = 1 the one block writes polys and bound itself.
// - In a block, each pair is bound in place, with a barrier between a
//   round's (or chunk's) reads and its writes.  A round of more than
//   SPLIT_PAIRS pairs is bound by the multiply rate: each thread takes whole
//   pairs, in chunks of one per thread (a later chunk's reads lie above
//   every earlier chunk's writes), and the six sums go through warp
//   shuffles and shared memory.  A smaller round is bound by latency (one
//   thread's seven extension products in a row took about 2.6 us): there
//   LANES lanes share a pair, one product each; the rounds ping-pong between
//   two small buffers, so one barrier a round suffices; and the per-warp
//   sums wait in shared memory until the last small round, when one warp
//   per round reduces them all at once.
// Every addition reduces mod p, so the sums are canonical and the order of
// the reduction does not change a bit (no 64-bit atomicAdd, which would wrap
// mod 2^64).
#include <cuda_runtime.h>
#include "field.cuh"

using vpt::F2;
using vpt::u64;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LOG = 12;                   // largest table (log2) one block holds
constexpr int LANES = 8;                      // lanes that share one pair in a small round
constexpr int SPLIT_PAIRS = THREADS / LANES;  // largest small round (pairs)
constexpr int SMALL_ROUNDS = 7;               // rounds of SPLIT_PAIRS, ..., 2, 1 pairs
constexpr int MAX_BL = 32;

struct __align__(16) Shared {
    u64 sh[6][WARPS];                            // block_reduce6
    __align__(16) u64 small[2][6][SPLIT_PAIRS];  // small-round ping-pong tables
    u64 sums[SMALL_ROUNDS][4][WARPS][2];         // small-round per-warp sums by role
    u64 r[2][MAX_BL];                            // this table's challenges
    int last;
};

// Sum six words over the block; the result is in thread 0.  Ends with a
// barrier, so `sh` may be reused right after.
__device__ __forceinline__ void block_reduce6(u64 acc[6], u64 (*sh)[WARPS]) {
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
        for (int t = 0; t < 6; ++t) acc[t] = lane < WARPS ? sh[t][lane] : 0ull;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int t = 0; t < 6; ++t)
                acc[t] = vpt::addp(acc[t], __shfl_down_sync(0xffffffffu, acc[t], off));
        }
    }
    __syncthreads();
}

__device__ __forceinline__ void load_pair(const u64* src, size_t plane, size_t off, F2& x0,
                                          F2& x1) {
    const ulonglong2 re = *reinterpret_cast<const ulonglong2*>(src + off);
    const ulonglong2 im = *reinterpret_cast<const ulonglong2*>(src + plane + off);
    x0 = {re.x, im.x};
    x1 = {re.y, im.y};
}

// One pair: the six round-sum terms into acc, the bound values out.
__device__ __forceinline__ void fold_pair(F2 v0, F2 v1, F2 a0, F2 a1, F2 m0, F2 m1, F2 r,
                                          u64 acc[6], F2& nv, F2& na, F2& nm) {
    const F2 dvv = vpt::sub2(v1, v0);
    const F2 daa = vpt::sub2(a1, a0);
    const F2 dmm = vpt::sub2(m1, m0);
    const F2 pa = vpt::mul2(dmm, dvv);
    const F2 pb = vpt::add2(vpt::add2(vpt::mul2(dmm, v0), vpt::mul2(m0, dvv)), daa);
    const F2 pc = vpt::add2(vpt::mul2(m0, v0), a0);
    acc[0] = vpt::addp(acc[0], pa.re); acc[1] = vpt::addp(acc[1], pa.im);
    acc[2] = vpt::addp(acc[2], pb.re); acc[3] = vpt::addp(acc[3], pb.im);
    acc[4] = vpt::addp(acc[4], pc.re); acc[5] = vpt::addp(acc[5], pc.im);
    nv = vpt::add2(v0, vpt::mul2(dvv, r));
    na = vpt::add2(a0, vpt::mul2(daa, r));
    nm = vpt::add2(m0, vpt::mul2(dmm, r));
}

// c ? a : b by masks, so that lanes of different roles never branch apart
__device__ __forceinline__ F2 pick(bool c, F2 a, F2 b) {
    const u64 m = 0ull - (u64)c;
    return {(a.re & m) | (b.re & ~m), (a.im & m) | (b.im & ~m)};
}

// A wide round (half > SPLIT_PAIRS) on the table tab (6 planes of stride n),
// in place; returns the six sums in thread 0.
__device__ __forceinline__ void wide_round(u64* tab, size_t n, size_t half, F2 r,
                                           u64 acc[6], u64 (*sh)[WARPS]) {
#pragma unroll
    for (int t = 0; t < 6; ++t) acc[t] = 0ull;
    for (size_t base = 0; base < half; base += THREADS) {
        const size_t i = base + threadIdx.x;
        F2 nv, na, nm;
        if (i < half) {
            F2 v0, v1, a0, a1, m0, m1;
            load_pair(tab, n, 2 * i, v0, v1);
            load_pair(tab + 2 * n, n, 2 * i, a0, a1);
            load_pair(tab + 4 * n, n, 2 * i, m0, m1);
            fold_pair(v0, v1, a0, a1, m0, m1, r, acc, nv, na, nm);
        }
        __syncthreads();  // this chunk's reads before its writes
        if (i < half) {
            tab[i] = nv.re;
            tab[n + i] = nv.im;
            tab[2 * n + i] = na.re;
            tab[3 * n + i] = na.im;
            tab[4 * n + i] = nm.re;
            tab[5 * n + i] = nm.im;
        }
    }
    block_reduce6(acc, sh);  // its barriers also publish the writes
}

// A small round (half <= SPLIT_PAIRS) from src (6 planes of stride sn) into
// dst (6 planes of stride SPLIT_PAIRS): pair i = tid / LANES, and each of
// its LANES lanes computes one of the seven extension products.  Role q:
// 0 pa = dm*dv, 1 dm*v0 + da, 2 m0*dv (1 and 2 sum to pb), 3 pc = m0*v0 +
// a0, 4..6 the bound v, a, m = x0 + dx*r; 7 idle.  Each warp leaves its
// sums of roles 0..3 in sums[role][warp].
__device__ __forceinline__ void small_round(const u64* src, size_t sn, u64* dst, size_t half,
                                            F2 r, u64 (*sums)[WARPS][2]) {
    const int q = threadIdx.x % LANES;
    const size_t i = threadIdx.x / LANES;
    const bool on = i < half && q < 7;
    F2 res = {0ull, 0ull};
    if (on) {
        F2 v0, v1, a0, a1, m0, m1;
        load_pair(src, sn, 2 * i, v0, v1);
        load_pair(src + 2 * sn, sn, 2 * i, a0, a1);
        load_pair(src + 4 * sn, sn, 2 * i, m0, m1);
        const F2 dv = vpt::sub2(v1, v0);
        const F2 da = vpt::sub2(a1, a0);
        const F2 dm = vpt::sub2(m1, m0);
        const F2 zero = {0ull, 0ull};
        const F2 x = pick(q == 4, dv, pick(q == 5, da, pick(q == 2 || q == 3, m0, dm)));
        const F2 y = pick(q >= 4, r, pick(q == 0 || q == 2, dv, v0));
        const F2 z = pick(q == 1, da, pick(q == 3 || q == 5, a0,
                                           pick(q == 4, v0, pick(q == 6, m0, zero))));
        res = vpt::add2(vpt::mul2(x, y), z);
    }
    if (on && q >= 4) {
        const int t = 2 * (q - 4);
        dst[t * SPLIT_PAIRS + i] = res.re;
        dst[(t + 1) * SPLIT_PAIRS + i] = res.im;
    }
    // sum roles 0..3 over the warp's pairs
    u64 re = (on && q < 4) ? res.re : 0ull;
    u64 im = (on && q < 4) ? res.im : 0ull;
#pragma unroll
    for (int off = 16; off >= LANES; off >>= 1) {
        re = vpt::addp(re, __shfl_down_sync(0xffffffffu, re, off));
        im = vpt::addp(im, __shfl_down_sync(0xffffffffu, im, off));
    }
    const int lane = threadIdx.x & 31;
    if (lane < 4) {
        sums[lane][threadIdx.x >> 5][0] = re;
        sums[lane][threadIdx.x >> 5][1] = im;
    }
    __syncthreads();  // dst complete before the next round reads it
}

// Warp w < rounds: the round sums of small round w from its per-warp sums,
// written as row (first + w) of out (rows out_stride words apart).
__device__ __forceinline__ void small_sums(u64 (*sums)[4][WARPS][2], int rounds,
                                           int first, u64* out, size_t out_stride) {
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (w >= rounds) return;
    const int role = lane & 3;
    const int grp = lane >> 2;  // warps grp and grp + 8
    u64 re = vpt::addp(sums[w][role][grp][0], sums[w][role][grp + 8][0]);
    u64 im = vpt::addp(sums[w][role][grp][1], sums[w][role][grp + 8][1]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
        re = vpt::addp(re, __shfl_xor_sync(0xffffffffu, re, off));
        im = vpt::addp(im, __shfl_xor_sync(0xffffffffu, im, off));
    }
    const u64 re2 = __shfl_down_sync(0xffffffffu, re, 1);
    const u64 im2 = __shfl_down_sync(0xffffffffu, im, 1);
    // a row: coef a, b, c real, then imaginary; pb = role 1 + role 2
    if (lane == 0 || lane == 1 || lane == 3) {
        u64* row = out + (size_t)(first + w) * out_stride;
        const int coef = lane == 3 ? 2 : lane;
        row[coef] = lane == 1 ? vpt::addp(re, re2) : re;
        row[3 + coef] = lane == 1 ? vpt::addp(im, im2) : im;
    }
}

// All rounds j0 .. j0 + lg - 1 of the 2^lg-entry table in tab (6 planes,
// stride 2^lg); round j's sums go to row j - j0 of out (rows out_stride
// words apart).  Returns where the folded v.re lies; the other five words
// follow at the returned stride.
__device__ const u64* fold_block(u64* tab, int lg, int j0, Shared& s, u64* out,
                                 size_t out_stride, size_t& fin_stride) {
    const size_t n = (size_t)1 << lg;
    size_t live = n;
    int j = j0;
    for (; j < j0 + lg && (live >> 1) > SPLIT_PAIRS; ++j) {
        u64 acc[6];
        wide_round(tab, n, live >> 1, {s.r[0][j], s.r[1][j]}, acc, s.sh);
        if (threadIdx.x == 0) {
            u64* row = out + (size_t)(j - j0) * out_stride;
#pragma unroll
            for (int coef = 0; coef < 3; ++coef) {
                row[coef] = acc[2 * coef];          // real plane
                row[3 + coef] = acc[2 * coef + 1];  // imaginary plane
            }
        }
        live >>= 1;
    }
    if (j == j0 + lg) {  // a table of one entry
        fin_stride = n;
        return tab;
    }
    const u64* src = tab;
    size_t sn = n;
    const int first = j;
    for (int t = 0; j < j0 + lg; ++j, ++t) {
        u64* dst = &s.small[t & 1][0][0];
        small_round(src, sn, dst, live >> 1, {s.r[0][j], s.r[1][j]}, s.sums[t]);
        src = dst;
        sn = SPLIT_PAIRS;
        live >>= 1;
    }
    small_sums(s.sums, j - first, first - j0, out, out_stride);
    __syncthreads();
    fin_stride = SPLIT_PAIRS;
    return src;
}

// grid: K * B blocks, B = 2^(bl - c).  work: partial rows (K, B, c, 6), then
// chunk results (K, B, 6); tickets: K words, zero on entry and on exit.
__global__ void __launch_bounds__(THREADS) sumcheck_fold(
        const u64* __restrict__ sv, const u64* __restrict__ sa, const u64* __restrict__ sm,
        const u64* __restrict__ rs, u64* __restrict__ polys, u64* __restrict__ bound,
        u64* work, unsigned int* tickets, int K, int bl, int c) {
    extern __shared__ __align__(16) u64 tab[];  // planes v.re, v.im, a.re, a.im, m.re, m.im
    __shared__ Shared s;
    const int B = 1 << (bl - c);
    const int k = blockIdx.x >> (bl - c);
    const int b = blockIdx.x & (B - 1);
    if (threadIdx.x < bl) {
        s.r[0][threadIdx.x] = rs[(size_t)k * bl + threadIdx.x];
        s.r[1][threadIdx.x] = rs[(size_t)K * bl + (size_t)k * bl + threadIdx.x];
    }
    const size_t C = (size_t)1 << c;
    const size_t plane = (size_t)K << bl;
    const size_t g0 = ((size_t)k << bl) + (size_t)b * C;
#pragma unroll 4
    for (size_t i = threadIdx.x; i < C; i += THREADS) {
        tab[i] = sv[g0 + i];
        tab[C + i] = sv[plane + g0 + i];
        tab[2 * C + i] = sa[g0 + i];
        tab[3 * C + i] = sa[plane + g0 + i];
        tab[4 * C + i] = sm[g0 + i];
        tab[5 * C + i] = sm[plane + g0 + i];
    }
    __syncthreads();

    size_t fs;
    const u64* fin;
    if (B > 1) {
        u64* partials = work;
        u64* chunks = partials + (size_t)K * B * c * 6;
        fin = fold_block(tab, c, 0, s, partials + ((size_t)k * B + b) * c * 6, 6, fs);
        if (threadIdx.x < 6) chunks[((size_t)k * B + b) * 6 + threadIdx.x] = fin[threadIdx.x * fs];
        __threadfence();  // the partial rows and the chunk result before the ticket
        __syncthreads();
        // tickets 0 .. B-1; the last one wraps the word back to 0
        if (threadIdx.x == 0) s.last = atomicInc(tickets + k, (unsigned)(B - 1)) == (unsigned)(B - 1);
        __syncthreads();
        if (!s.last) return;
        __threadfence();
        // rounds 0..c-1: warp j sums the B partial rows of round j
        const int lane = threadIdx.x & 31;
        for (int j = threadIdx.x >> 5; j < c; j += WARPS) {
            u64 acc[6] = {0, 0, 0, 0, 0, 0};
            for (int bb = lane; bb < B; bb += 32) {
                const u64* p = partials + (((size_t)k * B + bb) * c + j) * 6;
#pragma unroll
                for (int t = 0; t < 6; ++t) acc[t] = vpt::addp(acc[t], __ldcg(p + t));
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                for (int t = 0; t < 6; ++t)
                    acc[t] = vpt::addp(acc[t], __shfl_down_sync(0xffffffffu, acc[t], off));
            }
            if (lane == 0) {
                u64* row = polys + ((size_t)j * K + k) * 6;
#pragma unroll
                for (int t = 0; t < 6; ++t) row[t] = acc[t];
            }
        }
        // the B chunk results, as a table of their own
        for (int i = threadIdx.x; i < B; i += THREADS) {
#pragma unroll
            for (int p = 0; p < 6; ++p)
                tab[(size_t)p * B + i] = __ldcg(chunks + ((size_t)k * B + i) * 6 + p);
        }
        __syncthreads();
        fin = fold_block(tab, bl - c, c, s, polys + ((size_t)c * K + k) * 6, (size_t)K * 6, fs);
    } else {
        fin = fold_block(tab, c, 0, s, polys + (size_t)k * 6, (size_t)K * 6, fs);
    }
    if (threadIdx.x < 6) bound[(size_t)threadIdx.x * K + k] = fin[threadIdx.x * fs];
}

}  // namespace

// v, a, m: (2, K, 2^bl); rs: (2, K, bl); polys: (bl, K, 2, 3);
// bound: (3, 2, K) = bound v, a, m.  c: log2 of the entries a block folds,
// bl - MAX_LOG <= c <= min(bl, MAX_LOG); with B = 2^(bl - c) > 1, work
// holds K * B * (c + 1) * 6 words and tickets K words that are zero (both
// unused when B = 1), and no other call may use those tickets meanwhile.
// 1 <= bl <= MAX_BL.  One launch.
extern "C" int vpt_sumcheck_fold(const u64* v, const u64* a, const u64* m,
                                 const u64* rs, u64* polys, u64* bound, u64* work,
                                 unsigned int* tickets, int K, int bl, int c,
                                 void* stream_ptr) {
    if (bl < 1 || bl > MAX_BL || c < 0 || c > bl || c > MAX_LOG || bl - c > MAX_LOG)
        return (int)cudaErrorInvalidValue;
    // the dynamic shared memory of the largest table, allowed once a device
    constexpr int MAX_DEVICES = 64;
    static bool smem_allowed[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !smem_allowed[dev]) {
        err = cudaFuncSetAttribute(sumcheck_fold, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(6 * sizeof(u64)) << MAX_LOG);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) smem_allowed[dev] = true;
    }
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const int B = 1 << (bl - c);
    const int smem = (int)(6 * sizeof(u64)) << (c > bl - c ? c : bl - c);
    sumcheck_fold<<<K * B, THREADS, smem, stream>>>(v, a, m, rs, polys, bound, work, tickets,
                                                    K, bl, c);
    return (int)cudaGetLastError();
}
