// X1 chains: whole tables and segment sums of GF((2^61-1)^2) elements on
// Hopper (sm_90a), one launch a call.
//
// Replaces chains of the JAX package's GF(p^2) ops that XLA fuses into one
// loop inside the jits, and that the port ran as one gf_mul or gf_lin
// launch a link (csrc/gf_ops.cu):
// - gf_table, the tables whose entry i is a product over the bits of i:
//   the beta (eq) tables (virgo_plus_tpu/gkr/beta.py:17,30: a product, a
//   difference and a concatenation per bit) and the power tables
//   (virgo_plus_tpu/pc/fft.py:26 powers, pc/fft_gkr.py:150 powers_el: a
//   product and a concatenation per doubling step);
// - gf_segsum, sums of segments of the last axis: the log-tree tree_sum
//   (virgo_plus_tpu/gkr/sumcheck.py:33, an add and a pad per level) and
//   the gate scatter (apply_scatter_arrays :96: a gather, the log2(N)
//   levels of the prefix sum :47, two gathers and a difference).
//
// Bits.  Every operation returns the canonical representative, so any
// order of the same products and sums gives the same bits as the JAX
// package and the plain twins on canonical inputs (every input at the call
// sites is canonical).  The arithmetic is field.cuh's, which assumes
// canonical inputs (gf_ops.cu repeats the twins' int64 steps instead, so
// that it agrees on any input; these entries do not).
//
// gf_table.  out (2, L, n) contiguous: L tables (the lead axis) of n
// entries.
//   beta:  out[., t, i] = init[t] * prod_{j<k} (bit_j(i) ? r[t, j] : 1 - r[t, j]),
//          n = 2^k;
//   power: out[., t, i] = base[t]^i, i < n, k = ceil(log2 n); the base is
//          a tensor (2, L), or one element whose k factors base^(2^j) the
//          host passes by value (L = 1).
// Entry i is a product of one factor a bit, so it splits into four
// groups of bits: a block writes 2^(task_log + 3) consecutive entries of
// one table, a warp 2^task_log of them as 32-entry chunks, and entry
// (block, warp, chunk, lane) = blk * wrp[warp] * mid[chunk] * lo[lane].  A
// block loads the table's factors into shared memory once (beta: r_j and
// 1 - r_j from strided r (r[:, :k], rs[:, :, j:j+1]) read in place; a
// by-value base's squarings from the host, in the launch's arguments
// (__grid_constant__: read in place), so nothing is copied from the host
// and a CUDA graph captures the launch; a tensor base's k squarings by
// one thread), then three warps make lo, mid and wb = blk wrp side by
// side, each from four chains of products and a tree (depth 3 up to eight
// bits, no product by one), one barrier; then a warp makes hb[chunk] =
// wb[warp] mid[chunk] for its 32 chunks at once, lane by lane, and each
// entry is one product hb[chunk] lo[lane], four chunks at a time, written
// coalesced to both planes.  No shuffle (nothing the compiler must make
// convergent), two barriers, and a dependent chain of five or six
// products whatever the table's size.  task_log is the largest (at most TASK_LOG) that still
// gives TABLE_BLOCKS blocks, down to MIN_TASK_LOG.
// What bounds it: the 16 bytes written per entry at 3.35 TB/s; one
// product an entry (12 32-bit multiplies) takes a quarter of that at the
// integer rate.  Below some thousands of entries a call is the launch
// and the chain of products.
//
// gf_segsum.  out (R, G) contiguous: R rows (the input's leading axes, up
// to SEG_AXES, any strides), G segments of the last axis:
//   out[row, g] = sum_{t in [starts[g], ends[g])} x[row, idx ? idx[t] : t],
// 0 for an empty segment; without starts, one segment [0, n).  Each
// summer adds canonical terms lazily in u64, folding by the Mersenne rule
// of gf.reduce_lazy after every LAZY terms (a canonical sum and 7 terms
// stay below 2^64), then warp shuffles and shared memory finish the sum.
// A summer keeps LAZY loads in flight: it loads LAZY terms, then adds
// them, rather than one dependent add a load.  Three shapes of summer,
// picked by the wrapper from the mean segment length: a thread per (row,
// segment) for short segments (the gate scatter, the phase-2 combine; a
// warp takes each of its segments longer than LONG_SEGMENT together, so
// that a skewed plan does not leave one thread with a long segment), a
// warp for moderate ones, and for long rows (tree sums over thousands of
// gates) a cluster of up to SEG_CLUSTER blocks an output: each block sums
// a contiguous chunk of the segment and writes its partial into the
// leader block's shared memory (distributed shared memory,
// cluster.map_shared_rank); one cluster barrier, and the leader folds the
// partials.  No work buffer, no ticket, no second launch.  The wrapper
// (field/chains.py seg_cluster) gives an output as many blocks as fill the
// card's SMs with the call's outputs, up to SEG_CLUSTER: 8 blocks each
// for the GKR prover's vres (2 outputs of 8,192 terms), one (today's
// block route) for B = 64's 128 rows.  Before,
// a block an output left 130 of 132 SMs idle on vres, each thread with
// one dependent chain of 32 adds.
// What bounds it: the bytes read (8 per row and term, plus the index) and
// written, at 3.35 TB/s; a call of few outputs, its latency: a launch, a
// chain of loads and the cluster barrier.
//
// Why CUDA and not Triton: exact 64-bit products (__umul64hi) and the
// loader and launch counting of kernels.py, shared with the other entries.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"

namespace cg = cooperative_groups;
using vpt::F2;
using vpt::u64;

namespace {

typedef long long i64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TASK_LOG = 10;          // most entries (log2) a warp writes
constexpr int MIN_TASK_LOG = 5;       // least: one chunk of 32
constexpr int TABLE_BLOCKS = 128;     // blocks a table call asks for, entries allowing
constexpr int MAX_BITS = 62;          // bits of a table index
constexpr int MAX_BLOCKS = 132 * 16;  // grid cap of the grid-stride loops
constexpr int SEG_AXES = 4;           // row axes of gf_segsum's input
constexpr int LAZY = 7;               // terms added between two folds
constexpr int LONG_SEGMENT = 64;      // longer segments: a warp each (SEG_THREAD)
constexpr int SEG_CLUSTER = 8;        // most blocks of a cluster an output (SEG_BLOCK)

enum { TABLE_BETA = 0, TABLE_POWER = 1 };
enum { SEG_THREAD = 0, SEG_WARP = 1, SEG_BLOCK = 2 };

__device__ __forceinline__ F2 one2() { return {1, 0}; }

// gf_table's product: field.cuh's mul2_split (fewer instructions than
// mul2 on the card, the same bits)
__device__ __forceinline__ F2 mul(F2 x, F2 y) { return vpt::mul2_split(x, y); }

// ---------------------------------------------------------------------------
// gf_table
// ---------------------------------------------------------------------------

struct TableArgs {
    const u64* a;        // init (beta) or base (power); null: by-value factors
    const u64* r;        // beta challenges
    u64* out;
    i64 a_plane, a_lead;             // element strides of a
    i64 r_plane, r_lead, r_bit;      // element strides of r
    long long n;                     // entries a table
    int k, lead, task_log, blocks;   // index bits, tables, a warp's entries, blocks a table
    u64 f[2 * MAX_BITS];             // by-value factors base^(2^j): (re, im), j < k
};

// prod_{b < n} (bit b of sel ? f1 : f0)[j0 + b]: four chains of products
// and a tree over the chains (depth 3 for n <= 8), no product by one
__device__ __forceinline__ F2 bit_product(const F2* f1, const F2* f0, int j0, int n,
                                          unsigned sel) {
    F2 acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
        acc[u] = u < n ? ((sel >> u) & 1 ? f1[j0 + u] : f0[j0 + u]) : one2();
    for (int b = 4; b < n; b += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = b + u;
            if (c < n)
                acc[u] = mul(acc[u], c < 32 && ((sel >> c) & 1) ? f1[j0 + c] : f0[j0 + c]);
        }
    if (n > 1) acc[0] = mul(acc[0], acc[1]);
    if (n > 3) acc[2] = mul(acc[2], acc[3]);
    if (n > 2) acc[0] = mul(acc[0], acc[2]);
    return acc[0];
}

template <int OP>
__global__ void __launch_bounds__(THREADS) gf_table(const __grid_constant__ TableArgs A) {
    __shared__ F2 f1[MAX_BITS], f0[MAX_BITS];   // factor j, bit j set / clear
    __shared__ F2 lo[32], mid[32], wb[WARPS], hb[WARPS][32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t = blockIdx.x / A.blocks;
    const unsigned bt = blockIdx.x - t * A.blocks;        // the block in its table
    const int tl = A.task_log;
    // the factors, once a block
    if (tid < A.k) {
        if constexpr (OP == TABLE_BETA) {
            const u64* rj = A.r + t * A.r_lead + tid * A.r_bit;
            const F2 r = {rj[0], rj[A.r_plane]};
            f1[tid] = r;
            f0[tid] = vpt::sub2(one2(), r);
        } else {
            if (!A.a) f1[tid] = {A.f[2 * tid], A.f[2 * tid + 1]};
            f0[tid] = one2();
        }
    }
    F2 init = one2();
    if (A.a) init = {A.a[t * A.a_lead], A.a[t * A.a_lead + A.a_plane]};
    if (OP == TABLE_POWER && A.a) {
        // a tensor base: its squarings, one thread
        if (tid == 0) {
            F2 x = init;
            for (int j = 0; j < A.k; ++j) {
                f1[j] = x;
                x = mul(x, x);
            }
        }
        init = one2();
    }
    __syncthreads();
    // the factors of an entry's bit groups, side by side: its lane's five
    // bits (lo), its chunk's task_log - 5 (mid, with the init), and its
    // warp's three times its block's (wb)
    const int bits = A.k < tl ? A.k : tl;    // the low bits the table has
    if (warp == 0) {
        lo[lane] = bit_product(f1, f0, 0, bits < 5 ? bits : 5, lane);
    } else if (warp == 1) {
        mid[lane] = bits > 5 ? mul(init, bit_product(f1, f0, 5, bits - 5, lane)) : init;
    } else if (warp == 2 && lane < WARPS) {
        const int w_bits = A.k - tl < 0 ? 0 : A.k - tl < 3 ? A.k - tl : 3;
        const F2 w = bit_product(f1, f0, tl, w_bits, lane);
        wb[lane] = A.k > tl + 3 ? mul(w, bit_product(f1, f0, tl + 3, A.k - tl - 3, bt)) : w;
    }
    __syncthreads();
    // a warp's entries: hb[lane] = wb[warp] mid[lane] for its chunk lane,
    // then one product an entry, four chunks at a time
    const F2 l = lo[lane];
    hb[warp][lane] = mul(wb[warp], mid[lane]);
    __syncwarp();
    const long long first = (((long long)bt << 3) + warp) << tl;
    const int chunks = 1 << (tl - 5);
    const long long plane = (long long)A.lead * A.n;
    u64* out = A.out + t * A.n;
    for (int m = 0; m < chunks && first + (m << 5) < A.n; m += 4) {
        F2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (u == 0 || m + u < chunks) v[u] = mul(hb[warp][m + u], l);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const long long e = first + ((m + u) << 5) + lane;
            if (m + u < chunks && e < A.n) {
                out[e] = v[u].re;
                out[plane + e] = v[u].im;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// gf_segsum
// ---------------------------------------------------------------------------

struct SegArgs {
    const u64* x;
    const i64* idx;      // term -> position on the last axis; null: itself
    const i64* starts;   // null: one segment [0, n)
    const i64* ends;
    u64* out;
    unsigned size[SEG_AXES];   // row axes' sizes
    i64 stride[SEG_AXES];      // their element strides
    i64 term;                  // element stride of the last axis
    long long n;               // length of the last axis
    long long outputs;         // R * G
    int g;                     // segments
};

__device__ __forceinline__ u64 fold(u64 s) {
    const u64 t = (s >> 61) + (s & vpt::P);
    return t >= vpt::P ? t - vpt::P : t;
}

// one segment of one row: its row's first word and its term range
struct Segment {
    const u64* x;
    long long lo, hi;
};

// (32-bit index arithmetic: the entry takes fewer than 2^31 outputs)
__device__ __forceinline__ Segment segment(const SegArgs& A, long long o) {
    const unsigned g = (unsigned)o % (unsigned)A.g;
    unsigned row = (unsigned)o / (unsigned)A.g;
    i64 off = 0;
#pragma unroll
    for (int d = SEG_AXES - 1; d >= 0; --d) {
        off += (i64)(row % A.size[d]) * A.stride[d];
        row /= A.size[d];
    }
    return {A.x + off, A.starts ? A.starts[g] : 0, A.starts ? A.ends[g] : A.n};
}

__device__ __forceinline__ u64 term(const SegArgs& A, const Segment& S, long long t) {
    return S.x[(A.idx ? A.idx[t] : t) * A.term];
}

// the canonical sum of the terms lo + lane, lo + lane + step, ... of a
// segment: LAZY loads in flight (those past the segment predicated off),
// then their sum and one fold (a canonical sum and LAZY terms stay below
// 2^64)
__device__ __forceinline__ u64 partial(const SegArgs& A, Segment S, int lane, int step) {
    u64 s = 0;
    for (long long t = S.lo + lane; t < S.hi; t += (long long)LAZY * step) {
        u64 v[LAZY];
#pragma unroll
        for (int u = 0; u < LAZY; ++u) {
            const long long k = t + (long long)u * step;
            v[u] = k < S.hi ? term(A, S, k) : 0;
        }
#pragma unroll
        for (int u = 0; u < LAZY; ++u) s += v[u];
        s = fold(s);
    }
    return s;
}

// the sum over the warp, in every lane
__device__ __forceinline__ u64 warp_sum(u64 s) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s = vpt::addp(s, __shfl_xor_sync(0xffffffffu, s, d));
    return s;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) gf_segsum(SegArgs A) {
    const int lane = threadIdx.x & 31;
    if constexpr (MODE == SEG_THREAD) {
        // a thread an output; a warp sums its segments longer than
        // LONG_SEGMENT together, one after the other, so that one long
        // segment among short ones costs its length / 32 steps
        for (long long first = (long long)blockIdx.x * THREADS + threadIdx.x - lane;
             first < A.outputs; first += (long long)gridDim.x * THREADS) {
            const long long o = first + lane;
            const Segment S = segment(A, o < A.outputs ? o : first);
            const bool alone = o < A.outputs && S.hi - S.lo <= LONG_SEGMENT;
            u64 s = alone ? partial(A, S, 0, 1) : 0;
            for (unsigned together = __ballot_sync(0xffffffffu, o < A.outputs && !alone);
                 together; together &= together - 1) {
                const int l = __ffs(together) - 1;
                const u64 t = warp_sum(partial(A, segment(A, first + l), lane, 32));
                if (lane == l) s = t;
            }
            if (o < A.outputs) A.out[o] = s;
        }
    } else if constexpr (MODE == SEG_WARP) {
        for (long long o = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5; o < A.outputs;
             o += (long long)gridDim.x * WARPS) {
            const u64 s = warp_sum(partial(A, segment(A, o), lane, 32));
            if (lane == 0) A.out[o] = s;
        }
    } else {
        // a cluster of cs blocks an output (cs = 1: a block), block `rank`
        // summing the rank-th chunk of its segment
        __shared__ u64 sh[WARPS];
        __shared__ u64 parts[SEG_CLUSTER];
        cg::cluster_group cluster = cg::this_cluster();
        const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
        const int warp = threadIdx.x >> 5;
        for (long long o = blockIdx.x / cs; o < A.outputs; o += gridDim.x / cs) {
            Segment S = segment(A, o);
            const long long chunk = (S.hi - S.lo + cs - 1) / cs;
            S.lo = min(S.hi, S.lo + rank * chunk);
            S.hi = min(S.hi, S.lo + chunk);
            u64 s = warp_sum(partial(A, S, threadIdx.x, THREADS));
            if (lane == 0) sh[warp] = s;
            __syncthreads();
            if (warp == 0) {
                s = warp_sum(lane < WARPS ? sh[lane] : 0);
                if (lane == 0) {
                    if (cs == 1) A.out[o] = s;
                    else cluster.map_shared_rank(parts, 0)[rank] = s;
                }
            }
            if (cs == 1) {
                __syncthreads();
                continue;
            }
            cluster.sync();   // every partial in the leader's parts
            if (rank == 0 && warp == 0) {
                s = warp_sum(lane < cs ? parts[lane] : 0);
                if (lane == 0) A.out[o] = s;
            }
            if (o + gridDim.x / cs < A.outputs)
                cluster.sync();   // parts read before the next output's
        }
    }
}

int capped(long long blocks) { return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS); }

}  // namespace

// out (2, lead, n) = the tables of op (0 beta, 1 power), k index bits
// (n = 2^k for beta, n <= 2^k for power).  a: init (beta) or base
// (power) with element strides (a_plane, a_lead); null for a power table
// of a by-value base, lead = 1, whose k factors base^(2^j) are `factors`
// (host memory, (re, im) pairs, copied into the launch's arguments).  r:
// the beta challenges, strides (r_plane, r_lead, r_bit).  One launch, none
// for an empty output.
extern "C" int vpt_gf_table(int op, const u64* a, const u64* r, u64* out, int lead,
                            int k, long long n, long long a_plane, long long a_lead,
                            long long r_plane, long long r_lead, long long r_bit,
                            const u64* factors, void* stream_ptr) {
    if (lead <= 0 || n <= 0) return 0;
    if (k < 0 || k > MAX_BITS || n > (1ll << k) || (op == TABLE_BETA && (!a || (k && !r)))
        || (op == TABLE_POWER && !a && (lead != 1 || (k && !factors))))
        return (int)cudaErrorInvalidValue;
    TableArgs A = {a, r, out, a_plane, a_lead, r_plane, r_lead, r_bit, n, k, lead,
                   TASK_LOG, 0, {}};
    // a block writes 2^(task_log + 3) entries: the largest task that still
    // gives TABLE_BLOCKS blocks, down to MIN_TASK_LOG
    auto blocks = [&](int log) { return (n + (1ll << (log + 3)) - 1) >> (log + 3); };
    while (A.task_log > MIN_TASK_LOG && blocks(A.task_log) * lead < TABLE_BLOCKS) --A.task_log;
    if (blocks(A.task_log) * lead >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    A.blocks = (int)blocks(A.task_log);
    if (op == TABLE_POWER && !a)
        for (int j = 0; j < 2 * k; ++j) A.f[j] = factors[j];
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const unsigned grid = (unsigned)(A.blocks * lead);
    switch (op) {
        case TABLE_BETA: gf_table<TABLE_BETA><<<grid, THREADS, 0, stream>>>(A); break;
        case TABLE_POWER: gf_table<TABLE_POWER><<<grid, THREADS, 0, stream>>>(A); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// out (R, g) = the segment sums of x's last axis (length n, element
// stride term) for every row (SEG_AXES row axes of sizes d0..d3, element
// strides s0..s3; R = d0 d1 d2 d3).  idx: the terms' positions (null:
// contiguous); starts, ends: the g segments' term ranges (null: g = 1,
// the segment [0, n)).  mode: 0 a thread, 1 a warp, 2 a cluster of
// `cluster` blocks (1 to SEG_CLUSTER; 1 for the other modes) per output.
// One launch, none for an empty output.
extern "C" int vpt_gf_segsum(const u64* x, const i64* idx, const i64* starts,
                             const i64* ends, u64* out, int g, long long n,
                             int d0, int d1, int d2, int d3, long long s0,
                             long long s1, long long s2, long long s3,
                             long long term, int mode, int cluster, void* stream_ptr) {
    const long long outputs = (long long)d0 * d1 * d2 * d3 * g;
    if (outputs <= 0) return 0;
    if ((starts == nullptr) != (ends == nullptr) || (!starts && g != 1) || cluster < 1
        || cluster > (mode == SEG_BLOCK ? SEG_CLUSTER : 1) || outputs >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    const SegArgs A = {x, idx, starts, ends, out,
                       {(unsigned)d0, (unsigned)d1, (unsigned)d2, (unsigned)d3},
                       {s0, s1, s2, s3}, term, n, outputs, g};
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    switch (mode) {
        case SEG_THREAD:
            gf_segsum<SEG_THREAD><<<capped((outputs + THREADS - 1) / THREADS), THREADS, 0, stream>>>(A);
            break;
        case SEG_WARP:
            gf_segsum<SEG_WARP><<<capped((outputs + WARPS - 1) / WARPS), THREADS, 0, stream>>>(A);
            break;
        case SEG_BLOCK: {
            cudaLaunchConfig_t cfg = {};
            cudaLaunchAttribute at[1];
            at[0].id = cudaLaunchAttributeClusterDimension;
            at[0].val.clusterDim.x = (unsigned)cluster;
            at[0].val.clusterDim.y = 1;
            at[0].val.clusterDim.z = 1;
            cfg.gridDim = dim3((unsigned)(capped(outputs * cluster) / cluster * cluster));
            cfg.blockDim = dim3(THREADS);
            cfg.stream = stream;
            cfg.attrs = at;
            cfg.numAttrs = 1;
            const cudaError_t e = cudaLaunchKernelEx(&cfg, gf_segsum<SEG_BLOCK>, A);
            if (e != cudaSuccess) return (int)e;
            break;
        }
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
