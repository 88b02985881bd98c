// The Fiat-Shamir prover's scans on Hopper (sm_90a): every round of an FS
// sumcheck in one launch with the sponge on the card (fs_sumcheck), and an
// absorb-then-squeeze stream in one launch (fs_sponge).
//
// Replaces the JAX package's lax.scans of the FS prover, whose bodies XLA
// fuses with K2's hash (virgo_plus_tpu/pallas_kernels/keccak_chain.py:100)
// inside: fs_scan_sumcheck (virgo_plus_tpu/gkr/fs.py:112), the joint phase
// 2 of _fs_layer (:274), absorb_elems (:58) and squeeze_vec (:94).  Their
// plain twins are gkr/fs.py's fs_sumcheck_plain (fs_scan_sumcheck_plain and
// _phase2_plain) and fs_sponge_plain.
//
// The sponge (gkr/fs.py's spec): a state D of 4 words; absorb(e0, e1):
// D <- SHA3-256(e0.re e0.im e1.re e1.im || D), a stream of elements
// absorbed pairwise and zero-padded; squeeze: h = SHA3-256(D || 1 || 0 0 0),
// D <- SHA3-256(D || 2 || 0 0 0), the challenge (h0, h1) reduced as
// gf.reduce_lazy does (the unsigned h mod p).  The sponge runs on one warp
// on K2's lane-pair Keccak-f (keccak.cuh): the state in its bit-interleaved
// form across the chain, only the absorbed words and the challenge
// converted, the two hashes of a squeeze side by side on two lane pairs,
// only the chain of states serial.  The field steps are gf_int64.cuh's,
// the plain ops' own, so every product and sum equals the twin's on any
// input, and the round sums (of canonical terms) in any order.
//
// What bounds it: a chain.  A round's challenge needs its polynomial (the
// sum over every live pair of every table), then three dependent Keccak-f
// (two absorbs, then the squeeze's two hashes side by side), and the next
// round needs the tables bound at that challenge.  So a round costs at
// least three permutations' latency, whatever the card's rates; the design
// keeps everything else in a round near a microsecond: no global memory
// between the blocks, no full cluster barrier, no GPU-scope fence.
//
// fs_sumcheck: one cluster of C blocks (C = 1 to 16, a power of two, the
// wrapper's choice by the first round's pairs) and a plan made on the host
// (make_plan; the wrapper asks for it through vpt_fs_sumcheck_plan to size
// the scratch and pick the route).  T_j are the tables
// after j rounds (T_0 the inputs; v, a, m; phase 1 and Liu are one table,
// the joint phase 2 every dad table of the layer, each with its own bl),
// R_j round j's challenge, and T_{j+1} = T_j bound at R_j.
// - Round j's polynomial is a quadratic in R_{j-1} whose coefficients the
//   quads (four elements) of T_{j-1} give: a pair of T_j is a quad of
//   T_{j-1} bound at R_{j-1}, so each of its terms (dm·dv, dm·v0 + m0·dv +
//   da, m0·v0 + a0) is a product of two linear polynomials in R_{j-1}
//   (three products each, Karatsuba), and a table that ends at round j
//   adds its v·m + a to the a_term chain, a quadratic of a pair of
//   T_{j-1}.  Field sums and products are exact, so evaluating the summed
//   quadratics at R_{j-1} gives the twin's canonical words.
// - So the passes leave the chain: warp 0 runs the rounds (wait for the
//   round's summed coefficients, evaluate them at R_{j-1} on four lanes,
//   the a_term chain, absorb, absorb, squeeze, publish R_j on an
//   mbarrier), while the worker warps (1-3 and 5-7: warp 4 shares warp 0's
//   SM sub-partition, whose integer pipe the sponge keeps busy) make round
//   j + 2's coefficients during round j + 1: pass j + 2 binds T_j at R_j
//   into T_{j+1} and sums the coefficients of T_{j+1}'s quads, each thread
//   on consecutive elements, with a named barrier between passes.  The
//   workers' warp sums meet at warp 1, which stores the block's part into
//   every block of the round with st.async onto that block's mbarrier of
//   the round mod 4 (four buffers: a block writes round j + 4's part only
//   after every block has read round j's); warp 4 of each block waits for
//   the mbarrier, sums the parts and hands the total to warp 0 (an
//   mbarrier).  Every block runs the rounds' sponge itself and gets the
//   same R, so R needs no broadcast between blocks.  Pass 0 sums round 0's
//   terms from the inputs; the last pass binds T_mdb (the bound scalars).
// - Rounds 0 .. J - 2 run on the whole cluster.  Table t is cut into
//   2^k_t contiguous chunks, one a block (k_t = min(c, bl_t - J - 1), 0
//   for a table that ends by J: a chunk of T_{J-1} holds whole quads), so
//   binding (2i, 2i + 1) into i keeps a chunk in its block; T_j lives in the block's store (shared memory where the
//   bound halves fit a block's 227 KB, else a global buffer only that block
//   touches: the route is the wrapper's, by shape, as the scratch pointer).
// - Pass J gathers: it stores each block's chunk of T_{J-1} into block 0's
//   shared memory (the tail) with st.async, its parts go to block 0 only,
//   and the other blocks leave.  Rounds J - 1 .. mdb - 1 run in block 0.
// - The only cluster barrier is at the start (relaxed arrive, wait): the
//   mbarriers' init must be seen by every block before a st.async.  In the
//   rounds, no block touches another's memory but through st.async.
// Block 0 writes the polynomials, challenges, bound scalars and D' in their
// final layout, and absorbs table 0's bound v after the rounds when asked
// (the claim absorbed after phase 1 and after Liu).
#include <cooperative_groups.h>

#include "gf_int64.cuh"
#include "keccak.cuh"

namespace cg = cooperative_groups;

namespace {

using vpt64::E;
typedef long long i64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;             // fs_sumcheck's block: warp 0 the rounds,
constexpr int COLLECTOR = 4;             // warp 4 the parts' sums,
constexpr int WORKERS = 6;               // warps 1-3 and 5-7 the passes
constexpr int MAX_CLUSTER = 16;          // most blocks a cluster
constexpr int MAX_TABLES = 128;          // most tables a call
constexpr int QW = 24;                   // a part: p0, p1, p2, the a_term sum, each c0 c1 c2
constexpr int RING = 4;                  // the parts' buffers, by round mod 4
constexpr int HEAD = 88;                 // words ahead of the buffers: 8 mbarriers, 2 R,
                                         // 2 totals, the block's part
constexpr int SMEM_MAX = 232448;         // an H100 block's shared memory

// ---- the sponge on one warp (every lane takes part) ------------------------

// D <- SHA3-256(w0 w1 w2 w3 || D); d holds this lane's halves of D's words
__device__ __forceinline__ void absorb_block(u32 d[4], u64 w0, u64 w1, u64 w2, u64 w3,
                                             int role) {
    u32 s[25];
    s[0] = half_of(w0, role);
    s[1] = half_of(w1, role);
    s[2] = half_of(w2, role);
    s[3] = half_of(w3, role);
#pragma unroll
    for (int w = 0; w < 4; ++w) s[4 + w] = d[w];
    sha3_64_pair(s, role);
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] = s[w];
}

// One squeeze: lane pairs of even index hash D || 1 (the challenge's
// digest), those of odd index D || 2 (the next state), side by side.
// Returns the challenge on every lane; d becomes the next state.
__device__ __forceinline__ E squeeze(u32 d[4], int lane) {
    const int role = lane & 1;
    u32 s[25];
#pragma unroll
    for (int w = 0; w < 4; ++w) s[w] = d[w];
    s[4] = half_of((lane & 2) ? 2ull : 1ull, role);
    s[5] = s[6] = s[7] = 0u;
    sha3_64_pair(s, role);
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] = __shfl_sync(FULL, s[w], lane | 2);
    const u64 h0 = join_halves(__shfl_sync(FULL, s[0], 0), __shfl_sync(FULL, s[0], 1));
    const u64 h1 = join_halves(__shfl_sync(FULL, s[1], 0), __shfl_sync(FULL, s[1], 1));
    return {vpt64::lin<vpt64::LIN_REDUCE>(h0, 0), vpt64::lin<vpt64::LIN_REDUCE>(h1, 0)};
}

// lane 0 writes the state's 4 words to out[0..3]
__device__ __forceinline__ void store_state(const u32 d[4], int lane, u64* out) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        const u64 x = join_halves(__shfl_sync(FULL, d[w], 0), __shfl_sync(FULL, d[w], 1));
        if (lane == 0) out[w] = x;
    }
}

// ---- fs_sponge ----------------------------------------------------------------

// D (4,); elements el (2, k) with plane and element strides; out (2, n)
// challenges, then D' (4,).  One warp.
__global__ void __launch_bounds__(32) fs_sponge_kernel(const u64* __restrict__ D,
                                                       const u64* __restrict__ el, i64 plane,
                                                       i64 stride, int k, int n,
                                                       u64* __restrict__ out) {
    const int lane = threadIdx.x, role = lane & 1;
    u32 d[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) d[w] = half_of(D[w], role);
    for (int i = 0; i < k; i += 2) {
        const u64* e0 = el + i * stride;
        const bool two = i + 1 < k;
        absorb_block(d, e0[0], e0[plane], two ? e0[stride] : 0ull,
                     two ? e0[stride + plane] : 0ull, role);
    }
    for (int i = 0; i < n; ++i) {
        const E r = squeeze(d, lane);
        if (lane == 0) {
            out[i] = r.re;
            out[n + i] = r.im;
        }
    }
    store_state(d, lane, out + 2 * (i64)n);
}

// ---- fs_sumcheck: the plan ----------------------------------------------------

struct SumArgs {
    const u64* v;        // table t's elements at v + off[t], a + off[t], m + off[t]
    const u64* a;        // null: every a is zero (Liu)
    const u64* m;
    i64 pv, pa, pm;      // the arrays' plane strides
    const u64* D;        // the sponge state (4,)
    u64* out;            // polys (mdb, 2, 3) | rs (2, mdb) | bounds (n, 2, 3) | D' (4,)
    u64* store;          // the global route's stores, store_words a block; null: shared memory
    int n, mdb, absorb;
    int J;               // the gathering pass: rounds 0 .. J - 2 on the whole cluster
    int gather;          // bytes block 0's tail takes in pass J
    int store_words, tail_words;
    i64 off[MAX_TABLES];
    int sx[MAX_TABLES], sy[MAX_TABLES];   // a block's store: T_j of odd, even j <= J - 2
    int tx[MAX_TABLES], ty[MAX_TABLES];   // the tail: T_j of j - (J - 1) even, odd
    signed char bl[MAX_TABLES], k[MAX_TABLES];
};

// words of a plane of a buffer for 2^e elements (at least two: 16 bytes)
__host__ __device__ __forceinline__ int cap_of(int e) { return e >= 1 ? 1 << e : 2; }

struct Plan {
    int J, gather, store_words, tail_words;
    int k[MAX_TABLES], sx[MAX_TABLES], sy[MAX_TABLES], tx[MAX_TABLES], ty[MAX_TABLES];
};

// pairs of T_j over every table (an ending table's one element counts one)
i64 units_whole(const int* bls, int n, int j) {
    i64 u = 0;
    for (int t = 0; t < n; ++t) u += bls[t] > j ? (i64)1 << (bls[t] - j - 1) : bls[t] == j;
    return u;
}

// the plan of one call; false: no plan takes it
bool make_plan(const int* bls, int n, int mdb, int C, Plan& P) {
    const int c = __builtin_ctz(C);
    if (C == 1) {
        P.J = 1;
    } else {
        // the cluster while T_J has more pairs than a block has threads
        int J = c + 1 > 2 ? c + 1 : 2;
        if (J > mdb - 1) return false;
        while (J < mdb - 1 && units_whole(bls, n, J) > THREADS) ++J;
        P.J = J;
    }
    const int J = P.J;
    int s = 0, tl = 0;
    i64 gather = 0;
    for (int t = 0; t < n; ++t) {
        const int bl = bls[t];
        // chunks of T_{J-1} of at least four elements (pass J's quads)
        const int k = bl - J - 1 > 0 ? (bl - J - 1 < c ? bl - J - 1 : c) : 0;
        P.k[t] = k;
        P.sx[t] = P.sy[t] = P.tx[t] = P.ty[t] = 0;
        if (J - 2 >= 1 && bl >= 1) P.sx[t] = s, s += 6 * cap_of(bl - 1 - k);
        if (J - 2 >= 2 && bl >= 2) P.sy[t] = s, s += 6 * cap_of(bl - 2 - k);
        if (J >= 2 ? bl >= J - 1 : bl >= 2)
            P.tx[t] = tl, tl += 6 * cap_of(J >= 2 ? bl - J + 1 : bl - 2);
        if (bl >= J) P.ty[t] = tl, tl += 6 * cap_of(bl - J);
        if (J >= 2 && bl >= J - 1) gather += 48 * ((i64)1 << (bl - J + 1));
    }
    P.store_words = s;
    P.tail_words = tl;
    P.gather = (int)gather;
    return true;
}

// a block's shared memory: the head, the workers' and the received parts,
// the tail, the store
i64 plan_smem(const Plan& P, int C, bool smem_store) {
    return 8 * ((i64)HEAD + 2 * WORKERS * QW + RING * (i64)C * QW + P.tail_words
                + (smem_store ? P.store_words : 0));
}

// ---- fs_sumcheck: the cluster's memory ------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ unsigned peer(unsigned addr, int rank) {
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ void bar_init(u64* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive(u64* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(u64* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bar_wait(u64* bar, int parity) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
}

// 8 or 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void put1(unsigned dst, u64 x, unsigned bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                     dst),
                 "l"(x), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void put2(unsigned dst, u64 x, u64 y, unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];" ::"r"(
            dst),
        "l"(x), "l"(y), "r"(bar)
        : "memory");
}

// the worker warps' barrier between passes (named barrier 1)
__device__ __forceinline__ void workers_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * WORKERS) : "memory");
}

// ---- fs_sumcheck: the passes ----------------------------------------------------

using vpt64::add;
using vpt64::sub;

// one copy of the product for the passes (whose code would otherwise not
// stay in the SM's instruction cache beside the sponge's); warp 0's
// evaluation inlines its own
__device__ __noinline__ E mulc(E x, E y) { return vpt64::mul(x, y); }

__device__ __forceinline__ E neg(E x) {
    return {vpt64::lin<vpt64::LIN_NEG>(x.re, 0), vpt64::lin<vpt64::LIN_NEG>(x.im, 0)};
}

// c0 + c1 r, and a quadratic c0 + c1 r + c2 r^2
struct Lin {
    E c0, c1;
};

struct Quad {
    E c0, c1, c2;
};

__device__ __forceinline__ Quad qadd(Quad x, Quad y) {
    return {add(x.c0, y.c0), add(x.c1, y.c1), add(x.c2, y.c2)};
}

// the product of two linear polynomials, three products (Karatsuba)
__device__ __forceinline__ Quad mul_lin(Lin x, Lin y) {
    const E p0 = mulc(x.c0, y.c0), p2 = mulc(x.c1, y.c1);
    const E pm = mulc(add(x.c0, x.c1), add(y.c0, y.c1));
    return {p0, sub(sub(pm, p0), p2), p2};
}

// a part: the quadratics of round j's p0, p1, p2 and a_term sum
struct Part {
    Quad q[4];
};

__device__ __forceinline__ E shfl_e(E x, int o) {
    return {__shfl_xor_sync(FULL, x.re, o), __shfl_xor_sync(FULL, x.im, o)};
}

__device__ __forceinline__ Part warp_sum(Part x) {
#pragma unroll 1
    for (int o = 16; o; o >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            x.q[i] = qadd(x.q[i], Quad{shfl_e(x.q[i].c0, o), shfl_e(x.q[i].c1, o),
                                       shfl_e(x.q[i].c2, o)});
    }
    return x;
}

// a buffer of T_j: 6 planes of cap words, (v, a, m) x (re, im)
struct Buf {
    u64* p;
    int cap;
};

// T_j (j >= 1) of table t in this block
__device__ __forceinline__ Buf buf(const SumArgs& A, u64* store, u64* tail, int t, int j) {
    const int bl = A.bl[t], k = A.k[t], J = A.J;
    if (j <= J - 2)
        return (j & 1) ? Buf{store + A.sx[t], cap_of(bl - 1 - k)}
                       : Buf{store + A.sy[t], cap_of(bl - 2 - k)};
    if ((j - (J - 1)) & 1) return Buf{tail + A.ty[t], cap_of(bl - J)};
    return Buf{tail + A.tx[t], cap_of(J >= 2 ? bl - J + 1 : bl - 2)};
}

// elements of T_j that this block holds of table t
__device__ __forceinline__ int live(const SumArgs& A, int t, int j, int blk) {
    const int bl = A.bl[t];
    if (j > bl) return 0;
    if (j <= A.J - 1) {
        const int k = A.k[t];
        return blk < (1 << k) ? 1 << (bl - j - k) : 0;
    }
    return blk == 0 ? 1 << (bl - j) : 0;
}

// units of pass p of a table whose T_{p-1} (T_0 in pass 0) has L
// elements here: pass 0 a pair (its terms) or the one element (v·m + a);
// pass p >= 1 a quad (its coefficients), a pair (the ending table's
// coefficients) or, from pass 2, the one element (its bind)
__device__ __forceinline__ int units(int L, int p) {
    if (p == 0) return L >= 2 ? L >> 1 : L;
    return L >= 4 ? L >> 2 : (L == 2 || (L == 1 && p >= 2)) ? 1 : 0;
}

// element i of array r of table t's inputs (this block's chunk)
__device__ __forceinline__ E input(const SumArgs& A, int t, int blk, int r, i64 i) {
    const i64 x = A.off[t] + ((i64)blk << (A.bl[t] - A.k[t])) + i;
    if (r == 0) return {A.v[x], A.v[A.pv + x]};
    if (r == 2) return {A.m[x], A.m[A.pm + x]};
    return A.a ? E{A.a[x], A.a[A.pa + x]} : E{0, 0};
}

// array q of table t's T_j in this block: plane 0 at p, plane 1 at p + plane
// (the inputs' chunk for j = 0; a null p: every a is zero)
struct Arr {
    const u64* p;
    i64 plane;
};

__device__ __forceinline__ Arr arr(const SumArgs& A, u64* store, u64* tail, int t, int j, int blk,
                                   int q) {
    if (j == 0) {
        const i64 x = A.off[t] + ((i64)blk << (A.bl[t] - A.k[t]));
        if (q == 0) return {A.v + x, A.pv};
        if (q == 2) return {A.m + x, A.pm};
        return {A.a ? A.a + x : nullptr, A.pa};
    }
    const Buf B = buf(A, store, tail, t, j);
    return {B.p + 2 * q * B.cap, B.cap};
}

__device__ __forceinline__ E at(Arr x, int i) {
    return x.p ? E{x.p[i], x.p[x.plane + i]} : E{0, 0};
}

// element i of array r of T_j (this block's chunk; T_0 the inputs)
__device__ __forceinline__ E elem(const SumArgs& A, u64* store, u64* tail, int t, int j, int blk,
                                  int r, int i) {
    return at(arr(A, store, tail, t, j, blk, r), i);
}

__device__ __forceinline__ E shfl_from(E x, int src, unsigned mask) {
    return {__shfl_sync(mask, x.re, src), __shfl_sync(mask, x.im, src)};
}

__device__ __forceinline__ Lin shfl_from(Lin x, int src, unsigned mask) {
    return {shfl_from(x.c0, src, mask), shfl_from(x.c1, src, mask)};
}

// Pass 0: round 0's terms of T_0's pairs (the c0 of each quadratic) and
// v·m + a of one-element tables, a unit a thread (first, first + stride,
// ...).
__device__ __noinline__ Part pass0(const SumArgs& A, int blk, int first, int stride) {
    Part acc = {};
    const int n = A.n;
    int t = 0, base = 0, L = live(A, 0, 0, blk), U = units(L, 0);
    for (int g = first;; g += stride) {
        while (g >= base + U) {
            base += U;
            if (++t == n) return acc;
            L = live(A, t, 0, blk);
            U = units(L, 0);
        }
        const int u = g - base;
        E x[2][3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const Arr X = arr(A, nullptr, nullptr, t, 0, blk, q);
            x[0][q] = at(X, L >= 2 ? 2 * u : 0);
            x[1][q] = L >= 2 ? at(X, 2 * u + 1) : E{0, 0};
        }
        if (L >= 2) {
            const E dv = sub(x[1][0], x[0][0]), da = sub(x[1][1], x[0][1]);
            const E dm = sub(x[1][2], x[0][2]);
            acc.q[0].c0 = add(acc.q[0].c0, mulc(dm, dv));
            acc.q[1].c0 = add(acc.q[1].c0, add(add(mulc(dm, x[0][0]), mulc(x[0][2], dv)), da));
            acc.q[2].c0 = add(acc.q[2].c0, add(mulc(x[0][2], x[0][0]), x[0][1]));
        } else {
            acc.q[3].c0 = add(acc.q[3].c0, add(mulc(x[0][0], x[0][2]), x[0][1]));
        }
    }
}

// Pass p >= 1, a unit a group of four lanes (g = lane & 3; units first,
// first + stride, ...): lanes 0-2 make array g's elements of T_{p-1} (from
// T_{p-2} bound at r, or the inputs for p = 1) and store them (block 0's
// tail by st.async in pass J); for p < mdb each lane then forms one of the
// four products of round p's coefficients (a quad: p0 = dm·dv on lane 0,
// p1 = dm·v0 + m0·dv + da on lanes 1 and 2, p2 = m0·v0 + a0 on lane 3) or,
// on lane 0, an ending table's v·m + a.  A unit's products are spread over
// its lanes: a pass is as deep as seven products, not twenty-four.
__device__ __noinline__ Part pass(const SumArgs& A, u64* store, u64* tail, unsigned rtail,
                                  unsigned rbar, int p, int blk, E r, int first, int stride) {
    Part acc = {};
    const int n = A.n, jt = p - 1, lane = threadIdx.x & 31, g = lane & 3;
    const unsigned mask = 0xfu << (lane & ~3);
    const bool coefs = p < A.mdb;
    int t = 0, base = 0, L = live(A, 0, jt, blk), U = units(L, p);
    for (int w = first;; w += stride) {
        while (w >= base + U) {
            base += U;
            if (++t == n) return acc;
            L = live(A, t, jt, blk);
            U = units(L, p);
        }
        const int u = w - base, ne = L >= 4 ? 4 : L;
        // array g's elements of T_jt (lanes 0-2)
        E x[4] = {};
        if (g < 3) {
            if (p == 1) {
                const Arr X = arr(A, store, tail, t, 0, blk, g);
#pragma unroll
                for (int h = 0; h < 4; ++h)
                    if (h < ne) x[h] = at(X, ne * u + h);
            } else {
                const Arr S = arr(A, store, tail, t, p - 2, blk, g);
#pragma unroll
                for (int h = 0; h < 4; ++h)
                    if (h < ne) {
                        const E x0 = at(S, 2 * (ne * u + h)), x1 = at(S, 2 * (ne * u + h) + 1);
                        x[h] = add(x0, mulc(sub(x1, x0), r));
                    }
                // block 0's tail at this block's chunk in pass J, else this
                // block's buffer
                const Buf T = buf(A, store, tail, t, jt);
                const bool gather = jt == A.J - 1;
                const int i = (gather ? blk * L : 0) + ne * u;
#pragma unroll
                for (int h2 = 0; h2 < 2; ++h2) {
                    const int w2 = 2 * g + h2;   // plane w2 of the buffer
                    if (gather) {
                        const unsigned d = rtail + 8u * (unsigned)(T.p - tail + w2 * T.cap + i);
                        if (ne == 1)
                            put1(d, h2 ? x[0].im : x[0].re, rbar);
                        else
#pragma unroll
                            for (int h = 0; h < 4; h += 2)
                                if (h < ne)
                                    put2(d + 8 * h, h2 ? x[h].im : x[h].re,
                                         h2 ? x[h + 1].im : x[h + 1].re, rbar);
                    } else {
#pragma unroll
                        for (int h = 0; h < 4; ++h)
                            if (h < ne) T.p[w2 * T.cap + i + h] = h2 ? x[h].im : x[h].re;
                    }
                }
            }
        }
        if (!coefs || ne == 1) continue;
        if (ne == 4) {
            // T_p's pair from this quad at R_{p-1}: y0 = x0 + r (x1 - x0),
            // d = y1 - y0, each linear in r (array g on lane g)
            const E e0 = sub(x[1], x[0]);
            const Lin y0 = {x[0], e0};
            const Lin d = {sub(x[2], x[0]), sub(sub(x[3], x[2]), e0)};
            const int b0 = lane & ~3;
            const Lin dv = shfl_from(d, b0, mask), y0v = shfl_from(y0, b0, mask);
            const Lin da = shfl_from(d, b0 + 1, mask), y0a = shfl_from(y0, b0 + 1, mask);
            const Lin dm = shfl_from(d, b0 + 2, mask), y0m = shfl_from(y0, b0 + 2, mask);
            const Quad prod = mul_lin(g < 2 ? dm : y0m, (g & 1) ? y0v : dv);
            if (g == 0) {
                acc.q[0] = qadd(acc.q[0], prod);
            } else if (g < 3) {
                acc.q[1] = qadd(acc.q[1], g == 1 ? qadd(prod, Quad{da.c0, da.c1, {0, 0}}) : prod);
            } else {
                acc.q[2] = qadd(acc.q[2], qadd(prod, Quad{y0a.c0, y0a.c1, {0, 0}}));
            }
        } else {
            // a table that ends at round p: v·m + a of its pair at R_{p-1}
            const Lin y = {x[0], sub(x[1], x[0])};
            const int b0 = lane & ~3;
            const Lin yv = shfl_from(y, b0, mask), ya = shfl_from(y, b0 + 1, mask);
            const Lin ym = shfl_from(y, b0 + 2, mask);
            if (g == 0)
                acc.q[3] = qadd(acc.q[3], qadd(mul_lin(yv, ym), Quad{ya.c0, ya.c1, {0, 0}}));
        }
    }
}

// ---- fs_sumcheck: the kernel ------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1) fs_sumcheck_kernel(const __grid_constant__ SumArgs A) {
    extern __shared__ __align__(16) u64 smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), blk = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = A.n, mdb = A.mdb, J = A.J;
    u64* qbar = smem;                       // [RING]: the parts' mbarriers, by round mod 4
    u64* qready = smem + 4;                 // [2]: round j's total to warp 0, by parity
    u64* rpub = smem + 6;                   // [2]: R_j to the workers, by parity
    u64* rsh = smem + 8;                    // [2][2]: R_j, by parity
    u64* qtot = smem + 12;                  // [2][QW]: round j's summed coefficients
    u64* bpart = smem + 12 + 2 * QW;        // [QW]: the block's part of a pass
    u64* wpart = smem + HEAD;               // [2][WORKERS][QW]: the worker warps' parts
    u64* parts = wpart + 2 * WORKERS * QW;  // [RING][C][QW]: the blocks' parts
    u64* tail = parts + RING * C * QW;
    u64* store = A.store ? A.store + (i64)blk * A.store_words : tail + A.tail_words;
    // block 0's tail and its mbarrier of pass J, for the gather
    const unsigned rtail = peer(smem_addr(tail), 0);
    const unsigned rbar = peer(smem_addr(qbar + J % RING), 0);

    if (tid == 0) {
        for (int i = 0; i < 8; ++i) bar_init(smem + i);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (C > 1) {
        asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    // the rounds this block runs: every round in block 0, 0 .. J - 2 in
    // the others
    const int rounds = blk == 0 ? mdb : J - 1;
    const int role = lane & 1;
    u32 d[4];   // the sponge state: this lane's halves of D's words
    if (warp == 0) {
        // ---- the rounds --------------------------------------------------
#pragma unroll
        for (int w = 0; w < 4; ++w) d[w] = half_of(A.D[w], role);
        E r = {0, 0}, a_term = {0, 0};
        for (int j = 0; j < rounds; ++j) {
            bar_wait(qready + (j & 1), (j >> 1) & 1);
            // lanes 0-3: p0, p1, p2 and the a_term sum at r = R_{j-1}; lane
            // 4: a_term (1 - r), as the quadratic (a_term, -a_term, 0)
            const u64* q = qtot + (j & 1) * QW + 6 * (lane & 3);
            const bool coef = lane < 4;
            const E c0 = coef ? E{q[0], q[1]} : a_term;
            const E c1 = coef ? E{q[2], q[3]} : neg(a_term);
            const E c2 = coef ? E{q[4], q[5]} : E{0, 0};
            const E val = add(c0, vpt64::mul(add(c1, vpt64::mul(c2, r)), r));
            const E pa = {__shfl_sync(FULL, val.re, 0), __shfl_sync(FULL, val.im, 0)};
            E pb = {__shfl_sync(FULL, val.re, 1), __shfl_sync(FULL, val.im, 1)};
            E pc = {__shfl_sync(FULL, val.re, 2), __shfl_sync(FULL, val.im, 2)};
            const E aw = {__shfl_sync(FULL, val.re, 3), __shfl_sync(FULL, val.im, 3)};
            const E at = {__shfl_sync(FULL, val.re, 4), __shfl_sync(FULL, val.im, 4)};
            a_term = add(at, aw);
            pb = add(pb, neg(a_term));
            pc = add(pc, a_term);
            // absorb (p0, p1), (p2, 0); squeeze R_j
            absorb_block(d, pa.re, pa.im, pb.re, pb.im, role);
            absorb_block(d, pc.re, pc.im, 0ull, 0ull, role);
            r = squeeze(d, lane);
            if (lane == 0) {
                rsh[2 * (j & 1)] = r.re, rsh[2 * (j & 1) + 1] = r.im;
                bar_arrive(rpub + (j & 1));
                if (blk == 0) {
                    u64* pj = A.out + 6 * (i64)j;
                    pj[0] = pa.re, pj[1] = pb.re, pj[2] = pc.re;
                    pj[3] = pa.im, pj[4] = pb.im, pj[5] = pc.im;
                    A.out[6 * (i64)mdb + j] = r.re;
                    A.out[7 * (i64)mdb + j] = r.im;
                }
            }
        }
    } else if (warp == COLLECTOR) {
        // ---- the parts' sums: round k's from every block that sends it ----
        for (int k = 0; k < rounds; ++k) {
            const int slot = k % RING, senders = k <= J ? C : 1;
            if (lane == 0)
                bar_expect(qbar + slot, senders * QW * 8 + (k == J && J >= 2 ? A.gather : 0));
            bar_wait(qbar + slot, (k >> 2) & 1);
            if (lane < QW / 2) {
                E x = {0, 0};
                for (int b = 0; b < senders; ++b) {
                    const u64* p = parts + ((i64)slot * C + b) * QW + 2 * lane;
                    x = add(x, E{p[0], p[1]});
                }
                qtot[(k & 1) * QW + 2 * lane] = x.re;
                qtot[(k & 1) * QW + 2 * lane + 1] = x.im;
            }
            __syncwarp();
            if (lane == 0) bar_arrive(qready + (k & 1));
        }
    } else {
        // ---- the passes: 0 .. mdb + 1 in block 0, 0 .. J in the others ----
        const int wi = warp < COLLECTOR ? warp - 1 : warp - 2, wt = 32 * wi + lane;
        const int last = blk == 0 ? mdb + 1 : J;
        for (int p = 0; p <= last; ++p) {
            E r = {0, 0};
            if (p >= 2) {
                bar_wait(rpub + ((p - 2) & 1), ((p - 2) >> 1) & 1);
                r = {rsh[2 * ((p - 2) & 1)], rsh[2 * ((p - 2) & 1) + 1]};
            }
            if (p == J + 1 && J >= 2) bar_wait(qbar + J % RING, (J >> 2) & 1);   // the gather
            Part x = p == 0 ? pass0(A, blk, wt, 32 * WORKERS)
                            : pass(A, store, tail, rtail, rbar, p, blk, r, wt >> 2,
                                   8 * WORKERS);
            const bool send = p < mdb;
            if (send) {
                x = warp_sum(x);
                if (lane == 0) {
                    u64* w = wpart + ((p & 1) * WORKERS + wi) * QW;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const Quad& y = x.q[i];
                        w[6 * i] = y.c0.re, w[6 * i + 1] = y.c0.im;
                        w[6 * i + 2] = y.c1.re, w[6 * i + 3] = y.c1.im;
                        w[6 * i + 4] = y.c2.re, w[6 * i + 5] = y.c2.im;
                    }
                }
            }
            workers_sync();   // T_{p-1} and the warps' parts to every worker
            if (send && wi == 0) {
                // the block's part into every block of round p (block 0's
                // from round J - 1 on)
                if (lane < QW / 2) {
                    E y = {0, 0};
                    for (int w = 0; w < WORKERS; ++w) {
                        const u64* s = wpart + ((p & 1) * WORKERS + w) * QW + 2 * lane;
                        y = add(y, E{s[0], s[1]});
                    }
                    bpart[2 * lane] = y.re, bpart[2 * lane + 1] = y.im;
                }
                __syncwarp();
                const int ndest = p <= J - 2 ? C : 1, slot = p % RING;
                if (lane < ndest) {
                    const unsigned dst = peer(smem_addr(parts + ((i64)slot * C + blk) * QW), lane);
                    const unsigned bar = peer(smem_addr(qbar + slot), lane);
                    for (int i = 0; i < QW; i += 2) put2(dst + 8 * i, bpart[i], bpart[i + 1], bar);
                }
                __syncwarp();
            }
        }
    }
    if (blk != 0) return;
    __syncthreads();   // every pass and round done: T_mdb in place
    if (warp != 0) return;
    // ---- the bound scalars, the claim's absorb, D' -------------------------
    u64* bounds = A.out + 8 * (i64)mdb;
    for (int x = lane; x < n * 6; x += 32) {
        const int t = x / 6, q = x % 6;
        const E e = elem(A, store, tail, t, A.bl[t], 0, q >> 1, 0);
        bounds[t * 6 + (q & 1) * 3 + (q >> 1)] = (q & 1) ? e.im : e.re;
    }
    if (A.absorb) {
        const E v = elem(A, store, tail, 0, A.bl[0], 0, 0, 0);
        absorb_block(d, v.re, v.im, 0ull, 0ull, role);
    }
    store_state(d, lane, bounds + 6 * (i64)n);
}

}  // namespace

// One launch of one warp: absorb the k elements el (2, k) (plane and
// element strides) into D, then squeeze n challenges: out (2, n), then
// D' (4,).  k = n = 0: nothing to launch.
extern "C" int vpt_fs_sponge(const u64* D, const u64* el, long long plane, long long stride,
                             int k, int n, u64* out, void* stream_ptr) {
    if (k < 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (k == 0 && n == 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    fs_sponge_kernel<<<1, 32, 0, stream>>>(D, el, plane, stride, k, n, out);
    return (int)cudaGetLastError();
}

// The plan of an fs_sumcheck call (a query, no launch): out = J, the
// gathered bytes, a block's store and tail words, the shared memory of
// the shared-memory and of the global route, then the n k_t.  Returns
// cudaErrorInvalidValue when no plan takes the call.
extern "C" int vpt_fs_sumcheck_plan(const int* bls, int n, int mdb, int cluster, long long* out) {
    if (n <= 0 || n > MAX_TABLES || mdb < 0 || mdb > 62 || cluster < 1
        || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
        return (int)cudaErrorInvalidValue;
    for (int t = 0; t < n; ++t)
        if (bls[t] < 0 || bls[t] > mdb) return (int)cudaErrorInvalidValue;
    Plan P;
    if (!make_plan(bls, n, mdb, cluster, P)) return (int)cudaErrorInvalidValue;
    out[0] = P.J, out[1] = P.gather, out[2] = P.store_words, out[3] = P.tail_words;
    out[4] = plan_smem(P, cluster, true);
    out[5] = plan_smem(P, cluster, false);
    for (int t = 0; t < n; ++t) out[6 + t] = P.k[t];
    return 0;
}

// Every round of one FS sumcheck over n tables (host arrays: table t's
// element offset from v, a and m, and its bl), mdb rounds, in one launch
// of a cluster of `cluster` blocks (1 to 16, a power of two).  out:
// mdb * 8 + n * 6 + 4 words.  scratch: null for the shared-memory route,
// else the global route's stores, `cluster` times the plan's store words
// (vpt_fs_sumcheck_plan's: the wrapper routes by shape).
extern "C" int vpt_fs_sumcheck(const u64* v, const u64* a, const u64* m, long long pv,
                               long long pa, long long pm, const long long* offs,
                               const int* bls, int n, int mdb, const u64* D, int absorb,
                               u64* out, u64* scratch, int cluster, void* stream_ptr) {
    if (n <= 0 || n > MAX_TABLES || mdb < 0 || mdb > 62 || cluster < 1
        || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
        return (int)cudaErrorInvalidValue;
    SumArgs A = {v, a, m, pv, pa, pm, D, out, scratch, n, mdb, absorb};
    for (int t = 0; t < n; ++t) {
        if (bls[t] < 0 || bls[t] > mdb) return (int)cudaErrorInvalidValue;
        A.off[t] = offs[t];
        A.bl[t] = (signed char)bls[t];
    }
    Plan P;
    if (!make_plan(bls, n, mdb, cluster, P)) return (int)cudaErrorInvalidValue;
    A.J = P.J, A.gather = P.gather;
    A.store_words = P.store_words, A.tail_words = P.tail_words;
    for (int t = 0; t < n; ++t) {
        A.k[t] = (signed char)P.k[t];
        A.sx[t] = P.sx[t], A.sy[t] = P.sy[t], A.tx[t] = P.tx[t], A.ty[t] = P.ty[t];
    }
    const i64 smem = plan_smem(P, cluster, scratch == nullptr);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    // the attributes once a device, on the eager call before any capture
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[dev]) {
        e = cudaFuncSetAttribute((void*)fs_sumcheck_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute((void*)fs_sumcheck_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        ready[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, fs_sumcheck_kernel, A);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
