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
// gf.reduce_lazy does (the unsigned h mod p).  The two hashes of a squeeze
// need only D, so two lane pairs of the warp run them side by side; only
// the chain of states is serial.  The hash is keccak.cuh's lane-pair
// permutation; the field steps are gf_int64.cuh's, the plain ops' own, so
// every product and sum equals the twin's on any input, and the round
// sums (of canonical terms) in any order.
//
// What bounds it: a chain.  A round's challenge needs its polynomial
// (the sum over every live pair of every table), then three dependent
// Keccak-f (two absorbs, then the squeeze's two hashes side by side), and
// the next round needs the tables bound at that challenge.  So a round
// costs at least three permutations' latency, whatever the card's rates;
// the products (seven a pair: four for the polynomial, three for the bind)
// are what the cluster's SMs share.
//
// fs_sumcheck: one cluster of C blocks (C = 1 to 16, a power of two, the
// wrapper's choice by the first round's pairs).  Tables of 2^bl elements
// (v, a, m; phase 1 and Liu are one table, the joint phase 2 every dad
// table of the layer, each with its own bl) are cut into C contiguous
// chunks.  Binding the pairs (2i, 2i+1) into i keeps chunk b in block b, so
// while a table has at least 2C elements a block sums and binds its own
// chunk (read from the inputs in round 0, then from a global ping-pong
// buffer that only this block touches, which stays in L2).  When a table
// is down to C elements, each block has written its one element into its
// shared memory (pub); after the next barrier every block gathers the C
// elements into a shared-memory copy of its own (the tail) and warp 0 runs
// the table's last log2(C) rounds there, in every block alike.  A table of
// at most C elements is the tail from round 0.  Each round:
// 1. every thread sums its pairs' terms (pa = dm·dv, pb = dm·v0 + m0·dv +
//    da, pc = m0·v0 + a0), a block sum goes to part[round parity];
// 2. one cluster barrier;
// 3. warp 0 of every block reads the C parts through distributed shared
//    memory, adds the tail's pairs and, for the joint phase 2, the a_term
//    chain (times 1 - r of the last round; plus v·m + a of each table
//    exhausted this round; the polynomial gets (0, -a_term, a_term)),
//    absorbs the polynomial as (p0, p1), (p2, 0), squeezes r, binds the
//    tail;
// 4. the block's threads bind their chunks at r.
// Every block runs the sponge itself and gets the same r, so one barrier
// a round is enough; the parts are double-buffered by round parity (a
// block writes part[j & 1] again only after the barrier of round j + 1,
// which every block reaches after reading round j's).  Block 0 writes the
// polynomials, challenges, bound scalars and D' in their final layout, and
// absorbs table 0's bound v after the rounds when asked (the claim
// absorbed after phase 1 and after Liu).
#include <cooperative_groups.h>

#include "gf_int64.cuh"
#include "keccak.cuh"

namespace cg = cooperative_groups;

namespace {

using vpt64::E;
typedef long long i64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;             // fs_sumcheck's block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;          // most blocks a cluster
constexpr int MAX_TABLES = 128;          // most tables a call
constexpr int Q = 6;                     // an element of (v, a, m): 3 arrays x 2 planes
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

// ---- fs_sumcheck ------------------------------------------------------------

struct SumArgs {
    const u64* v;        // table t's elements at v + off[t], a + off[t], m + off[t]
    const u64* a;        // null: every a is zero (Liu)
    const u64* m;
    i64 pv, pa, pm;      // the arrays' plane strides
    const u64* D;        // the sponge state (4,)
    u64* out;            // polys (mdb, 2, 3) | rs (2, mdb) | bounds (n, 2, 3) | D' (4,)
    u64* scratch;        // a table of bl >= log2(C) + 2: 6 * 2^bl words
    int n, mdb, absorb;
    i64 off[MAX_TABLES];
    signed char bl[MAX_TABLES];
};

struct P3 {
    E a, b, c;
};

__device__ __forceinline__ P3 add3(P3 x, P3 y) {
    return {vpt64::add(x.a, y.a), vpt64::add(x.b, y.b), vpt64::add(x.c, y.c)};
}

__device__ __forceinline__ P3 warp_sum(P3 x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        P3 y;
        y.a.re = __shfl_xor_sync(FULL, x.a.re, o);
        y.a.im = __shfl_xor_sync(FULL, x.a.im, o);
        y.b.re = __shfl_xor_sync(FULL, x.b.re, o);
        y.b.im = __shfl_xor_sync(FULL, x.b.im, o);
        y.c.re = __shfl_xor_sync(FULL, x.c.re, o);
        y.c.im = __shfl_xor_sync(FULL, x.c.im, o);
        x = add3(x, y);
    }
    return x;
}

__device__ __forceinline__ void store3(u64* p, P3 x) {
    p[0] = x.a.re, p[1] = x.a.im, p[2] = x.b.re, p[3] = x.b.im, p[4] = x.c.re, p[5] = x.c.im;
}

__device__ __forceinline__ P3 load3(const u64* p) {
    return {{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}};
}

// The round's terms of one pair: x[q] (q = 2 arr + plane) words of
// elements 2i and 2i + 1, as gkr/fs.py's _round makes them
__device__ __forceinline__ P3 terms(E v0, E v1, E a0, E a1, E m0, E m1) {
    using namespace vpt64;
    const E dv = sub(v1, v0), da = sub(a1, a0), dm = sub(m1, m0);
    return {mul(dm, dv), add(add(mul(dm, v0), mul(m0, dv)), da), add(mul(m0, v0), a0)};
}

// x0 + r (x1 - x0), as _bind
__device__ __forceinline__ E bind(E x0, E x1, E r) {
    return vpt64::add(x0, vpt64::mul(vpt64::sub(x1, x0), r));
}

// Table t's three arrays in round j: the inputs in round 0, then buffer
// j & 1 of its scratch (the arrays (2, 2^(bl-1)) side by side)
struct Arr3 {
    const u64* p[3];
    i64 plane[3];
};

__device__ __forceinline__ Arr3 arrays(const SumArgs& A, int t, int j, i64 soff) {
    Arr3 X;
    if (j == 0) {
        X.p[0] = A.v + A.off[t];
        X.p[1] = A.a ? A.a + A.off[t] : nullptr;
        X.p[2] = A.m + A.off[t];
        X.plane[0] = A.pv, X.plane[1] = A.pa, X.plane[2] = A.pm;
    } else {
        const i64 half = (i64)1 << (A.bl[t] - 1);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            X.p[r] = A.scratch + soff + ((j & 1) * 3 + r) * 2 * half;
            X.plane[r] = half;
        }
    }
    return X;
}

__device__ __forceinline__ E elem(const Arr3& X, int r, i64 i) {
    return X.p[r] ? E{X.p[r][i], X.p[r][X.plane[r] + i]} : E{0, 0};
}

__global__ void __launch_bounds__(THREADS, 1) fs_sumcheck_kernel(const __grid_constant__ SumArgs A) {
    extern __shared__ u64 smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), blk = (int)cluster.block_rank();
    const int c = __ffs(C) - 1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, role = lane & 1;
    const int n = A.n, mdb = A.mdb;
    u64* part = smem;                   // [2][Q]: this block's part of the round polynomial
    u64* rsh = part + 2 * Q;            // [2]: the round's challenge
    u64* red = rsh + 2;                 // [WARPS][Q]
    u64* pub = red + WARPS * Q;         // [n][Q]: the element this block hands to the tail
    u64* tail = pub + n * Q;            // [2][n][Q][C]: the tail's copy, by round parity
    auto tl = [&](int par, int t, int q) { return tail + ((i64)(par * n + t) * Q + q) * C; };
    const P3 zero = {{0, 0}, {0, 0}, {0, 0}};

    u32 d[4];                           // warp 0: the sponge state's halves
    E a_term = {0, 0}, r = {0, 0};
    if (warp == 0) {
#pragma unroll
        for (int w = 0; w < 4; ++w) d[w] = half_of(A.D[w], role);
    }
    for (int j = 0;; ++j) {
        if (j) __syncthreads();         // the last round's binds
        // 1. this block's chunks of every table still spread over the cluster
        P3 acc = zero;
        i64 soff = 0;
        for (int t = 0; t < n; ++t) {
            const int bl = A.bl[t];
            if (bl - j > c) {
                const i64 pairs = (i64)1 << (bl - j - 1 - c);
                const Arr3 X = arrays(A, t, j, soff);
                for (i64 p = tid; p < pairs; p += THREADS) {
                    const i64 i = 2 * (blk * pairs + p);
                    acc = add3(acc, terms(elem(X, 0, i), elem(X, 0, i + 1), elem(X, 1, i),
                                          elem(X, 1, i + 1), elem(X, 2, i), elem(X, 2, i + 1)));
                }
            }
            if (bl >= c + 2) soff += (i64)6 << bl;
        }
        acc = warp_sum(acc);
        if (lane == 0) store3(red + warp * Q, acc);
        __syncthreads();
        if (warp == 0) {
            P3 x = lane < WARPS ? load3(red + lane * Q) : zero;
            x = warp_sum(x);
            if (lane == 0) store3(part + (j & 1) * Q, x);
        }
        cluster.sync();

        if (warp == 0) {
            // 2. the tables that enter the tail this round: from every
            // block's pub, or from the inputs (a table of at most C elements)
            for (int t = 0; t < n; ++t) {
                const int bl = A.bl[t];
                u64* dst = tl(j & 1, t, 0);
                if (bl > c && j == bl - c) {
                    for (int x = lane; x < Q * C; x += 32) {
                        const int q = x / C, i = x % C;
                        dst[q * C + i] = cluster.map_shared_rank(pub + t * Q, i)[q];
                    }
                } else if (bl <= c && j == 0) {
                    const int s = 1 << bl;
                    const Arr3 X = arrays(A, t, 0, 0);
                    for (int x = lane; x < Q * s; x += 32) {
                        const int q = x / s, i = x % s;
                        const u64* p = X.p[q >> 1];
                        dst[q * C + i] = p ? p[(q & 1) * X.plane[q >> 1] + i] : 0ull;
                    }
                }
            }
            __syncwarp();
            if (j == mdb) {
                // the bound scalars, the trailing absorb and D'
                if (blk == 0) {
                    u64* bounds = A.out + 8 * (i64)mdb;
                    for (int x = lane; x < n * Q; x += 32) {
                        const int t = x / Q, q = x % Q;
                        bounds[t * Q + (q & 1) * 3 + (q >> 1)] = tl(A.bl[t] & 1, t, q)[0];
                    }
                    if (A.absorb)
                        absorb_block(d, tl(A.bl[0] & 1, 0, 0)[0], tl(A.bl[0] & 1, 0, 1)[0], 0ull,
                                     0ull, role);
                    store_state(d, lane, bounds + n * Q);
                }
            } else {
                // 3. the round polynomial: the blocks' parts, the tail's
                // pairs, the a_term chain
                P3 poly = lane < C ? load3(cluster.map_shared_rank(part + (j & 1) * Q, lane))
                                   : zero;
                for (int t = 0; t < n; ++t) {
                    const int bl = A.bl[t];
                    if (j < bl && bl - j <= c) {
                        const int s = 1 << (bl - j);
                        for (int i = 2 * lane; i < s; i += 64) {
                            E x[Q];
#pragma unroll
                            for (int r2 = 0; r2 < 3; ++r2) {
                                const u64* re = tl(j & 1, t, 2 * r2);
                                const u64* im = tl(j & 1, t, 2 * r2 + 1);
                                x[2 * r2] = {re[i], im[i]};
                                x[2 * r2 + 1] = {re[i + 1], im[i + 1]};
                            }
                            poly = add3(poly, terms(x[0], x[1], x[2], x[3], x[4], x[5]));
                        }
                    }
                }
                poly = warp_sum(poly);
                if (j) a_term = vpt64::mul(a_term, vpt64::sub(E{1, 0}, r));
                for (int t = 0; t < n; ++t) {
                    if (A.bl[t] != j) continue;
                    const E v = {tl(j & 1, t, 0)[0], tl(j & 1, t, 1)[0]};
                    const E a = {tl(j & 1, t, 2)[0], tl(j & 1, t, 3)[0]};
                    const E m = {tl(j & 1, t, 4)[0], tl(j & 1, t, 5)[0]};
                    a_term = vpt64::add(a_term, vpt64::add(vpt64::mul(v, m), a));
                }
                poly.b = vpt64::add(poly.b, E{vpt64::lin<vpt64::LIN_NEG>(a_term.re, 0),
                                              vpt64::lin<vpt64::LIN_NEG>(a_term.im, 0)});
                poly.c = vpt64::add(poly.c, a_term);
                // 4. absorb (p0, p1), (p2, 0); squeeze r
                absorb_block(d, poly.a.re, poly.a.im, poly.b.re, poly.b.im, role);
                absorb_block(d, poly.c.re, poly.c.im, 0ull, 0ull, role);
                r = squeeze(d, lane);
                if (lane == 0) {
                    rsh[0] = r.re, rsh[1] = r.im;
                    if (blk == 0) {
                        u64* pj = A.out + 6 * (i64)j;
                        pj[0] = poly.a.re, pj[1] = poly.b.re, pj[2] = poly.c.re;
                        pj[3] = poly.a.im, pj[4] = poly.b.im, pj[5] = poly.c.im;
                        A.out[6 * (i64)mdb + j] = r.re;
                        A.out[7 * (i64)mdb + j] = r.im;
                    }
                }
                // 5. bind the tail
                for (int t = 0; t < n; ++t) {
                    const int bl = A.bl[t];
                    if (j < bl && bl - j <= c) {
                        const int s = 1 << (bl - j);
                        for (int x = lane; x < 3 * (s / 2); x += 32) {
                            const int r2 = x / (s / 2), i = x % (s / 2);
                            const u64* re = tl(j & 1, t, 2 * r2);
                            const u64* im = tl(j & 1, t, 2 * r2 + 1);
                            const E y = bind(E{re[2 * i], im[2 * i]},
                                             E{re[2 * i + 1], im[2 * i + 1]}, r);
                            tl((j + 1) & 1, t, 2 * r2)[i] = y.re;
                            tl((j + 1) & 1, t, 2 * r2 + 1)[i] = y.im;
                        }
                    }
                }
            }
        }
        if (j == mdb) break;
        __syncthreads();
        // 6. bind this block's chunks at r
        const E rr = {rsh[0], rsh[1]};
        soff = 0;
        for (int t = 0; t < n; ++t) {
            const int bl = A.bl[t];
            if (bl - j > c) {
                const i64 pairs = (i64)1 << (bl - j - 1 - c);
                const Arr3 X = arrays(A, t, j, soff);
                const bool to_pub = bl - j - 1 == c;   // one element a block left
                const i64 half = (i64)1 << (bl - 1);
                u64* dst = A.scratch + soff + ((j + 1) & 1) * 3 * 2 * half;
                for (i64 p = tid; p < pairs; p += THREADS) {
                    const i64 o = blk * pairs + p, i = 2 * o;
#pragma unroll
                    for (int r2 = 0; r2 < 3; ++r2) {
                        const E y = bind(elem(X, r2, i), elem(X, r2, i + 1), rr);
                        if (to_pub) {
                            pub[t * Q + 2 * r2] = y.re;
                            pub[t * Q + 2 * r2 + 1] = y.im;
                        } else {
                            dst[r2 * 2 * half + o] = y.re;
                            dst[r2 * 2 * half + half + o] = y.im;
                        }
                    }
                }
            }
            if (bl >= c + 2) soff += (i64)6 << bl;
        }
    }
    cluster.sync();   // no block leaves while another may read its shared memory
}

__host__ __device__ constexpr i64 sumcheck_smem_words(int n, int cluster) {
    return 2 * Q + 2 + WARPS * Q + (i64)n * Q + 2 * (i64)n * Q * cluster;
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

// Every round of one FS sumcheck over n tables (host arrays: table t's
// element offset from v, a and m, and its bl), mdb rounds, in one launch
// of a cluster of `cluster` blocks (1 to 16, a power of two).  out:
// mdb * 8 + n * 6 + 4 words; scratch: 6 * 2^bl words for each table of
// bl >= log2(cluster) + 2, in table order.
extern "C" int vpt_fs_sumcheck(const u64* v, const u64* a, const u64* m, long long pv,
                               long long pa, long long pm, const long long* offs,
                               const int* bls, int n, int mdb, const u64* D, int absorb,
                               u64* out, u64* scratch, int cluster, void* stream_ptr) {
    if (n <= 0 || n > MAX_TABLES || mdb < 0 || mdb > 62 || cluster < 1
        || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
        return (int)cudaErrorInvalidValue;
    SumArgs A = {v, a, m, pv, pa, pm, D, out, scratch, n, mdb, absorb, {}, {}};
    for (int t = 0; t < n; ++t) {
        if (bls[t] < 0 || bls[t] > mdb) return (int)cudaErrorInvalidValue;
        A.off[t] = offs[t];
        A.bl[t] = (signed char)bls[t];
    }
    const i64 smem = 8 * sumcheck_smem_words(n, cluster);
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
