// The GKR verifier's two programs on Hopper (sm_90a), one launch each:
// every layer's succinct checks (gkr_verify_fast) and every layer's
// predicate sweep (gkr_verify_slow).
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX verifier
// jits _verify_fast_all (virgo_plus_tpu/gkr/protocol.py:894) and
// _verify_slow_all (:917), which the port ran as one gf_mul or gf_lin
// launch a field op (3,887 a verify of randomize(14, 13)) beside 159 beta
// gf_table and 117 gf_segsum launches.  The plan and the plain twins are
// gkr/vchecks.py's (plan, verify_fast_plain, verify_slow_plain).
//
// What bounds it: latency, not the card's rates.  A verify of randomize(14,
// 13) reads ~8 MB (the sweep's gate arrays: 2.4 us at 3.35 TB/s) and makes
// ~10^6 field products; the walk it replaces paid ~4,000 dependent
// launches.  So the design removes dependences:
// 1. The round "chain" is no chain.  Round j checks p_j(0) + p_j(1)
//    against p_{j-1}(r_{j-1}), and round 0's value is proof data (the
//    upper layer's Liu claim, vres), the end of phase 1, or liu_sum (a few
//    products of claims).  Every round is a thread of its layer's block 0,
//    a block vote ANDs them.
// 2. No beta table in device memory.  A k-bit table is read as a product
//    of parts of at most PART_BITS bits (13 bits: 2^7 and 2^6 entries).
//    Every block builds the parts of its stage in shared memory, all parts
//    at once over the block's threads, each entry a product tree of its
//    bit factors (depth 3).  A gathered entry is one shared load a part
//    and one product between parts.  A table's init (sig, for bsig and
//    each bt) multiplies its first part's entries, so no term and no sum
//    is scaled.
// 3. No walk over segments.  A stage's segments (the Liu sum's own part
//    and one a dad list, up to STAGE_SEGS) are one range of terms, cut
//    over the cluster's threads; a thread finds a term's segment from the
//    stage's segment records, copied into shared memory with their tables'
//    parts.  (One loop a segment, the first design, paid each segment's
//    descriptor and scale loads in every thread: 56.9 us on an H100 at
//    randomize(14, 13), against 32.9 now and a 0.59 us bound.)
// 4. Sums across blocks stay on chip.  A job (a layer, or the output
//    block) is a cluster of up to MAX_CLUSTER blocks; a block's sum goes
//    through warp shuffles and shared memory, and block 0's first warp
//    reads the others' through distributed shared memory after one cluster
//    barrier, then checks and writes mid.
//    Jobs meet at one 64-bit arrival word: each cluster adds 1, and 2^32
//    if its check failed; the last to arrive writes ok and puts the word
//    back to 0 for the next launch on the stream.
//
// Field steps are gf_int64.cuh's, the plain ops' own.  On canonical inputs
// every product and sum is canonical, so sums in any order equal the
// twins'; the steps that read proof words (the rounds, liu_sum, the checks'
// products, a gate's value) run in the twins' order, so they equal the
// twins' on any words.
#include <cooperative_groups.h>

#include "gf_int64.cuh"

namespace cg = cooperative_groups;

namespace {

using vpt64::E;
typedef unsigned long long u64;
typedef long long i64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;             // a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;           // most blocks a job's cluster
constexpr int PART_BITS = 8;             // a beta part's most bits
constexpr int STAGE_WORDS = 12288;       // a stage's most table words
constexpr int STAGE_SEGS = 32;           // a stage's most segments
constexpr unsigned ASSERT_BIT = 0x80000000u;

// gkr/vchecks.py's value references, segment kinds and int32 fields
enum { REF_COL, REF_EVAL, REF_LIU };
enum { SEG_PRE, SEG_DAD, SEG_OUT, SEG_GATE };
enum { J_STAGE0, J_STAGE1, J_ROUND0, J_ROUND1, J_LIU0, J_LIU1, J_MUL, J_EXP, J_EXP_A,
       J_EXP_B, J_MID, J_MID_KIND, J_MID_A, J_MID_B, J_FIELDS };
enum { S_PART0, S_PART1, S_ENTRIES, S_SEG0, S_SEG1, S_TERMS, S_FIELDS };
enum { P_COL, P_W, P_BASE, P_FIRST, P_SCALE, P_FIELDS };
enum { T_COL, T_BITS, T_SMEM, T_SCALE, T_FIELDS };
enum { G_KIND, G_N, G_FIRST, G_OFF, G_TA, G_TB, G_TC, G_ASSERT, G_CU, G_CV, G_FIELDS };
enum { R_ROW, R_COL, R_KIND, R_A, R_B, R_FIELDS };
enum { L_SIG, L_CLAIM, L_FIELDS };

struct VerifyArgs {
    const u64* c0;          // (2, nc): challenges, proof scalars, mids
    i64 nc;
    const u64* polys;       // (rows, 2, 3) round polynomials (fast)
    const int* jobs;
    const int* stages;
    const int* parts;
    const int* tables;
    const int* segs;
    const int* rounds;
    const int* liu;
    const int* idx;         // dad ids (fast)
    const unsigned* gx;     // the gates' x | ASSERT_BIT (slow)
    const int* glv;
    const int* gsl;
    const u64* coef;        // (8, g_total): A, B, C, D re and im
    i64 g_total;
    int n_jobs;
    int n_clusters;
    u64* mids;              // (layers, 2) (fast)
    unsigned char* ok;      // a bool
    u64* ticket;            // the arrival word
};

__device__ __forceinline__ E zero() { return {0ull, 0ull}; }
__device__ __forceinline__ E one() { return {1ull, 0ull}; }
__device__ __forceinline__ bool same(E x, E y) { return x.re == y.re && x.im == y.im; }

__device__ __forceinline__ E col(const VerifyArgs& a, i64 c) { return {a.c0[c], a.c0[a.nc + c]}; }

// p(0) + p(1) = a + b + 2c of row p (sumcheck.quad_at_0_plus_1)
__device__ __forceinline__ E quad01(const u64* p) {
    const E c = {p[2], p[5]};
    return vpt64::add(vpt64::add({p[0], p[3]}, {p[1], p[4]}), vpt64::add(c, c));
}

// ((a x) + b) x + c (polynomial.eval_at)
__device__ __forceinline__ E eval_quad(const u64* p, E x) {
    E acc = {p[0], p[3]};
    acc = vpt64::add(vpt64::mul(acc, x), {p[1], p[4]});
    return vpt64::add(vpt64::mul(acc, x), {p[2], p[5]});
}

__device__ __forceinline__ E resolve(const VerifyArgs& a, int kind, int x, int y, E liu) {
    if (kind == REF_EVAL) return eval_quad(a.polys + 6 * (i64)x, col(a, y));
    if (kind == REF_LIU) return liu;
    return col(a, x);
}

// a beta table as its lookup reads it: its shared-memory word base, its
// parts (0: no table) and the bits of the narrow ones
// (vchecks.part_widths)
struct Tab {
    int base, np, q, wide;
};

__device__ __forceinline__ Tab tab_of(const VerifyArgs& a, int t) {
    if (t < 0) return {0, 0, 0, 0};
    const int k = a.tables[t * T_FIELDS + T_BITS];
    const int np = k <= PART_BITS ? 1 : (k + PART_BITS - 1) / PART_BITS;
    return {a.tables[t * T_FIELDS + T_SMEM], np, k / np, k % np};
}

// a segment of a stage, as the term loop reads it from shared memory
struct Seg {
    int kind, first, end, assert_col, cu_col, cv_col;
    i64 off;
    Tab t[3];
};

// entry g of a table: the product of its parts' entries
__device__ __forceinline__ E beta_at(const u64* sm, const Tab& t, unsigned g) {
    int base = t.base, off = 0;
    E v = zero();
    for (int p = 0; p < t.np; ++p) {
        const int w = t.q + (p < t.wide);
        const unsigned e = (g >> off) & ((1u << w) - 1u);
        const E x = {sm[base + 2 * e], sm[base + 2 * e + 1]};
        v = p ? vpt64::mul(v, x) : x;
        base += 2 << w;
        off += w;
    }
    return v;
}

// every part of a stage into shared memory: entry e of a w-bit part at
// challenge columns col.. is the product over its bits of (r_b if bit b of
// e else 1 - r_b), a product tree of depth log2(PART_BITS), times the
// table's init on its first part
__device__ __forceinline__ void build_stage(const VerifyArgs& a, u64* sm, int p0, int p1,
                                            int entries) {
    int p = p0;
    for (int e = threadIdx.x; e < entries; e += THREADS) {
        while (p + 1 < p1 && a.parts[(p + 1) * P_FIELDS + P_FIRST] <= e) ++p;
        const int* P = a.parts + p * P_FIELDS;
        const int w = P[P_W];
        const unsigned i = (unsigned)(e - P[P_FIRST]);
        E f[PART_BITS];
#pragma unroll
        for (int b = 0; b < PART_BITS; ++b) {
            f[b] = one();
            if (b < w) {
                const E r = col(a, P[P_COL] + b);
                f[b] = (i >> b) & 1u ? r : vpt64::sub(one(), r);
            }
        }
#pragma unroll
        for (int s = 1; s < PART_BITS; s <<= 1)
#pragma unroll
            for (int b = 0; b + s < PART_BITS; b += 2 * s)
                if (b + s < w) f[b] = vpt64::mul(f[b], f[b + s]);
        if (P[P_SCALE] >= 0) f[0] = vpt64::mul(col(a, P[P_SCALE]), f[0]);
        sm[P[P_BASE] + 2 * i] = f[0].re;
        sm[P[P_BASE] + 2 * i + 1] = f[0].im;
    }
}

// term t of a segment
__device__ __forceinline__ E term(const VerifyArgs& a, const u64* sm, const Seg& s, int t) {
    const int kind = s.kind;
    const i64 off = s.off;
    if (kind == SEG_PRE) return vpt64::mul(beta_at(sm, s.t[0], t), beta_at(sm, s.t[1], t));
    if (kind == SEG_DAD)
        return vpt64::mul(beta_at(sm, s.t[0], t), beta_at(sm, s.t[1], (unsigned)a.idx[off + t]));
    if (kind == SEG_OUT) return vpt64::mul(col(a, off + t), beta_at(sm, s.t[0], t));
    // SEG_GATE: bg'(g) bu(x) bv(lv) (A cu + B cv + C cu cv + D), the gate's
    // value in predicate_check's order
    const i64 g = off + t, G = a.g_total;
    const unsigned xw = a.gx[g];
    const E cu = col(a, s.cu_col);
    E w = beta_at(sm, s.t[0], t);
    if (xw & ASSERT_BIT) w = vpt64::mul(w, col(a, s.assert_col));
    w = vpt64::mul(w, beta_at(sm, s.t[1], xw & ~ASSERT_BIT));
    if (s.t[2].np) w = vpt64::mul(w, beta_at(sm, s.t[2], (unsigned)a.glv[g]));
    const E cv = s.cv_col >= 0 ? col(a, s.cv_col + a.gsl[g]) : zero();
    const u64* co = a.coef + g;
    const E A = {co[0], co[G]}, B = {co[2 * G], co[3 * G]};
    const E C = {co[4 * G], co[5 * G]}, D = {co[6 * G], co[7 * G]};
    const E gv = vpt64::add(vpt64::add(vpt64::mul(A, cu), vpt64::mul(B, cv)),
                            vpt64::add(vpt64::mul(C, vpt64::mul(cu, cv)), D));
    return vpt64::mul(w, gv);
}

__device__ __forceinline__ E warp_sum(E v) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
        v = vpt64::add(v, {__shfl_down_sync(FULL, v.re, o), __shfl_down_sync(FULL, v.im, o)});
    return v;
}

template <bool FAST>
__device__ __forceinline__ void verify_body(const VerifyArgs& a) {
    extern __shared__ u64 sm[];
    __shared__ Seg segs[STAGE_SEGS];
    __shared__ u64 red[2 * WARPS];
    __shared__ u64 bsum[2];
    __shared__ u64 liu_s[2];
    __shared__ u64 prods[2 * THREADS];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int job = (int)blockIdx.x / C, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const bool live = job < a.n_jobs;
    const int* J = a.jobs + (i64)(live ? job : 0) * J_FIELDS;

    // 1. this block's share of the job's terms, stage by stage: a stage's
    // segments are one range of terms, strided over the cluster's threads
    E acc = zero();
    if (live) {
        for (int st = J[J_STAGE0]; st < J[J_STAGE1]; ++st) {
            const int* S = a.stages + st * S_FIELDS;
            __syncthreads();   // the last stage's lookups are done
            build_stage(a, sm, S[S_PART0], S[S_PART1], S[S_ENTRIES]);
            const int s0 = S[S_SEG0], ns = S[S_SEG1] - s0;
            if (tid < ns) {
                const int* G = a.segs + (s0 + tid) * G_FIELDS;
                Seg& r = segs[tid];
                r.kind = G[G_KIND];
                r.first = G[G_FIRST];
                r.end = G[G_FIRST] + G[G_N];
                r.off = G[G_OFF];
                r.assert_col = G[G_ASSERT];
                r.cu_col = G[G_CU];
                r.cv_col = G[G_CV];
                for (int k = 0; k < 3; ++k) r.t[k] = tab_of(a, G[G_TA + k]);
            }
            __syncthreads();
            int s = 0;
            for (int t = rank * THREADS + tid; t < S[S_TERMS]; t += C * THREADS) {
                while (t >= segs[s].end) ++s;
                acc = vpt64::add(acc, term(a, sm, segs[s], t - segs[s].first));
            }
        }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
        red[2 * warp] = acc.re;
        red[2 * warp + 1] = acc.im;
    }
    __syncthreads();
    if (warp == 0) {
        E v = lane < WARPS ? E{red[2 * lane], red[2 * lane + 1]} : zero();
        v = warp_sum(v);
        if (lane == 0) {
            bsum[0] = v.re;
            bsum[1] = v.im;
        }
    }

    // 2. block 0 of a layer's fast job: liu_sum, then every round
    int good = 1;
    if (FAST && live && rank == 0) {
        const int l0 = J[J_LIU0], l1 = J[J_LIU1];
        E liu = zero();
        for (int base = l0; base < l1; base += THREADS) {
            if (base + tid < l1) {
                const int* L = a.liu + (base + tid) * L_FIELDS;
                const E p = vpt64::mul(col(a, L[L_SIG]), col(a, L[L_CLAIM]));
                prods[2 * tid] = p.re;
                prods[2 * tid + 1] = p.im;
            }
            __syncthreads();
            if (tid == 0)     // the twin's order: sig_0 claim_u, then + each term
                for (int i = 0; i < THREADS && base + i < l1; ++i) {
                    const E p = {prods[2 * i], prods[2 * i + 1]};
                    liu = base + i == l0 ? p : vpt64::add(liu, p);
                }
            __syncthreads();
        }
        if (tid == 0) {
            liu_s[0] = liu.re;
            liu_s[1] = liu.im;
        }
        __syncthreads();
        const E ls = {liu_s[0], liu_s[1]};
        for (int r = J[J_ROUND0] + tid; r < J[J_ROUND1]; r += THREADS) {
            const int* R = a.rounds + r * R_FIELDS;
            const E s = quad01(a.polys + 6 * (i64)R[R_ROW]);
            good &= same(s, resolve(a, R[R_KIND], R[R_A], R[R_B], ls));
        }
        good = __syncthreads_and(good);
    }

    // 3. block 0: the cluster's sum, the job's check, mid, the arrival
    cluster.sync();
    E sum = zero();
    if (rank == 0 && warp == 0) {
        if (lane < C) {
            const u64* o = cluster.map_shared_rank(bsum, lane);
            sum = {o[0], o[1]};
        }
        sum = warp_sum(sum);
    }
    if (rank == 0 && tid == 0) {
        if (live) {
            const E ls = {liu_s[0], liu_s[1]};
            const E lhs = J[J_MUL] >= 0 ? vpt64::mul(col(a, J[J_MUL]), sum) : sum;
            good &= same(lhs, resolve(a, J[J_EXP], J[J_EXP_A], J[J_EXP_B], ls));
            if (FAST && J[J_MID] >= 0) {
                const E mid = resolve(a, J[J_MID_KIND], J[J_MID_A], J[J_MID_B], ls);
                a.mids[2 * J[J_MID]] = mid.re;
                a.mids[2 * J[J_MID] + 1] = mid.im;
            }
        }
        const u64 old = atomicAdd(a.ticket, 1ull + (good ? 0ull : 1ull << 32));
        if ((old & 0xffffffffull) + 1 == (u64)a.n_clusters) {
            *a.ok = ((old >> 32) + (good ? 0ull : 1ull)) == 0;
            atomicExch(a.ticket, 0ull);
        }
    }
    cluster.sync();   // no block leaves while block 0 may read its bsum
}

__global__ void __launch_bounds__(THREADS, 1)
    gkr_verify_fast_kernel(const __grid_constant__ VerifyArgs a) {
    verify_body<true>(a);
}

__global__ void __launch_bounds__(THREADS, 1)
    gkr_verify_slow_kernel(const __grid_constant__ VerifyArgs a) {
    verify_body<false>(a);
}

template <bool FAST>
int launch(const VerifyArgs& A0, int n_jobs, int cluster, int smem_words, void* stream_ptr) {
    if (n_jobs < 0 || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1))
        || smem_words < 0 || smem_words > STAGE_WORDS)
        return (int)cudaErrorInvalidValue;
    VerifyArgs A = A0;
    A.n_jobs = n_jobs;
    A.n_clusters = n_jobs > 0 ? n_jobs : 1;
    const void* kernel = FAST ? (const void*)gkr_verify_fast_kernel
                              : (const void*)gkr_verify_slow_kernel;
    // the attribute once a device, on the eager call before any capture
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!ready[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 8 * STAGE_WORDS);
        if (e != cudaSuccess) return (int)e;
        ready[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(A.n_clusters * cluster));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)8 * smem_words;
    cfg.stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    e = FAST ? cudaLaunchKernelEx(&cfg, gkr_verify_fast_kernel, A)
             : cudaLaunchKernelEx(&cfg, gkr_verify_slow_kernel, A);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// One launch over n_jobs jobs (gkr/vchecks.py's plan), a cluster of
// `cluster` blocks each (1 to 8, a power of two), smem_words of table
// shared memory a block.  ok: one byte, the AND of every job's check;
// mids (fast): a layer's mid, top down.
#define VPT_VERIFY_ENTRY(NAME, FAST)                                                          \
    extern "C" int NAME(const u64* c0, long long nc, const u64* polys, const int* jobs,      \
                        const int* stages, const int* parts, const int* tables,              \
                        const int* segs, const int* rounds, const int* liu, const int* idx,  \
                        const unsigned* gx, const int* glv, const int* gsl, const u64* coef, \
                        long long g_total, int n_jobs, int cluster, int smem_words,          \
                        u64* mids, unsigned char* ok, u64* ticket, void* stream_ptr) {       \
        const VerifyArgs A = {c0,   nc,  polys, jobs, stages,  parts, tables, segs,          \
                              rounds, liu, idx, gx,  glv,    gsl,   coef,   g_total,         \
                              0,    0,   mids,  ok,   ticket};                               \
        return launch<FAST>(A, n_jobs, cluster, smem_words, stream_ptr);                      \
    }

VPT_VERIFY_ENTRY(vpt_gkr_verify_fast, true)
VPT_VERIFY_ENTRY(vpt_gkr_verify_slow, false)
