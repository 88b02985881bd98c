// The GKR verifier's two programs on Hopper (sm_90a), one launch each:
// every layer's succinct checks (gkr_verify_fast) and every layer's
// predicate sweep (gkr_verify_slow).
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX verifier
// jits _verify_fast_all (virgo_plus_tpu/gkr/protocol.py:894) and
// _verify_slow_all (:917).  The plan and the plain twins are
// gkr/vchecks.py's (plan, verify_fast_plain, verify_slow_plain).
//
// What bounds it: on small circuits the chain of dependent steps a launch
// makes (a fixed cost of a few us); on wide ones the products.  A term of
// the fast program is a few GF(p^2) products of beta entries, a gate of
// the slow one ~10 products and 68-76 bytes of gate arrays: at BASELINE
// scenario 4's circuit (randomize(5, 22), 2^24 gates) 30M terms and 16.8M
// gates, tens of microseconds of the card's integer rate at the least.
// The design:
// 1. A layer's terms over the whole card.  The plan cuts each job (a
//    layer, or the output block) into items, runs of whole 32-term groups
//    of one stage, balanced by their products and sized from the card's
//    SM count (vchecks.ITEMS_PER_SM a multiprocessor).  A block is an item.
//    The last item of a job to arrive (a per-job arrival count) adds the
//    job's partial sums, makes its check and counts the job at the launch's
//    arrival word; the last job writes ok.  A job of one item does all of
//    that in its block, with no fence.  No cluster, no grid barrier.
// 2. No beta table in device memory.  A k-bit table is read as a product of
//    parts of at most PART_BITS bits.  An item builds the parts of the
//    tables its segments read in shared memory, in two steps: each part's
//    two halves (at most 16 entries each, a product tree of at most four bit
//    factors), then every entry as one product of a low and a high half.
//    A table's init (sig) scales its first part's low half.  bsig and bliu
//    of a layer's own term range are one table: each part the product of
//    both (bsig_p bliu_p), so that range's term is one lookup.
// 3. Lookups hoisted.  A segment's terms run in 32-term groups, a warp a
//    group, each warp over a run of consecutive groups; a table read at the
//    term's own index (bsig bliu, bt, bout, bg) is its low part times the
//    product of its higher parts, kept a lane until the index's high bits
//    change.  A gathered table (bliu at a dad id, bu, bv) costs np - 1
//    products.
// 4. The rounds, the Liu sum, exp and mid come first in a job's item 0,
//    beside the table build: every round is a thread (its value is proof
//    data, the end of phase 1 or liu_sum), liu_sum one warp, which checks
//    the round that reads it, exp and mid one thread; a failed round is
//    counted with the job.
//
// Field steps.  The verdict must be the twins' on any int64 words, and the
// plain ops are not the field's on words of p or more: a proof whose
// claim is claim + p may be accepted by the twins, one with 2^63 rejected.
// So every step that reads a proof or output word is gf_int64.cuh's, the
// plain op's own, in the twins' order: the rounds, liu_sum, each job's
// check product, exp and mid; the cu cv table; and the terms of the jobs
// whose terms read such words (a "tree" job: a layer of the slow program,
// reading cu and cv, and the output block), each summed in the twins' tree
// (chains.tree_sum_plain: pairs, zero-padded to a power of two).  The plan
// cuts a tree job into items of 2^h aligned terms, so an item is a subtree:
// a warp's groups are a run of subtrees folded by a binary counter, the
// warps' values and the items' partials are folded in pairs.  All other
// steps read canonical words (challenges, beta entries, the circuit's
// coefficients) and are field.cuh's, whose sums of canonical terms in any
// order are the twins'.  A slow job whose cu and cv words are all canonical
// takes that path too (its terms are then canonical); the output block
// always takes the plain one.
#include "field.cuh"
#include "gf_int64.cuh"

namespace {

using vpt::F2;
using vpt64::E;
typedef unsigned long long u64;
typedef long long i64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;             // a block
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;            // resident blocks an SM (launch bounds)
constexpr int PART_BITS = 8;             // a beta part's most bits
constexpr int STAGE_WORDS = 8192;        // a stage's most table words
constexpr int HALF_WORDS = 2048;         // a stage's most half-part words
constexpr int STAGE_SEGS = 32;           // a stage's most segments
constexpr int STAGE_PARTS = 64;          // a stage's most parts
constexpr int GROUP = 32;                // a segment's first term: a multiple
constexpr int TREE_STACK = 32;           // a binary counter's most levels
constexpr unsigned ASSERT_BIT = 0x80000000u;

// gkr/vchecks.py's value references, segment kinds and int32 fields
enum { REF_COL, REF_EVAL, REF_LIU };
enum { SEG_PRE, SEG_DAD, SEG_OUT, SEG_GATE };
enum { J_STAGE0, J_STAGE1, J_ITEM0, J_ITEM1, J_ROUND0, J_ROUND1, J_LIU0, J_LIU1, J_MUL,
       J_EXP, J_EXP_A, J_EXP_B, J_MID, J_MID_KIND, J_MID_A, J_MID_B, J_TREE, J_TREE_K,
       J_FIELDS };
enum { I_JOB, I_STAGE, I_T0, I_T1, I_SEG0, I_SEG1, I_BUILD0, I_BUILD1, I_ENTRIES, I_HALVES,
       I_FIELDS };
enum { B_COL, B_COL2, B_W, B_BASE, B_SCALE, B_FIRST, B_HFIRST, B_FIELDS };
enum { G_KIND, G_N, G_FIRST, G_OFF, G_TA, G_TB, G_TC, G_KA, G_KB, G_KC, G_SA, G_SB, G_SC,
       G_ASSERT, G_CU, G_CV, G_NCV, G_CUV, G_FIELDS };
enum { R_ROW, R_COL, R_KIND, R_A, R_B, R_FIELDS };
enum { L_SIG, L_CLAIM, L_FIELDS };

struct VerifyArgs {
    const u64* c0;          // (2, nc): challenges, proof scalars, mids
    i64 nc;
    const u64* polys;       // (rows, 2, 3) round polynomials (fast)
    const int* jobs;
    const int* items;
    const int* builds;
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
    int table_words;        // the table area's words; the halves follow
    u64* mids;              // (layers, 2) (fast)
    unsigned char* ok;      // a bool
    u64* ticket;            // the launch's arrival word
    u64* counts;            // a job's arrival count (its items, 2^32 a failure)
    u64* exps;              // (jobs, 2) a job's expected value, from its item 0
    u64* partials;          // (items, 2) an item's sum
};

__device__ __forceinline__ E zero() { return {0ull, 0ull}; }
__device__ __forceinline__ bool same(E x, E y) { return x.re == y.re && x.im == y.im; }

__device__ __forceinline__ E col(const VerifyArgs& a, i64 c) { return {a.c0[c], a.c0[a.nc + c]}; }
__device__ __forceinline__ F2 colf(const VerifyArgs& a, i64 c) { return {a.c0[c], a.c0[a.nc + c]}; }

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

// liu_sum = sig_0 claim_u + sum_j sig_j claims_v_j[i - 1] in the twin's
// order, on one warp: lane k's product, folded through shuffles (every
// lane gets it)
__device__ __forceinline__ E liu_sum(const VerifyArgs& a, const int* J, int lane) {
    const int l0 = J[J_LIU0], l1 = J[J_LIU1];
    E liu = zero();
    for (int base = l0; base < l1; base += 32) {
        E p = zero();
        if (base + lane < l1) {
            const int* L = a.liu + (i64)(base + lane) * L_FIELDS;
            p = vpt64::mul(col(a, L[L_SIG]), col(a, L[L_CLAIM]));
        }
        for (int i = 0; i < 32 && base + i < l1; ++i) {
            const E x = {__shfl_sync(FULL, p.re, i), __shfl_sync(FULL, p.im, i)};
            liu = base + i == l0 ? x : vpt64::add(liu, x);
        }
    }
    return liu;
}

__device__ __forceinline__ E resolve(const VerifyArgs& a, int kind, int x, int y, E liu) {
    if (kind == REF_EVAL) return eval_quad(a.polys + 6 * (i64)x, col(a, y));
    if (kind == REF_LIU) return liu;
    return col(a, x);
}

// round r: p_r(0) + p_r(1) against its reference
__device__ __forceinline__ bool round_ok(const VerifyArgs& a, int r, E liu) {
    const int* R = a.rounds + (i64)r * R_FIELDS;
    return same(quad01(a.polys + 6 * (i64)R[R_ROW]), resolve(a, R[R_KIND], R[R_A], R[R_B], liu));
}

// a beta table as a lookup reads it: its shared-memory word base, its
// parts (0: no table), the bits of the narrow ones and of part 0
// (vchecks.part_widths)
struct Tab {
    int base, np, q, wide;
};

__device__ __forceinline__ Tab tab_of(int base, int k) {
    if (k < 0) return {0, 0, 0, 0};
    const int np = k <= PART_BITS ? 1 : (k + PART_BITS - 1) / PART_BITS;
    return {base, np, k / np, k % np};
}

__device__ __forceinline__ F2 ld(const u64* sm, int w) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(sm + w);
    return {v.x, v.y};
}

__device__ __forceinline__ void st(u64* sm, int w, F2 x) {
    *reinterpret_cast<ulonglong2*>(sm + w) = make_ulonglong2(x.re, x.im);
}

// entry g of a table: the product of its parts' entries (np - 1 products)
__device__ __forceinline__ F2 beta_at(const u64* sm, const Tab& t, unsigned g) {
    int base = t.base, off = 0;
    F2 v = {0ull, 0ull};
    for (int p = 0; p < t.np; ++p) {
        const int w = t.q + (p < t.wide);
        const F2 x = ld(sm, base + 2 * ((g >> off) & ((1u << w) - 1u)));
        v = p ? vpt::mul2_split(v, x) : x;
        base += 2 << w;
        off += w;
    }
    return v;
}

// a table read at consecutive indices: part 0 at g, times the product of
// the higher parts, made again only when g's high bits change (a lane's
// cache: key, hi)
struct Seq {
    int key;
    F2 hi;
};

__device__ __forceinline__ F2 beta_seq(const u64* sm, const Tab& t, unsigned g, Seq& c) {
    if (t.np == 1) return ld(sm, t.base + 2 * g);
    const int w0 = t.q + (0 < t.wide);
    const F2 lo = ld(sm, t.base + 2 * (g & ((1u << w0) - 1u)));
    const int key = (int)(g >> w0);
    if (key != c.key) {
        int base = t.base + (2 << w0), off = 0;
        for (int p = 1; p < t.np; ++p) {
            const int w = t.q + (p < t.wide);
            const F2 x = ld(sm, base + 2 * (((unsigned)key >> off) & ((1u << w) - 1u)));
            c.hi = p > 1 ? vpt::mul2_split(c.hi, x) : x;
            base += 2 << w;
            off += w;
        }
        c.key = key;
    }
    return vpt::mul2_split(lo, c.hi);
}

// a segment of an item, as the sweep reads it from shared memory
struct Seg {
    int kind, first, span, n, assert_col, cu_col, cv_col, ncv, cuv;
    i64 off;
    Tab t[3];
};

// a part to build, as the build reads it from shared memory
struct Build {
    int col, col2, w, base, scale, first, hfirst;
};

// the product over bits b < nb of (r_{c + b} if bit b of i else 1 - r_{c + b})
__device__ __forceinline__ F2 bit_product(const VerifyArgs& a, int c, int nb, unsigned i) {
    F2 f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        f[b] = {1ull, 0ull};
        if (b < nb) {
            const F2 r = colf(a, c + b);
            f[b] = (i >> b) & 1u ? r : vpt::sub2({1ull, 0ull}, r);
        }
    }
    if (nb > 1) f[0] = vpt::mul2_split(f[0], f[1]);
    if (nb > 3) f[2] = vpt::mul2_split(f[2], f[3]);
    if (nb > 2) f[0] = vpt::mul2_split(f[0], f[2]);
    return f[0];
}

__device__ __forceinline__ E shfl_xor(E x, int o) {
    return {__shfl_xor_sync(FULL, x.re, o), __shfl_xor_sync(FULL, x.im, o)};
}

__device__ __forceinline__ bool canonical(E x) { return x.re < vpt64::MOD && x.im < vpt64::MOD; }

// the twin's tree of 2^lv lane values (lv <= 5), every lane gets it
__device__ __forceinline__ E lane_tree(E x, int lv) {
    for (int o = 1; o < (1 << lv); o <<= 1) x = vpt64::add(x, shfl_xor(x, o));
    return x;
}

// a binary counter of subtrees in order: push the r-th (from 0) of a run of
// equal subtrees, folding each completed pair; after a run of 2^k pushes
// stk[0] is the run's tree
__device__ __forceinline__ void tree_push(E* stk, int& top, int r, E x) {
    for (int c = r; c & 1; c >>= 1) x = vpt64::add(stk[--top], x);
    stk[top++] = x;
}

__device__ __forceinline__ F2 warp_sum(F2 v) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
        v = vpt::add2(v, {__shfl_down_sync(FULL, v.re, o), __shfl_down_sync(FULL, v.im, o)});
    return v;
}

// a gate coefficient times y: y or 0 without a product for a coefficient
// of 1 or 0 (Add and Mul gates have no other), the same bits on a
// canonical y
__device__ __forceinline__ F2 coef_mul(F2 c, F2 y) {
    if (c.im == 0ull && c.re <= 1ull) return c.re ? y : F2{0ull, 0ull};
    return vpt::mul2_split(c, y);
}

// a gate's bg'(g) bu(x) bv(lv) (challenges only: canonical)
__device__ __forceinline__ F2 gate_beta(const VerifyArgs& a, const u64* sm, const Seg& s, int u,
                                        Seq& ca) {
    const i64 g = s.off + u;
    const unsigned xw = a.gx[g];
    F2 w = beta_seq(sm, s.t[0], u, ca);
    if (xw & ASSERT_BIT) w = vpt::mul2_split(w, colf(a, s.assert_col));
    w = vpt::mul2_split(w, beta_at(sm, s.t[1], xw & ~ASSERT_BIT));
    if (s.t[2].np) w = vpt::mul2_split(w, beta_at(sm, s.t[2], (unsigned)a.glv[g]));
    return w;
}

// term u of a PRE, DAD or GATE segment on canonical words (its lane's
// caches for the table read in order)
__device__ __forceinline__ F2 term(const VerifyArgs& a, const u64* sm, const Seg& s, int u,
                                   Seq& ca) {
    if (s.kind == SEG_PRE) return beta_seq(sm, s.t[0], u, ca);   // bsig bliu
    if (s.kind == SEG_DAD)
        return vpt::mul2_split(beta_at(sm, s.t[1], (unsigned)a.idx[s.off + u]),
                               beta_seq(sm, s.t[0], u, ca));
    // SEG_GATE: bg'(g) bu(x) bv(lv) (A cu + B cv + C cu cv + D), the gate's
    // value in predicate_check's order, cu cv from the item's table
    const i64 g = s.off + u, G = a.g_total;
    const u64* co = a.coef + g;
    const F2 A = {co[0], co[G]}, B = {co[2 * G], co[3 * G]};
    const F2 C = {co[4 * G], co[5 * G]}, D = {co[6 * G], co[7 * G]};
    const int sl = s.cv_col >= 0 ? a.gsl[g] : 0;
    const F2 w = gate_beta(a, sm, s, u, ca);
    const F2 Acu = coef_mul(A, colf(a, s.cu_col));
    // without dads cv = 0: B cv and C cu cv are 0
    const F2 gv = s.cv_col >= 0
        ? vpt::add2(vpt::add2(Acu, coef_mul(B, colf(a, s.cv_col + sl))),
                    vpt::add2(coef_mul(C, ld(sm, s.cuv + 2 * sl)), D))
        : vpt::add2(Acu, D);
    return vpt::mul2_split(w, gv);
}

// term u of an OUT or GATE segment on the plain ops, in the twins' order
// (out[g] beta(g); w gate_val, gate_val = (A cu + B cv) + (C (cu cv) + D)
// with cv = 0 without dads): the twins' bits on any proof and output words
__device__ __forceinline__ E term_exact(const VerifyArgs& a, const u64* sm, const Seg& s, int u,
                                        Seq& ca) {
    if (s.kind == SEG_OUT) {
        const F2 b = beta_seq(sm, s.t[0], u, ca);
        return vpt64::mul(col(a, s.off + u), {b.re, b.im});
    }
    const i64 g = s.off + u, G = a.g_total;
    const u64* co = a.coef + g;
    const E A = {co[0], co[G]}, B = {co[2 * G], co[3 * G]};
    const E C = {co[4 * G], co[5 * G]}, D = {co[6 * G], co[7 * G]};
    const F2 w = gate_beta(a, sm, s, u, ca);
    const E cu = col(a, s.cu_col);
    E cv = zero(), cuv = vpt64::mul(cu, zero());
    if (s.cv_col >= 0) {
        const int sl = a.gsl[g];
        cv = col(a, s.cv_col + sl);
        const F2 t = ld(sm, s.cuv + 2 * sl);
        cuv = {t.re, t.im};
    }
    const E gv = vpt64::add(vpt64::add(vpt64::mul(A, cu), vpt64::mul(B, cv)),
                            vpt64::add(vpt64::mul(C, cuv), D));
    return vpt64::mul({w.re, w.im}, gv);
}

template <bool FAST>
__device__ __forceinline__ void verify_body(const VerifyArgs& a) {
    extern __shared__ __align__(16) u64 sm[];     // tables, then halves
    __shared__ Seg segs[STAGE_SEGS];
    __shared__ Build builds[STAGE_PARTS];
    __shared__ u64 red[2 * WARPS];
    __shared__ u64 exp_s[2];
    __shared__ int bad_s;
    const int item = (int)blockIdx.x, tid = (int)threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    if (a.n_jobs == 0) {     // no layer: nothing to check
        if (tid == 0) *a.ok = 1;
        return;
    }
    const int* I = a.items + (i64)item * I_FIELDS;
    const int job = I[I_JOB];
    const int* J = a.jobs + (i64)job * J_FIELDS;
    const int q = item - J[J_ITEM0], nq = J[J_ITEM1] - J[J_ITEM0];
    const int s0 = I[I_SEG0], ns = I[I_SEG1] - s0;
    const int b0 = I[I_BUILD0], nb = I[I_BUILD1] - b0;
    u64* half = sm + a.table_words;

    // 1. the item's segments and parts into shared memory
    if (tid < ns) {
        const int* G = a.segs + (i64)(s0 + tid) * G_FIELDS;
        Seg& r = segs[tid];
        r.kind = G[G_KIND];
        r.n = G[G_N];
        r.first = G[G_FIRST];
        r.span = (G[G_N] + GROUP - 1) / GROUP * GROUP;
        r.off = G[G_OFF];
        r.assert_col = G[G_ASSERT];
        r.cu_col = G[G_CU];
        r.cv_col = G[G_CV];
        r.ncv = G[G_NCV];
        r.cuv = G[G_CUV];
        for (int k = 0; k < 3; ++k) r.t[k] = tab_of(G[G_SA + k], G[G_KA + k]);
    }
    if (tid < nb) {
        const int* B = a.builds + (i64)(b0 + tid) * B_FIELDS;
        builds[tid] = {B[B_COL], B[B_COL2], B[B_W], B[B_BASE], B[B_SCALE], B[B_FIRST],
                       B[B_HFIRST]};
    }
    if (tid == 0) bad_s = 0;
    // the check's factor, read ahead by the thread that may make the check
    const E mulv = tid == 0 && J[J_MUL] >= 0 ? col(a, J[J_MUL]) : zero();
    __syncthreads();

    // 2. the halves of every part the item reads, and each gate segment's
    // cu cv_s; item 0: the rounds, exp and mid
    for (int h = tid; h < I[I_HALVES]; h += THREADS) {
        int p = 0;
        while (p + 1 < nb && builds[p + 1].hfirst <= h) ++p;
        const Build& B = builds[p];
        const int wl = (B.w + 1) >> 1, i = h - B.hfirst;
        const bool lo = i < (1 << wl);
        const int bit0 = lo ? 0 : wl, nbits = lo ? wl : B.w - wl;
        const unsigned e = (unsigned)(lo ? i : i - (1 << wl));
        F2 v = bit_product(a, B.col + bit0, nbits, e);
        if (B.col2 >= 0) v = vpt::mul2_split(v, bit_product(a, B.col2 + bit0, nbits, e));
        if (lo && B.scale >= 0) v = vpt::mul2_split(colf(a, B.scale), v);
        st(half, 2 * (B.hfirst + i), v);
    }
    for (int s = 0; s < ns; ++s)
        if (segs[s].cuv >= 0)
            for (int k = tid; k < segs[s].ncv; k += THREADS) {
                const E x = vpt64::mul(col(a, segs[s].cu_col), col(a, segs[s].cv_col + k));
                st(sm, segs[s].cuv + 2 * k, {x.re, x.im});
            }
    // a tree job's item takes the plain path on the output block, and on a
    // gate segment whose cu or cv words are not all canonical (one segment)
    const int tree = J[J_TREE];
    int plain = 0;
    if (tree >= 0) {
        const Seg& S = segs[0];
        if (S.kind == SEG_OUT)
            plain = tid == 0;
        else if (tid <= S.ncv)
            plain = !canonical(col(a, tid ? S.cv_col + tid - 1 : S.cu_col));
    }
    int good = 1;
    if (q == 0) {
        // liu_sum on the last warp, which checks what reads it: the Liu
        // chain's first round and, where it has no rounds, exp
        E liu = zero();
        if (FAST && warp == WARPS - 1) {
            liu = liu_sum(a, J, lane);
            for (int r = J[J_ROUND0] + lane; r < J[J_ROUND1]; r += 32)
                if (a.rounds[(i64)r * R_FIELDS + R_KIND] == REF_LIU) good &= round_ok(a, r, liu);
        }
        if (FAST)
            for (int r = J[J_ROUND0] + tid; r < J[J_ROUND1]; r += THREADS)
                if (a.rounds[(i64)r * R_FIELDS + R_KIND] != REF_LIU) good &= round_ok(a, r, liu);
        if (J[J_EXP] == REF_LIU ? tid == (WARPS - 1) * 32 : tid == 32) {
            const E x = resolve(a, J[J_EXP], J[J_EXP_A], J[J_EXP_B], liu);
            exp_s[0] = x.re;
            exp_s[1] = x.im;
            if (nq > 1) {     // for the job's last item
                __stcg(a.exps + 2 * job, x.re);
                __stcg(a.exps + 2 * job + 1, x.im);
                __threadfence();
            }
        }
        if (FAST && tid == 32 && J[J_MID] >= 0) {     // mid reads no liu_sum
            const E mid = resolve(a, J[J_MID_KIND], J[J_MID_A], J[J_MID_B], liu);
            a.mids[2 * J[J_MID]] = mid.re;
            a.mids[2 * J[J_MID] + 1] = mid.im;
        }
    }
    const bool exact = __syncthreads_or(plain) != 0;

    // 3. every entry of those parts: its low half times its high half
    for (int e = tid; e < I[I_ENTRIES]; e += THREADS) {
        int p = 0;
        while (p + 1 < nb && builds[p + 1].first <= e) ++p;
        const Build& B = builds[p];
        const int wl = (B.w + 1) >> 1, i = e - B.first;
        const int hb = 2 * B.hfirst;
        F2 v = ld(half, hb + 2 * (i & ((1 << wl) - 1)));
        if (B.w > wl) v = vpt::mul2_split(v, ld(half, hb + 2 * ((1 << wl) + (i >> wl))));
        st(sm, B.base + 2 * i, v);
    }
    __syncthreads();

    // 4. the sweep: the item's 32-term groups, a run of them a warp; on the
    // plain path the twins' tree of the item's 2^h leaves: 2^(h-5) groups
    // (one for h <= 5) over the warps, a warp's run through a binary counter
    F2 acc = {0ull, 0ull};
    if (exact) {
        const int t0 = I[I_T0], t1 = I[I_T1];
        const int G = tree > 5 ? 1 << (tree - 5) : 1, wu = min(WARPS, G), run = G / wu;
        const Seg& S = segs[0];
        if (warp < wu) {
            E stk[TREE_STACK];
            int top = 0;
            Seq ca = {-1, {0ull, 0ull}};
            for (int r = 0; r < run; ++r) {
                const int base = t0 + (warp * run + r) * GROUP, u = base - S.first + lane;
                E x = zero();
                if (base < t1 && u < S.n) x = term_exact(a, sm, S, u, ca);
                tree_push(stk, top, r, lane_tree(x, min(tree, 5)));
            }
            acc = {stk[0].re, stk[0].im};
        }
    } else {
        const int t0 = I[I_T0];
        const i64 groups = (I[I_T1] - t0) / GROUP;
        const int ga = (int)(warp * groups / WARPS), gb = (int)((warp + 1) * groups / WARPS);
        int s = 0;
        Seq ca = {-1, {0ull, 0ull}};
        for (int gi = ga; gi < gb; ++gi) {
            const int base = t0 + gi * GROUP;
            while (base >= segs[s].first + segs[s].span) {
                ++s;
                ca.key = -1;
            }
            const Seg& S = segs[s];
            const int u = base - S.first + lane;
            if (u < S.n) acc = vpt::add2(acc, term(a, sm, S, u, ca));
        }
    }

    // 5. the block's sum; the job's last item to arrive: the job's sum (a
    // tree job's in the twins' tree over its 2^(K-h) item slots) and check;
    // the last job: ok
    if (!exact) acc = warp_sum(acc);
    if (lane == 0) {
        red[2 * warp] = acc.re;
        red[2 * warp + 1] = acc.im;
    }
    if (!good) bad_s = 1;
    __syncthreads();
    if (warp != 0) return;
    E sum = zero();
    if (exact) {
        const int wu = min(WARPS, tree > 5 ? 1 << (tree - 5) : 1);
        if (lane < wu) sum = {red[2 * lane], red[2 * lane + 1]};
        sum = lane_tree(sum, 31 - __clz(wu));
    } else {
        F2 v = lane < WARPS ? F2{red[2 * lane], red[2 * lane + 1]} : F2{0ull, 0ull};
        v = warp_sum(v);
        sum = {v.re, v.im};
    }
    u64 bad = (u64)bad_s;
    E exp = {exp_s[0], exp_s[1]};
    if (nq > 1) {
        u64 old = 0;
        if (lane == 0) {
            __stcg(a.partials + 2 * item, sum.re);
            __stcg(a.partials + 2 * item + 1, sum.im);
            __threadfence();
            old = atomicAdd(a.counts + job, 1ull + (bad << 32));
        }
        old = __shfl_sync(FULL, old, 0);
        if ((old & 0xffffffffull) + 1 < (u64)nq) return;
        __threadfence();
        bad += old >> 32;
        const u64* part = a.partials + 2 * (i64)J[J_ITEM0];
        if (tree >= 0) {
            // slot k < nq is item k's subtree, the rest zero; lane l folds
            // slots [l per, (l + 1) per) through a binary counter
            const int L = J[J_TREE_K] - tree, lanes = L < 5 ? 1 << L : 32;
            const int per = (1 << L) / lanes;
            E x = zero();
            if (lane < lanes) {
                E stk[TREE_STACK];
                int top = 0;
                for (int r = 0; r < per; ++r) {
                    const int k = lane * per + r;
                    tree_push(stk, top, r,
                              k < nq ? E{__ldcg(part + 2 * k), __ldcg(part + 2 * k + 1)} : zero());
                }
                x = stk[0];
            }
            sum = lane_tree(x, L < 5 ? L : 5);
        } else {
            F2 t = {0ull, 0ull};
            for (int k = lane; k < nq; k += 32)
                t = vpt::add2(t, {__ldcg(part + 2 * k), __ldcg(part + 2 * k + 1)});
            t = warp_sum(t);
            sum = {t.re, t.im};
        }
        if (q != 0) exp = {__ldcg(a.exps + 2 * job), __ldcg(a.exps + 2 * job + 1)};
        if (lane == 0) a.counts[job] = 0ull;
    }
    if (lane != 0) return;
    const E lhs = J[J_MUL] >= 0 ? vpt64::mul(mulv, sum) : sum;
    const bool fail = bad != 0 || !same(lhs, exp);
    const u64 old = atomicAdd(a.ticket, 1ull + (fail ? 1ull << 32 : 0ull));
    if ((old & 0xffffffffull) + 1 == (u64)a.n_jobs) {
        *a.ok = ((old >> 32) + (fail ? 1ull : 0ull)) == 0;
        atomicExch(a.ticket, 0ull);
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gkr_verify_fast_kernel(const __grid_constant__ VerifyArgs a) {
    verify_body<true>(a);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    gkr_verify_slow_kernel(const __grid_constant__ VerifyArgs a) {
    verify_body<false>(a);
}

template <bool FAST>
int launch(const VerifyArgs& A0, int n_jobs, int n_items, int table_words, int half_words,
           void* stream_ptr) {
    if (n_jobs < 0 || n_items < (n_jobs ? n_jobs : 1) || table_words < 0 || table_words > STAGE_WORDS
        || (table_words & 1) || half_words < 0 || half_words > HALF_WORDS)
        return (int)cudaErrorInvalidValue;
    VerifyArgs A = A0;
    A.n_jobs = n_jobs;
    A.table_words = table_words;
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
                                 8 * (STAGE_WORDS + HALF_WORDS));
        if (e != cudaSuccess) return (int)e;
        ready[dev] = true;
    }
    const size_t smem = (size_t)8 * (table_words + half_words);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream_ptr);
    if (FAST)
        gkr_verify_fast_kernel<<<n_items, THREADS, smem, s>>>(A);
    else
        gkr_verify_slow_kernel<<<n_items, THREADS, smem, s>>>(A);
    return (int)cudaGetLastError();
}

}  // namespace

// One launch over the plan's first n_jobs jobs, whose items are the first
// n_items (gkr/vchecks.py's plan), a block an item, with table_words and
// half_words of shared memory.  scratch: the arrival word, then a count, an
// expected value and partial sums (vchecks._scratch), zero counts and
// arrival word at the launch, left zero.  ok: one byte, the AND of every
// job's check; mids (fast): a layer's mid, top down.
#define VPT_VERIFY_ENTRY(NAME, FAST)                                                          \
    extern "C" int NAME(const u64* c0, long long nc, const u64* polys, const int* jobs,      \
                        const int* items, const int* builds, const int* segs,                \
                        const int* rounds, const int* liu, const int* idx,                   \
                        const unsigned* gx, const int* glv,                                  \
                        const int* gsl, const u64* coef, long long g_total, int n_jobs,      \
                        int n_items, int table_words, int half_words, int jobs_cap,          \
                        int items_cap, u64* mids, unsigned char* ok, u64* scratch,           \
                        void* stream_ptr) {                                                  \
        if (n_jobs > jobs_cap || n_items > items_cap) return (int)cudaErrorInvalidValue;     \
        VerifyArgs A = {};                                                                   \
        A.c0 = c0;                                                                           \
        A.nc = nc;                                                                           \
        A.polys = polys;                                                                     \
        A.jobs = jobs;                                                                       \
        A.items = items;                                                                     \
        A.builds = builds;                                                                   \
        A.segs = segs;                                                                       \
        A.rounds = rounds;                                                                   \
        A.liu = liu;                                                                         \
        A.idx = idx;                                                                         \
        A.gx = gx;                                                                           \
        A.glv = glv;                                                                         \
        A.gsl = gsl;                                                                         \
        A.coef = coef;                                                                       \
        A.g_total = g_total;                                                                 \
        A.mids = mids;                                                                       \
        A.ok = ok;                                                                           \
        A.ticket = scratch;                                                                  \
        A.counts = scratch + 1;                                                              \
        A.exps = scratch + 1 + jobs_cap;                                                     \
        A.partials = scratch + 1 + 3 * (long long)jobs_cap;                                  \
        return launch<FAST>(A, n_jobs, n_items, table_words, half_words, stream_ptr);        \
    }

VPT_VERIFY_ENTRY(vpt_gkr_verify_fast, true)
VPT_VERIFY_ENTRY(vpt_gkr_verify_slow, false)
