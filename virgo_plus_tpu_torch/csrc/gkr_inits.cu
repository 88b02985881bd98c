// X1 GKR table inits: every layer's phase-1 and Liu tables (gkr_p1_inits),
// then every phase-2 table (gkr_p2_inits) of the GKR prover, one launch a
// stage, on Hopper (sm_90a).
//
// Replaces the JAX package's stage programs _prove_inits
// (virgo_plus_tpu/gkr/protocol.py:698) and _prove_p2_inits (:784): XLA
// fuses their per-layer gathers (y = values[y_idx], bu[x_idx], the masked
// values[dg]), the gates' GF(p^2) products (gf.mul/gf.add, _scale_beta_
// asserts), the fused gate scatter (apply_scatter_arrays' prefix sum) and
// the table stacks (_stack_jobs) into a few loops inside the staged jit.
// The JAX package has no Pallas kernel here.
//
// What a stage computes (virgo_plus_tpu_torch/gkr/inits.py has the full
// definitions).  Slot s of table t (a layer i for phase 1, a pair (i, li)
// for phase 2) of each of R lead rows sums its terms, the gates that
// scatter to it:
//   phase 1: a = sum bg'(g) (B_g y_g + D_g), m = sum bg'(g) (A_g + C_g y_g),
//            the Liu m' = bsig(s) [s < size(i-1)] + sum of bt_ij(k) terms,
//            and v = values[i-1 block][s], the Liu a = 0;
//   phase 2: addV = sum bg'(g) bu(x_g) (A_g cu + D_g),
//            multV = sum bg'(g) bu(x_g) (B_g + C_g cu), vdad = values[dg(s)]
//            (0 where dg < 0);
// bg'(g) = bg(g), times assert_r on an assert gate; cu the layer's phase-1
// claim of the row.  Both write the stacked round challenges (2, K, bl).
// The challenges and the beta tables are shared by the rows; only the
// values (and cu) vary by row.
//
// Design.  The plan (inits.py, host numpy once per circuit) sorts each
// stage's terms by destination slot and permutes the static data a term
// reads into term order: A-D coefficient words (8 rows of u64), the y or x
// index, the gate word (beta entry | assert bit), and for phase 1 the Liu
// terms' packed beta references.  The kernel regroups each slot's sums by
// field identities that hold exactly, so the row-independent work runs
// once a tile of rows instead of once a row:
//   phase 2: addV = cu S_A + S_D, multV = S_B + cu S_C with
//            S_X = sum bg' bu X over the slot's terms; a row costs two
//            products, the cu word and the vdad gather;
//   phase 1: a = sum (bg' B) y + sum bg' D, m = sum bg' A + sum (bg' C) y,
//            and m' (bsig and the Liu sum) does not depend on the row; a
//            row costs the y gathers and two products a term.
// The grid is (owners, row tiles), the tile slowest (ROW_TILE_P1 and
// ROW_TILE_P2 rows), so the values rows being gathered at any moment are
// a tile or two (1.8 MB a row at randomize(14, 13)), which L2 holds even
// at 64 rows, where the whole buffer (117 MB) does not fit.
//
// Owners.  A cooperative warp takes 32 consecutive slots by index, those
// of at most thread_max terms (the others are the plan's lists: a warp or
// a block each).  It walks the slots' terms 32 at a time, a term a lane:
// the lane finds its term's slot lane by five shuffles over the lanes'
// first terms (owner), takes that slot's table words by shuffle and puts
// its products into shared memory, where each lane sums its own slot's.
// So a slot's terms are loaded in parallel and coalesced, in two
// dependent loads (the gate word, then the beta entry) whatever their
// count, and consecutive lanes write consecutive output words.  Phase 1
// first sums the Liu terms the same way and writes each row's words that
// need no term (v, v, 0, m'), whose stores drain while the terms are
// summed; then it walks the tile in passes of P1_ROWS rows.  The first
// pass makes each term's bg' B and bg' C, kept in shared memory for the
// later passes (the warp's first KEPT chunks of 32 terms), and bg' D and
// bg' A; every pass multiplies the kept products by its rows' y; a short
// last pass takes the remainder rows.  A warp or block summer splits its
// slot's terms lane, lane + step, ..., reduces once a pass with shuffles
// and shared memory, and gives row u of a pass to lane u.  Sums of
// canonical terms stay lazy in u64 and fold by the Mersenne rule every
// LAZY terms.  Every output word is written once, canonical, by a
// streaming store; the outputs are one flat buffer whose views are the
// stacked tables.  Scalars (assert_r, the claims) come from the device
// buffer c0, the beta tables' pointers by value, and the kernel allocates
// nothing: a CUDA graph captures the launch.
//
// What bounds it: bytes, the writes most (12 words a slot and row in
// phase 1, 6 in phase 2).  chip_smoke.py's init_cost counts each gathered
// values word, plan word and beta entry once and each output word once:
// at randomize(14, 13) 26.6 MB (phase 1) and 19.7 MB (phase 2) at one row,
// 778 MB and 493 MB at 64 rows (654 MB and 425 MB of writes), 7.9 / 5.9
// and 232 / 147 us at 3.35 TB/s.  Operations: phase 1 two GF(p^2)
// products a term and row, plus four or five a term and tile; phase 2 two
// a slot and row, plus five or six a term and tile; below the bytes at
// every shape.  What limits it now is latency: each pass waits on its y
// gathers, and the stores drain between the passes' shared-memory
// rounds.  ptxas (sm_90a): gkr_p1_inits 95 registers and 28,096 bytes of
// shared memory a block, gkr_p2_inits 70 and 8,448, no spills; 128-thread
// blocks.  The times on the card are in PERF.md
// (scripts/check_gkr_inits.py, chip_smoke.py).
//
// Why CUDA and not Triton: exact 64-bit products (__umul64hi), the
// per-slot summer classes, and kernels.py's loader and launch counting.
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"

using vpt::F2;
using vpt::u64;

namespace {

typedef long long i64;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 32;        // beta table sizes (inits.MAX_BETA_GROUPS)
constexpr int REF_SHIFT = 40;         // beta reference: group << REF_SHIFT | offset
constexpr int LAZY = 7;               // terms added between two folds
constexpr unsigned ASSERT_BIT = 1u << 31;
constexpr unsigned FULL = 0xffffffffu;
constexpr int P1_ROWS = 2;            // phase 1: rows a pass over the terms
// rows a tile (grid.y), by stage
constexpr int ROW_TILE_P1 = 10;
constexpr int ROW_TILE_P2 = 16;
static_assert(P1_ROWS <= 32 && ROW_TILE_P2 <= 32, "a warp's lanes hold a pass's rows");
// phase 1: the chunks of 32 terms of a warp whose term products a lane
// keeps (in shared memory) from a tile's first pass for the next
constexpr int KEPT = 3;
struct Kept {
    F2 bB, bC;
    int col;
};
// words a term shares with its slot's lane: phase 1 the products of P1_ROWS
// rows' y with bg' B and with bg' C, bg' D, bg' A; phase 2 bg' bu A-D
constexpr int SHARED_P1 = 2 * P1_ROWS + 2;
constexpr int SHARED_P2 = 4;
// a table's record (inits.T_*)
enum { T_SLOT, T_GBASE, T_KN, T_KOFF, T_VOFF, T_SIZE, T_BG, T_B2, T_ASSERT, T_CLAIM,
       TAB_FIELDS };

struct InitArgs {
    const u64* values;          // (2, rows, tv)
    const u64* c0;              // (2, nc0)
    u64* out;
    const u64* beta[MAX_GROUPS];   // beta tables (2, L, 2^bl) by size
    i64 beta_plane[MAX_GROUPS];    // their plane strides L 2^bl
    const i64* tab;             // (tables, TAB_FIELDS)
    const int* slot_tab;        // slot -> table
    const int* starts;          // (slots + 1) term ranges
    const int* liu_starts;      // phase 1: Liu term ranges
    const int* dg;              // phase 2: values column of a slot, -1 padding
    const i64* coef;            // (8, terms)
    const int* idx;             // y (phase 1) or x (phase 2) of a term
    const unsigned* gate;       // gate | ASSERT_BIT
    const i64* liu_ref;         // phase 1: a Liu term's beta reference
    const int* lists;           // the warp, then the block slots
    const int* rs;              // (3, nrs): c0 column, word, plane stride
    i64 rows, tv, nc0, claim_base, terms, nrs, rs_base;
    int slots, thread_max, nw, nb;
    int t_blocks, w_blocks;     // grid sections
};

__device__ __forceinline__ u64 fold(u64 s) {
    const u64 t = (s >> 61) + (s & vpt::P);
    return t >= vpt::P ? t - vpt::P : t;
}

// lazy sums: a canonical value and up to LAZY canonical terms stay below
// 2^64
__device__ __forceinline__ void lazy_add(F2& s, F2 x) {
    s.re += x.re;
    s.im += x.im;
}

__device__ __forceinline__ F2 fold2(F2 s) { return {fold(s.re), fold(s.im)}; }

template <int N>
__device__ __forceinline__ void fold_all(F2 (&x)[N]) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = fold2(x[k]);
}

__device__ __forceinline__ F2 beta_at(const InitArgs& A, i64 ref) {
    const int g = (int)(ref >> REF_SHIFT);
    const i64 off = ref & ((1ll << REF_SHIFT) - 1);
    const u64* b = A.beta[g];
    return {b[off], b[A.beta_plane[g] + off]};
}

__device__ __forceinline__ F2 c0_at(const InitArgs& A, i64 col) {
    return {A.c0[col], A.c0[A.nc0 + col]};
}

__device__ __forceinline__ F2 value_at(const InitArgs& A, i64 row, i64 col) {
    const u64* v = A.values + row * A.tv + col;
    return {v[0], v[A.rows * A.tv]};
}

__device__ __forceinline__ F2 coef_at(const InitArgs& A, int t, int k) {
    return {(u64)A.coef[(2 * k) * A.terms + t], (u64)A.coef[(2 * k + 1) * A.terms + t]};
}

// bg'(g) of a term: its layer's bg entry (bg: the table's reference),
// times assert_r on an assert gate
__device__ __forceinline__ F2 gated(const InitArgs& A, const i64* T, i64 bg, int t) {
    const unsigned w = A.gate[t];
    const F2 b = beta_at(A, bg + (w & ~ASSERT_BIT));
    return (w & ASSERT_BIT) ? vpt::mul2(b, c0_at(A, T[T_ASSERT])) : b;
}

// the sums over the warp, in every lane
__device__ __forceinline__ F2 warp_sum(F2 x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
        x.re = vpt::addp(x.re, __shfl_xor_sync(0xffffffffu, x.re, d));
        x.im = vpt::addp(x.im, __shfl_xor_sync(0xffffffffu, x.im, d));
    }
    return x;
}

// the sums of N canonical elements over the scope (SCOPE 0 a thread, 1 a
// warp, 2 a block), valid in the scope's first 32 lanes (a warp: every
// lane; a block: warp 0)
template <int SCOPE, int N>
__device__ __forceinline__ void reduce(F2 (&x)[N]) {
    if constexpr (SCOPE >= 1) {
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = warp_sum(x[k]);
    }
    if constexpr (SCOPE == 2) {
        __shared__ F2 sh[WARPS][N];
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int k = 0; k < N; ++k) sh[warp][k] = x[k];
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
            for (int k = 0; k < N; ++k) {
                x[k] = warp_sum((threadIdx.x & 31) < WARPS ? sh[threadIdx.x & 31][k]
                                                           : F2{0, 0});
            }
        }
        __syncthreads();
    }
}

// a slot's output words: array a, plane p, row r at
// o + (2 a + p) plane + r kn (kn = K n of its group, plane = rows K n)
struct Out {
    u64* o;
    i64 kn, plane;
};

__device__ __forceinline__ Out out_of(const InitArgs& A, const i64* T, int words, i64 s) {
    const i64 kn = T[T_KN];
    return {A.out + 2 * words * A.rows * T[T_GBASE] + T[T_KOFF] + s, kn, A.rows * kn};
}

// streaming stores: the outputs are read by later kernels only, so they
// need not displace the values, plan and beta words in L2
__device__ __forceinline__ void put(const Out& O, int arr, i64 row, F2 v) {
    u64* o = O.o + 2 * arr * O.plane + row * O.kn;
    __stcs(o, v.re);
    __stcs(o + O.plane, v.im);
}

// phase 1, a listed slot q summed by a warp or a block (SCOPE 1, 2), rows
// r0 .. r0 + nr - 1 in passes of P1_ROWS, as p1_warp: the scope's lanes
// take terms lane, lane + step, ..., reduce the sums, and row p0 + u of a
// pass goes to lane u
template <int SCOPE>
__device__ void p1_slot(const InitArgs& A, int q, i64 r0, int nr, int lane, int step) {
    constexpr int U = P1_ROWS;
    const i64* T = A.tab + (i64)A.slot_tab[q] * TAB_FIELDS;
    const i64 s = q - T[T_SLOT], bg = T[T_BG];
    F2 ca = {0, 0}, cm = {0, 0}, ml = {0, 0};
    for (int p0 = 0; p0 < nr; p0 += U) {
        const bool first = p0 == 0;
        // as p1_warp's x, then the Liu sum
        F2 x[SHARED_P1 + 1] = {};
        int k = 0;
        for (int t = A.starts[q] + lane; t < A.starts[q + 1]; t += step) {
            const F2 b = gated(A, T, bg, t);
            const F2 bB = vpt::mul2(b, coef_at(A, t, 1)), bC = vpt::mul2(b, coef_at(A, t, 2));
            const int col = A.idx[t];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (p0 + u < nr) {
                    const F2 y = value_at(A, r0 + p0 + u, col);
                    lazy_add(x[u], vpt::mul2(bB, y));
                    lazy_add(x[U + u], vpt::mul2(bC, y));
                }
            }
            if (first) {
                lazy_add(x[2 * U], vpt::mul2(b, coef_at(A, t, 3)));
                lazy_add(x[2 * U + 1], vpt::mul2(b, coef_at(A, t, 0)));
            }
            if (++k == LAZY) {
                fold_all(x);
                k = 0;
            }
        }
        fold_all(x);
        if (first) {
            k = 0;
            for (int t = A.liu_starts[q] + lane; t < A.liu_starts[q + 1]; t += step) {
                lazy_add(x[SHARED_P1], beta_at(A, A.liu_ref[t]));
                if (++k == LAZY) {
                    x[SHARED_P1] = fold2(x[SHARED_P1]);
                    k = 0;
                }
            }
            x[SHARED_P1] = fold2(x[SHARED_P1]);
        }
        reduce<SCOPE>(x);
        if (first) {
            ca = x[2 * U];
            cm = x[2 * U + 1];
            ml = vpt::add2(s < T[T_SIZE] ? beta_at(A, T[T_B2] + s) : F2{0, 0}, x[SHARED_P1]);
        }
        if (lane < U && p0 + lane < nr) {
            const i64 row = r0 + p0 + lane;
            const Out O = out_of(A, T, 6, s);
            const F2 v = value_at(A, row, T[T_VOFF] + s);
            // lane u holds row p0 + u: pick its sums
            F2 a = x[0], m = x[U];
#pragma unroll
            for (int u = 1; u < U; ++u) {
                if (lane == u) {
                    a = x[u];
                    m = x[U + u];
                }
            }
            put(O, 0, row, v);
            put(O, 1, row, vpt::add2(a, ca));
            put(O, 2, row, vpt::add2(cm, m));
            put(O, 3, row, v);
            put(O, 4, row, F2{0, 0});
            put(O, 5, row, ml);
        }
    }
}

// phase 2: slot q's rows r0 + lane, r0 + lane + step, ... below r0 + nr,
// from its sums x = S_A .. S_D: the claim, two products, vdad
__device__ __forceinline__ void p2_rows(const InitArgs& A, const i64* T, int q, i64 r0, int nr,
                                        int lane, int step, const F2 (&x)[SHARED_P2]) {
    const i64 s = q - T[T_SLOT];
    const Out O = out_of(A, T, 3, s);
    const i64 claim = A.claim_base + T[T_CLAIM] * A.rows + r0;
    const int d = A.dg[q];
#pragma unroll 4
    for (int r = lane; r < nr; r += step) {
        const F2 cu = c0_at(A, claim + r);
        const i64 row = r0 + r;
        put(O, 0, row, d >= 0 ? value_at(A, row, d) : F2{0, 0});
        put(O, 1, row, vpt::add2(vpt::mul2(x[0], cu), x[3]));
        put(O, 2, row, vpt::add2(x[1], vpt::mul2(x[2], cu)));
    }
}

// phase 2, a listed slot q summed by a warp or a block, rows r0 .. r0 +
// nr - 1: the scope's S_A-S_D, then row r0 + r to lane r
template <int SCOPE>
__device__ void p2_slot(const InitArgs& A, int q, i64 r0, int nr, int lane, int step) {
    const i64* T = A.tab + (i64)A.slot_tab[q] * TAB_FIELDS;
    const i64 bg = T[T_BG], bu = T[T_B2];
    F2 x[SHARED_P2] = {};
    int k = 0;
    for (int t = A.starts[q] + lane; t < A.starts[q + 1]; t += step) {
        const F2 tmp = vpt::mul2(gated(A, T, bg, t), beta_at(A, bu + A.idx[t]));
#pragma unroll
        for (int j = 0; j < 4; ++j) lazy_add(x[j], vpt::mul2(tmp, coef_at(A, t, j)));
        if (++k == LAZY) {
            fold_all(x);
            k = 0;
        }
    }
    fold_all(x);
    reduce<SCOPE>(x);
    if (lane < 32) p2_rows(A, T, q, r0, nr, lane, 32, x);
}

// a thread slot: at most thread_max terms (and Liu terms)
__device__ __forceinline__ bool thread_slot(const InitArgs& A, int q, bool liu) {
    int n = A.starts[q + 1] - A.starts[q];
    if (liu) n = max(n, A.liu_starts[q + 1] - A.liu_starts[q]);
    return n <= A.thread_max;
}

// the lane (0-31) whose term range [s0, next lane's s0) holds term t, for
// each lane's s0 nondecreasing and the first lane's s0 <= t
__device__ __forceinline__ int owner(int s0, int t) {
    int k = 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        if (__shfl_sync(FULL, s0, k + d) <= t) k += d;
    return k;
}

// a lane of a cooperative warp: slot q0 + lane, summed here when it is a
// thread slot (`own`), with its term range; lanes past the last slot are
// empty
struct Lane {
    int lane, q;
    bool live, own;
    int s0, s1;
    const i64* T;
};

__device__ __forceinline__ Lane lane_of(const InitArgs& A, int q0, bool liu) {
    Lane L;
    L.lane = threadIdx.x & 31;
    L.q = q0 + L.lane;
    L.live = L.q < A.slots;
    const int qe = L.live ? L.q : A.slots;
    L.s0 = A.starts[qe];
    L.s1 = L.live ? A.starts[qe + 1] : L.s0;
    L.own = L.live && thread_slot(A, L.q, liu);
    L.T = A.tab + (i64)A.slot_tab[L.live ? L.q : q0] * TAB_FIELDS;
    return L;
}

// lane o's table record, in every lane
__device__ __forceinline__ const i64* owner_tab(const Lane& L, int o) {
    return reinterpret_cast<const i64*>(
        __shfl_sync(FULL, reinterpret_cast<long long>(L.T), o));
}

// lane L adds the N words of each of its terms among chunk c's 32 (held
// at their places in sh) to x, lazily (k: terms since the last fold)
template <int N>
__device__ __forceinline__ void take(const Lane& L, int c, F2 (*sh)[32], F2 (&x)[N], int& k) {
    if (!L.own) return;
    const int hi = min(L.s1, c + 32) - c;
    for (int p = max(L.s0, c) - c; p < hi; ++p) {
#pragma unroll
        for (int j = 0; j < N; ++j) lazy_add(x[j], sh[j][p]);
        if (++k == LAZY) {
            fold_all(x);
            k = 0;
        }
    }
}

// phase 1, a cooperative warp: slots q0 .. q0 + 31, rows r0 .. r0 + nr -
// 1.  First the Liu terms, 32 at a time, a term a lane (its beta entry
// into sh), each lane summing its own slot's out of sh; then each lane
// writes the words of its slot that need no term of a row (v, 0, m') on
// every row, so those stores drain while the terms are summed.  Then
// passes of P1_ROWS rows walk the slots' terms likewise: bg' from the
// owner lane's table and its products with B and C (made in the first
// pass, with those with D and A, and kept for the warp's first KEPT
// chunks), times each row's y, into sh; each lane sums its slot's and
// writes a and m of the pass's rows.
__device__ void p1_warp(const InitArgs& A, int q0, i64 r0, int nr, F2 (*sh)[32],
                        Kept (*kept)[32]) {
    constexpr int U = P1_ROWS;
    const Lane L = lane_of(A, q0, true);
    const int l0 = A.liu_starts[L.live ? L.q : A.slots];
    const Lane M = {L.lane, L.q, L.live, L.own, l0, L.live ? A.liu_starts[L.q + 1] : l0, L.T};
    const int m0 = __shfl_sync(FULL, M.s0, 0), m1 = __shfl_sync(FULL, M.s1, 31);
    F2 liu[1] = {};
    int k = 0;
    for (int c = m0; c < m1; c += 32) {
        const int t = c + L.lane, o = owner(M.s0, t);
        if (__shfl_sync(FULL, (int)L.own, o) && t < m1) sh[0][L.lane] = beta_at(A, A.liu_ref[t]);
        __syncwarp();
        take(M, c, sh, liu, k);
        __syncwarp();
    }
    const i64* T = L.T;
    const i64 s = L.q - T[T_SLOT];
    const Out O = out_of(A, T, 6, s);
    if (L.own) {
        const F2 ml = vpt::add2(s < T[T_SIZE] ? beta_at(A, T[T_B2] + s) : F2{0, 0}, fold2(liu[0]));
        const i64 vcol = T[T_VOFF] + s;
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
            const F2 v = value_at(A, r0 + r, vcol);
            put(O, 0, r0 + r, v);
            put(O, 3, r0 + r, v);
            put(O, 4, r0 + r, F2{0, 0});
            put(O, 5, r0 + r, ml);
        }
    }
    const int c0 = __shfl_sync(FULL, L.s0, 0), c1 = __shfl_sync(FULL, L.s1, 31);
    F2 ca = {0, 0}, cm = {0, 0};   // sum bg' D, sum bg' A
    for (int p0 = 0; p0 < nr; p0 += U) {
        const bool first = p0 == 0;
        F2 x[SHARED_P1] = {};
        k = 0;
        for (int c = c0, ci = 0; c < c1; c += 32, ++ci) {
            // the lane's term: bg' B, bg' C and its y column (-1: none),
            // made in the first pass and kept in kept[ci] for the next
            F2 bB = {0, 0}, bC = {0, 0};
            int col = -1;
            if (first || ci >= KEPT) {
                const int t = c + L.lane, o = owner(L.s0, t);
                const bool use = __shfl_sync(FULL, (int)L.own, o) && t < c1;
                const i64* oT = owner_tab(L, o);
                if (use) {
                    const F2 b = gated(A, oT, oT[T_BG], t);
                    bB = vpt::mul2(b, coef_at(A, t, 1));
                    bC = vpt::mul2(b, coef_at(A, t, 2));
                    col = A.idx[t];
                    if (first) {
                        sh[2 * U][L.lane] = vpt::mul2(b, coef_at(A, t, 3));
                        sh[2 * U + 1][L.lane] = vpt::mul2(b, coef_at(A, t, 0));
                    }
                }
                if (first && ci < KEPT) kept[ci][L.lane] = {bB, bC, col};
            } else {
                const Kept& kp = kept[ci][L.lane];
                bB = kp.bB;
                bC = kp.bC;
                col = kp.col;
            }
            if (col >= 0) {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    if (p0 + u < nr) {
                        const F2 y = value_at(A, r0 + p0 + u, col);
                        sh[u][L.lane] = vpt::mul2(bB, y);
                        sh[U + u][L.lane] = vpt::mul2(bC, y);
                    }
                }
            }
            __syncwarp();
            take(L, c, sh, x, k);
            __syncwarp();
        }
        fold_all(x);
        if (first) {
            ca = x[2 * U];
            cm = x[2 * U + 1];
        }
        if (L.own) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (p0 + u < nr) {
                    put(O, 1, r0 + p0 + u, vpt::add2(x[u], ca));
                    put(O, 2, r0 + p0 + u, vpt::add2(cm, x[U + u]));
                }
            }
        }
    }
}

// phase 2, a cooperative warp, as p1_warp: a term's bg' bu times A-D into
// sh, each lane's S_A-S_D, then its slot's rows
__device__ void p2_warp(const InitArgs& A, int q0, i64 r0, int nr, F2 (*sh)[32]) {
    const Lane L = lane_of(A, q0, false);
    const int c0 = __shfl_sync(FULL, L.s0, 0), c1 = __shfl_sync(FULL, L.s1, 31);
    F2 x[SHARED_P2] = {};
    int k = 0;
    for (int c = c0; c < c1; c += 32) {
        const int t = c + L.lane, o = owner(L.s0, t);
        const bool use = __shfl_sync(FULL, (int)L.own, o) && t < c1;
        const i64* oT = owner_tab(L, o);
        if (use) {
            const F2 tmp = vpt::mul2(gated(A, oT, oT[T_BG], t), beta_at(A, oT[T_B2] + A.idx[t]));
#pragma unroll
            for (int j = 0; j < 4; ++j) sh[j][L.lane] = vpt::mul2(tmp, coef_at(A, t, j));
        }
        __syncwarp();
        take(L, c, sh, x, k);
        __syncwarp();
    }
    if (!L.own) return;
    fold_all(x);
    p2_rows(A, L.T, L.q, r0, nr, 0, 1, x);
}

template <int STAGE, int SCOPE>
__device__ __forceinline__ void slot(const InitArgs& A, int q, i64 r0, int nr, int lane,
                                     int step) {
    if constexpr (STAGE == 1) p1_slot<SCOPE>(A, q, r0, nr, lane, step);
    else p2_slot<SCOPE>(A, q, r0, nr, lane, step);
}

// the grid: (owners, row tiles), the tile slowest.  Owners: t_blocks of
// cooperative warps, 32 slots each by index (those of a warp or a block
// summer skipped; tile 0's first nrs threads also copy the stacked
// challenges), w_blocks of a warp a listed slot, then a block a listed
// slot
template <int STAGE>
__device__ __forceinline__ void run(const InitArgs& A) {
    constexpr int TILE = STAGE == 1 ? ROW_TILE_P1 : ROW_TILE_P2;
    constexpr int NSH = STAGE == 1 ? SHARED_P1 : SHARED_P2;
    __shared__ F2 sh[WARPS][NSH][32];
    __shared__ Kept kept[WARPS][KEPT][32];
    const i64 r0 = (i64)blockIdx.y * TILE;
    const int nr = (int)min((i64)TILE, A.rows - r0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if ((int)blockIdx.x < A.t_blocks) {
        const i64 it = (i64)blockIdx.x * THREADS + threadIdx.x;
        if (blockIdx.y == 0 && it < A.nrs) {
            const int src = A.rs[it], dst = A.rs[A.nrs + it], stride = A.rs[2 * A.nrs + it];
            A.out[A.rs_base + dst] = A.c0[src];
            A.out[A.rs_base + dst + stride] = A.c0[A.nc0 + src];
        }
        const int q0 = (int)(it - lane);
        if (nr > 0 && q0 < A.slots) {
            if constexpr (STAGE == 1) p1_warp(A, q0, r0, nr, sh[warp], kept[warp]);
            else p2_warp(A, q0, r0, nr, sh[warp]);
        }
    } else if ((int)blockIdx.x < A.t_blocks + A.w_blocks) {
        const int w = (blockIdx.x - A.t_blocks) * WARPS + warp;
        if (nr > 0 && w < A.nw) slot<STAGE, 1>(A, A.lists[w], r0, nr, lane, 32);
    } else if (nr > 0) {
        const int b = blockIdx.x - A.t_blocks - A.w_blocks;
        slot<STAGE, 2>(A, A.lists[A.nw + b], r0, nr, threadIdx.x, THREADS);
    }
}

__global__ void __launch_bounds__(THREADS) gkr_p1_inits_kernel(InitArgs A) { run<1>(A); }

__global__ void __launch_bounds__(THREADS) gkr_p2_inits_kernel(InitArgs A) { run<2>(A); }

int launch(int stage, const u64* values, long long rows, long long tv, const u64* c0,
           long long nc0, long long claim_base, int n_beta, const void* const* beta,
           const long long* beta_plane, const i64* tab, const int* slot_tab, const int* starts,
           const int* liu_starts, const int* dg, const i64* coef, long long terms,
           const int* idx, const int* gate, const i64* liu_ref, const int* lists, int slots,
           int thread_max, int nw, int nb, const int* rs, long long nrs, u64* out,
           long long rs_base, void* stream_ptr) {
    if (n_beta < 0 || n_beta > MAX_GROUPS || rows < 0 || slots < 0 || nw < 0 || nb < 0
        || nrs < 0)
        return (int)cudaErrorInvalidValue;
    InitArgs A = {};
    A.values = values;
    A.c0 = c0;
    A.out = out;
    for (int g = 0; g < n_beta; ++g) {
        A.beta[g] = static_cast<const u64*>(beta[g]);
        A.beta_plane[g] = beta_plane[g];
    }
    A.tab = tab;
    A.slot_tab = slot_tab;
    A.starts = starts;
    A.liu_starts = liu_starts;
    A.dg = dg;
    A.coef = coef;
    A.idx = idx;
    A.gate = reinterpret_cast<const unsigned*>(gate);
    A.liu_ref = liu_ref;
    A.lists = lists;
    A.rs = rs;
    A.rows = rows;
    A.tv = tv;
    A.nc0 = nc0;
    A.claim_base = claim_base;
    A.terms = terms;
    A.nrs = nrs;
    A.rs_base = rs_base;
    A.slots = slots;
    A.thread_max = thread_max;
    A.nw = nw;
    A.nb = nb;
    const long long tile = stage == 1 ? ROW_TILE_P1 : ROW_TILE_P2;
    const long long tiles = rows > 0 ? (rows + tile - 1) / tile : 1;
    const long long items = slots > nrs ? slots : nrs;
    const long long t_blocks = (items + THREADS - 1) / THREADS;
    const long long w_blocks = ((long long)nw + WARPS - 1) / WARPS;
    const long long blocks = t_blocks + w_blocks + nb;
    if (blocks >= (1ll << 31) || tiles > 65535) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    A.t_blocks = (int)t_blocks;
    A.w_blocks = (int)w_blocks;
    const dim3 grid((unsigned)blocks, (unsigned)tiles);
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    if (stage == 1)
        gkr_p1_inits_kernel<<<grid, THREADS, 0, stream>>>(A);
    else
        gkr_p2_inits_kernel<<<grid, THREADS, 0, stream>>>(A);
    return (int)cudaGetLastError();
}

}  // namespace

// out: the stage's flat buffer (inits.p1_views / p2_views cut it) for
// values (2, rows, tv), c0 (2, nc0) (phase 2: the claims from claim_base
// on, rows a layer), n_beta beta tables (host arrays of their device
// pointers and plane strides) and the plan's tensors (inits.InitPlan);
// slots in all, those of at most thread_max terms summed by a thread, nw
// and nb listed slots by a warp and a block; nrs stacked challenge pairs
// written at rs_base.  One launch.
extern "C" int vpt_gkr_p1_inits(const u64* values, long long rows, long long tv, const u64* c0,
                                long long nc0, long long claim_base, int n_beta,
                                const void* const* beta, const long long* beta_plane,
                                const i64* tab, const int* slot_tab, const int* starts,
                                const int* liu_starts, const int* dg, const i64* coef,
                                long long terms, const int* idx, const int* gate,
                                const i64* liu_ref, const int* lists, int slots, int thread_max,
                                int nw, int nb, const int* rs, long long nrs, u64* out,
                                long long rs_base, void* stream_ptr) {
    return launch(1, values, rows, tv, c0, nc0, claim_base, n_beta, beta, beta_plane, tab,
                  slot_tab, starts, liu_starts, dg, coef, terms, idx, gate, liu_ref, lists,
                  slots, thread_max, nw, nb, rs, nrs, out, rs_base, stream_ptr);
}

extern "C" int vpt_gkr_p2_inits(const u64* values, long long rows, long long tv, const u64* c0,
                                long long nc0, long long claim_base, int n_beta,
                                const void* const* beta, const long long* beta_plane,
                                const i64* tab, const int* slot_tab, const int* starts,
                                const int* liu_starts, const int* dg, const i64* coef,
                                long long terms, const int* idx, const int* gate,
                                const i64* liu_ref, const int* lists, int slots, int thread_max,
                                int nw, int nb, const int* rs, long long nrs, u64* out,
                                long long rs_base, void* stream_ptr) {
    return launch(2, values, rows, tv, c0, nc0, claim_base, n_beta, beta, beta_plane, tab,
                  slot_tab, starts, liu_starts, dg, coef, terms, idx, gate, liu_ref, lists,
                  slots, thread_max, nw, nb, rs, nrs, out, rs_base, stream_ptr);
}
