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
// The JAX package has no Pallas kernel here.  The port ran each stage as
// 160-234 launches, one gf_mul / gf_lin / gather / copy a link.
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
//
// Design.  The plan (inits.py, host numpy once per circuit) sorts each
// stage's terms by destination slot and permutes the static data a term
// reads into term order: A-D coefficient words (8 rows of u64), the y or x
// index, the gate word (beta entry | assert bit), and for phase 1 the Liu
// terms' packed beta references.  So consecutive threads read consecutive
// term words; the only gathers left are values[y] / values[dg], the beta
// entries and bu[x], which stay in L2.  A thread owns one slot of one row
// (consecutive threads: consecutive slots, consecutive output words) and
// sums its segment with field.cuh's products, adding canonical terms
// lazily in u64 and folding by the Mersenne rule every LAZY terms (as
// gf_segsum).  A slot whose segment is long (the plan's classes: above
// THREAD_MAX terms, or WARP_MAX) is summed by a warp or a block instead,
// with warp shuffles and shared memory; the grid is three sections, one a
// class, so the one launch has all three summers.  Every output word is
// written once, canonical; the outputs are one flat buffer whose views are
// the stacked tables, so nothing is stacked or copied after.  Scalars
// (assert_r, the claims) come from the device buffer c0, the beta tables'
// pointers by value, nothing from the host, and the kernel allocates
// nothing: a CUDA graph captures the launch.
//
// What bounds it: bytes.  Each term reads 72 bytes of plan (phase 1; a
// Liu term 8) plus L2-resident gathers, each output word is written once;
// at randomize(14, 13) that is ~25 MB (phase 1) and ~15 MB (phase 2), 5-8
// us at 3.35 TB/s.  A term's 4-5 GF(p^2) products (12-15 base products)
// take a fraction of that at the integer rate.
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

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 32;        // beta table sizes (inits.MAX_BETA_GROUPS)
constexpr int REF_SHIFT = 40;         // beta reference: group << REF_SHIFT | offset
constexpr int LAZY = 7;               // terms added between two folds
constexpr unsigned ASSERT_BIT = 1u << 31;
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
    const int* lists;           // the thread, warp and block slots
    const int* rs;              // (3, nrs): c0 column, word, plane stride
    i64 rows, tv, nc0, claim_base, terms, nrs, rs_base;
    int nt, nw, nb;             // slots of each summer class
    int t_blocks, w_blocks;     // grid sections
};

__device__ __forceinline__ u64 fold(u64 s) {
    const u64 t = (s >> 61) + (s & vpt::P);
    return t >= vpt::P ? t - vpt::P : t;
}

// a lazy sum of canonical elements: a canonical value and up to LAZY
// terms stay below 2^64
struct Acc {
    u64 re = 0, im = 0;
    int c = 0;
    __device__ __forceinline__ void add(F2 x) {
        re += x.re;
        im += x.im;
        if (++c == LAZY) {
            re = fold(re);
            im = fold(im);
            c = 0;
        }
    }
    __device__ __forceinline__ F2 get() const { return {fold(re), fold(im)}; }
};

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

// bg'(g) of a term: its layer's bg entry, times assert_r on an assert gate
__device__ __forceinline__ F2 gated(const InitArgs& A, const i64* T, int t, F2 ar) {
    const unsigned w = A.gate[t];
    const F2 b = beta_at(A, T[T_BG] + (w & ~ASSERT_BIT));
    return (w & ASSERT_BIT) ? vpt::mul2(b, ar) : b;
}

__device__ __forceinline__ F2 assert_r(const InitArgs& A, const i64* T) {
    return T[T_ASSERT] >= 0 ? c0_at(A, T[T_ASSERT]) : F2{1, 0};
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

// the sums of N elements over the scope (SCOPE 0 a thread, 1 a warp, 2 a
// block), valid in lane 0 (thread 0 of a block)
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

// out word of array `arr`, plane 0, for slot s of table T, row `row`;
// plane 1 lies rows K n further
__device__ __forceinline__ u64* out_at(const InitArgs& A, const i64* T, int words, int arr,
                                       i64 row, i64 s) {
    return A.out + 2 * words * A.rows * T[T_GBASE] + (2 * arr * A.rows + row) * T[T_KN]
           + T[T_KOFF] + s;
}

__device__ __forceinline__ void put(const InitArgs& A, const i64* T, int words, int arr,
                                    i64 row, i64 s, F2 v) {
    u64* o = out_at(A, T, words, arr, row, s);
    o[0] = v.re;
    o[A.rows * T[T_KN]] = v.im;
}

// phase 1: slot q of row `row`, terms lane, lane + step, ...
template <int SCOPE>
__device__ void p1_slot(const InitArgs& A, int q, i64 row, int lane, int step) {
    const i64* T = A.tab + (i64)A.slot_tab[q] * TAB_FIELDS;
    const i64 s = q - T[T_SLOT];
    const F2 ar = assert_r(A, T);
    Acc a, m, l;
    for (int t = A.starts[q] + lane; t < A.starts[q + 1]; t += step) {
        const F2 b = gated(A, T, t, ar);
        const F2 y = value_at(A, row, A.idx[t]);
        const F2 cA = coef_at(A, t, 0), cB = coef_at(A, t, 1);
        const F2 cC = coef_at(A, t, 2), cD = coef_at(A, t, 3);
        a.add(vpt::mul2(b, vpt::add2(vpt::mul2(cB, y), cD)));
        m.add(vpt::mul2(b, vpt::add2(cA, vpt::mul2(cC, y))));
    }
    for (int t = A.liu_starts[q] + lane; t < A.liu_starts[q + 1]; t += step)
        l.add(beta_at(A, A.liu_ref[t]));
    F2 x[3] = {a.get(), m.get(), l.get()};
    reduce<SCOPE>(x);
    if (lane != 0) return;
    const F2 v = value_at(A, row, T[T_VOFF] + s);
    const F2 bsig = s < T[T_SIZE] ? beta_at(A, T[T_B2] + s) : F2{0, 0};
    put(A, T, 6, 0, row, s, v);
    put(A, T, 6, 1, row, s, x[0]);
    put(A, T, 6, 2, row, s, x[1]);
    put(A, T, 6, 3, row, s, v);
    put(A, T, 6, 4, row, s, F2{0, 0});
    put(A, T, 6, 5, row, s, vpt::add2(bsig, x[2]));
}

// phase 2: slot q of row `row`
template <int SCOPE>
__device__ void p2_slot(const InitArgs& A, int q, i64 row, int lane, int step) {
    const i64* T = A.tab + (i64)A.slot_tab[q] * TAB_FIELDS;
    const i64 s = q - T[T_SLOT];
    const F2 ar = assert_r(A, T);
    const F2 cu = c0_at(A, A.claim_base + T[T_CLAIM] * A.rows + row);
    Acc av, mv;
    for (int t = A.starts[q] + lane; t < A.starts[q + 1]; t += step) {
        const F2 tmp = vpt::mul2(gated(A, T, t, ar), beta_at(A, T[T_B2] + A.idx[t]));
        const F2 cA = coef_at(A, t, 0), cB = coef_at(A, t, 1);
        const F2 cC = coef_at(A, t, 2), cD = coef_at(A, t, 3);
        av.add(vpt::mul2(tmp, vpt::add2(vpt::mul2(cA, cu), cD)));
        mv.add(vpt::mul2(tmp, vpt::add2(cB, vpt::mul2(cC, cu))));
    }
    F2 x[2] = {av.get(), mv.get()};
    reduce<SCOPE>(x);
    if (lane != 0) return;
    const int d = A.dg[q];
    put(A, T, 3, 0, row, s, d >= 0 ? value_at(A, row, d) : F2{0, 0});
    put(A, T, 3, 1, row, s, x[0]);
    put(A, T, 3, 2, row, s, x[1]);
}

template <int STAGE, int SCOPE>
__device__ __forceinline__ void slot(const InitArgs& A, int q, i64 row, int lane, int step) {
    if constexpr (STAGE == 1) p1_slot<SCOPE>(A, q, row, lane, step);
    else p2_slot<SCOPE>(A, q, row, lane, step);
}

// the grid: t_blocks of a thread a slot and row (their first nrs threads
// also copy the stacked challenges), w_blocks of a warp a slot and row,
// then a block a slot and row
template <int STAGE>
__device__ __forceinline__ void run(const InitArgs& A) {
    const int lane = threadIdx.x & 31;
    if ((int)blockIdx.x < A.t_blocks) {
        const i64 it = (i64)blockIdx.x * THREADS + threadIdx.x;
        if (it < A.nrs) {
            const int src = A.rs[it], dst = A.rs[A.nrs + it], stride = A.rs[2 * A.nrs + it];
            A.out[A.rs_base + dst] = A.c0[src];
            A.out[A.rs_base + dst + stride] = A.c0[A.nc0 + src];
        }
        if (it < (i64)A.nt * A.rows) slot<STAGE, 0>(A, A.lists[it % A.nt], it / A.nt, 0, 1);
    } else if ((int)blockIdx.x < A.t_blocks + A.w_blocks) {
        const i64 w = (i64)(blockIdx.x - A.t_blocks) * WARPS + (threadIdx.x >> 5);
        if (w < (i64)A.nw * A.rows) slot<STAGE, 1>(A, A.lists[A.nt + w % A.nw], w / A.nw, lane, 32);
    } else {
        const i64 b = blockIdx.x - A.t_blocks - A.w_blocks;
        slot<STAGE, 2>(A, A.lists[A.nt + A.nw + b % A.nb], b / A.nb, threadIdx.x, THREADS);
    }
}

__global__ void __launch_bounds__(THREADS) gkr_p1_inits_kernel(InitArgs A) { run<1>(A); }

__global__ void __launch_bounds__(THREADS) gkr_p2_inits_kernel(InitArgs A) { run<2>(A); }

int launch(int stage, const u64* values, long long rows, long long tv, const u64* c0,
           long long nc0, long long claim_base, int n_beta, const void* const* beta,
           const long long* beta_plane, const i64* tab, const int* slot_tab, const int* starts,
           const int* liu_starts, const int* dg, const i64* coef, long long terms,
           const int* idx, const int* gate, const i64* liu_ref, const int* lists, int nt,
           int nw, int nb, const int* rs, long long nrs, u64* out, long long rs_base,
           void* stream_ptr) {
    if (n_beta < 0 || n_beta > MAX_GROUPS || rows < 0 || nt < 0 || nw < 0 || nb < 0 || nrs < 0)
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
    A.nt = nt;
    A.nw = nw;
    A.nb = nb;
    const long long items = (long long)nt * rows > nrs ? (long long)nt * rows : nrs;
    const long long t_blocks = (items + THREADS - 1) / THREADS;
    const long long w_blocks = ((long long)nw * rows + WARPS - 1) / WARPS;
    const long long blocks = t_blocks + w_blocks + (long long)nb * rows;
    if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    A.t_blocks = (int)t_blocks;
    A.w_blocks = (int)w_blocks;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    if (stage == 1)
        gkr_p1_inits_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(A);
    else
        gkr_p2_inits_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(A);
    return (int)cudaGetLastError();
}

}  // namespace

// out: the stage's flat buffer (inits.p1_views / p2_views cut it) for
// values (2, rows, tv), c0 (2, nc0) (phase 2: the claims from claim_base
// on, rows a layer), n_beta beta tables (host arrays of their device
// pointers and plane strides) and the plan's tensors (inits.InitPlan);
// nt, nw, nb slots summed by a thread, a warp, a block; nrs stacked
// challenge pairs written at rs_base.  One launch.
extern "C" int vpt_gkr_p1_inits(const u64* values, long long rows, long long tv, const u64* c0,
                                long long nc0, long long claim_base, int n_beta,
                                const void* const* beta, const long long* beta_plane,
                                const i64* tab, const int* slot_tab, const int* starts,
                                const int* liu_starts, const int* dg, const i64* coef,
                                long long terms, const int* idx, const int* gate,
                                const i64* liu_ref, const int* lists, int nt, int nw, int nb,
                                const int* rs, long long nrs, u64* out, long long rs_base,
                                void* stream_ptr) {
    return launch(1, values, rows, tv, c0, nc0, claim_base, n_beta, beta, beta_plane, tab,
                  slot_tab, starts, liu_starts, dg, coef, terms, idx, gate, liu_ref, lists, nt,
                  nw, nb, rs, nrs, out, rs_base, stream_ptr);
}

extern "C" int vpt_gkr_p2_inits(const u64* values, long long rows, long long tv, const u64* c0,
                                long long nc0, long long claim_base, int n_beta,
                                const void* const* beta, const long long* beta_plane,
                                const i64* tab, const int* slot_tab, const int* starts,
                                const int* liu_starts, const int* dg, const i64* coef,
                                long long terms, const int* idx, const int* gate,
                                const i64* liu_ref, const int* lists, int nt, int nw, int nb,
                                const int* rs, long long nrs, u64* out, long long rs_base,
                                void* stream_ptr) {
    return launch(2, values, rows, tv, c0, nc0, claim_base, n_beta, beta, beta_plane, tab,
                  slot_tab, starts, liu_starts, dg, coef, terms, idx, gate, liu_ref, lists, nt,
                  nw, nb, rs, nrs, out, rs_base, stream_ptr);
}
