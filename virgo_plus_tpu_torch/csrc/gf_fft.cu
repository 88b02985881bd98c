// X1 transforms: the radix-2 FFT and the FRI fold over GF((2^61-1)^2) on
// Hopper (sm_90a).
//
// Replaces chains of the JAX package's GF(p^2) ops that XLA fuses inside
// the jits, and that the port ran as a gf_table, a gf_mul, two gf_lin and a
// concatenation a butterfly stage (csrc/gf_ops.cu, csrc/gf_chains.cu):
// - gf_fft, one transform (virgo_plus_tpu/pc/fft.py:38 fft, :74 ifft):
//   every butterfly stage of (2, R, coef_len) coefficient rows onto
//   (2, R, 2^L) evaluations, in one launch up to 2^TILE_LOG coefficients;
// - gf_fri_fold, L FRI fold levels (virgo_plus_tpu/pc/virgo_pc.py:197
//   fold_step, :221 fold_codewords): level k folds (2, R, n_k) -> (2, R,
//   n_k/2), out[i] = ((a + b) + (a - b) w_k[i] r_k) / 2, a = cw[i], b =
//   cw[i + n_k/2], w_k[i] the inverse root of order 2^(lg-k) to the power
//   i S + q (a rank q of S holds the global positions t S + q).
//
// gf_fft's schedule is the reference's self-sorting (Stockham) one
// (virgo_plus_tpu_torch/pc/fft.py fft_plain): the coefficients are
// replicated to 2^L entries, then stage dep = lg_coef - 1, ..., 0 pairs
// x = j 2m + i with x + m (m = 2^dep) and writes e + w_j o to j m + i and
// e - w_j o to (2^(L-dep-1) + j) m + i, w_j = rou^(j 2^dep).  On index bits
// a stage is a butterfly on bit dep followed by a rotation of bits
// [dep, L) one place to the right (bit dep, the sign, goes to the top).
// So k consecutive stages dep = D, ..., D - k + 1 only ever pair entries
// that differ in the k bits [D - k + 1, D] of the input index: a tile of 2^k
// entries with the other L - k bits (its column c = low | high << (D - k + 1))
// fixed.  Stage r of a tile pairs slots t and t | 2^p, p = k - 1 - r, with
// the twiddle S_dep[j], S_dep = stage dep's table rou^(j 2^dep), j = high
// + bitrev_r(t >> (p + 1)) 2^(L-1-D) (derivation: the rotations); slot t
// ends at c + bitrev_k(t) 2^(L-k), which is where the k rotations put it.
// Two stages r, r + 1 are one radix-4 pass: a thread holds the four slots
// that differ in bits p and p - 1 in registers, with w_a = S_dep[j], w_b =
// S_{dep-1}[j] (w_a = w_b^2) and w_c = S_{dep-1}[3j] (= w_b^3, -S[3j - half]
// past the table's half), and writes
//   y0 = (x0 + C) + (B + D), y1 = (x0 + C) - (B + D),
//   y2 = (x0 - C) + I (B - D), y3 = (x0 - C) - I (B - D),
// C = w_a x2, B = w_b x1, D = w_c x3, I = rou^(2^(L-2)) = +-i, where
// I (a + bi) is a negation and a swap: three products for four
// butterflies.  The butterflies are lazy: each product is folded once
// (field.cuh mul2_fold, below p + 8), the sums carry multiples of p, and
// each output word is reduced once.  An odd stage count starts with one
// radix-2 pass (two butterflies a thread, one twiddle a column).  A
// launch runs ceil(k / 2) passes: the first loads its slots from global
// memory, each later one
// takes them from shared memory after the one barrier a pass, and the
// last stores to global memory; a pass's twiddles are loaded a pass
// ahead, three (radix-2: two) 16-byte loads a thread, by 32-bit index
// arithmetic and one __brev.  The twiddles are the table of the wrapper's
// twiddle cache (pc/fft.py twiddles: every S_dep, (re, im) pairs, made
// once per (root, order, device)), so a call makes no other launch.
// Replicated coefficients need no copy: entry x of the first launch's
// input is coefficient x mod coef_len, so a 128-coefficient row onto 4096
// points is 32 tiles of 128 that all read the same row.  A block holds
// 2^g tiles of consecutive columns (2^(k+g) = 2^BLOCK_LOG entries where the
// columns allow, fewer while the grid has under FFT_BLOCKS blocks), a
// thread a group of four slots, the columns in the threads' low bits, so
// that loads and stores run along consecutive columns.  Where four slots
// a thread would leave the grid under FFT_PAIRS_BELOW threads (the 64-row
// IFFTs at 2^7 and 2^8: one warp a tile), a thread takes two slots and
// the launch runs k radix-2 stages, twice the warps for a chain of
// dependent products that is what bounds those calls.  Up to TILE_LOG
// stages are one launch (32 KB of shared memory, under the 48 KB a block
// gets without an attribute); more coefficients take ceil(lg_coef /
// TILE_LOG) launches of near-equal stage counts through a scratch buffer.
// An inverse transform's 1/n is multiplied in the last launch's store.
// Input rows are read in place from FFT_AXES lead sizes and strides, a
// plane stride and an element stride passed by value (h_coef = lq_coef[...,
// srec:] is a strided view), so nothing is copied and nothing comes from
// the host: a CUDA graph captures the launches.
// What bounds it: the integer units, lg_coef butterflies per pair of
// outputs (chip_smoke.py's bound counts 36 32-bit operations a radix-2
// butterfly: a product and two sums; the radix-4 passes make three
// products where that count has four, but a product is ~75 SASS
// instructions and a radix-4 pass ~530 a thread), before the bytes (each
// coefficient read and each evaluation written once, 16 bytes an element
// at 3.35 TB/s).
//
// gf_fri_fold: every level of a call in one launch (more than
// LAUNCH_LEVELS levels: ceil(L / LAUNCH_LEVELS) launches of near-equal
// level counts, each reading the last level of the one before).  Level k
// pairs i with i + n_k/2, so the columns {j + m n/2^L : m < 2^L} of an
// n-entry row are closed under the L folds: a tile (C such column sets of
// one row, C 2^L <= 2^FOLD_TILE_LOG entries; C consecutive columns, at
// least four (a 32-byte sector) where the row has them, fewer a tile
// while the grid would be short of FOLD_SMS tiles) is loaded into shared
// memory once (cp.async, 8 bytes a word: any strides, any alignment),
// folded there through every level, in place, one barrier a level, and
// each level is stored once, coalesced along the columns, into one buffer
// that holds every level contiguous (2, R, n/2^(k+1)) after the one
// before.  A level's product w_k[i] r_k does not depend on the row: a
// block makes those of its tile's columns once, into shared memory, while
// its first tile loads, so an element's level costs one product on the
// chain.  The grid is persistent (as many blocks as fit at once, two an
// SM at 96 KB, at most FOLD_BLOCKS, a multiple of the tiles a row where
// it can be, so a block keeps its columns and its products): a block with
// more than one tile double-buffers, so a tile's load overlaps the levels
// of the one before it.  Level k's twiddles are stage k of the top table
// (pc/fft.py twiddles of the inverse root of order 2^lg: stage k = its
// powers of the root of order 2^(lg-k), since that root is the top one
// squared k times), entry i S + q; the challenges are read in place
// through per-level pointers and plane strides passed by value, so a CUDA
// graph captures the launch and nothing is stacked.  /2 is a halving ((x
// + p) / 2 for odd x), the same canonical word as the product by 1/2;
// the products are mul2_split's, the same canonical words as mul2's.
// What bounds it: the bytes, the top codeword read once and every level
// written once (16 bytes an element each; the twiddles come from an
// L2-resident table); two products, three sums and a halving an output
// element are about 0.6 of that time at 3.35 TB/s on the integer units.
//
// Bits.  Every output word is the canonical representative, so on the
// canonical inputs every caller passes, kernel and twin give the same
// bits as the JAX package, whatever the order of the stages' work.
//
// Why CUDA and not Triton: exact 64-bit products (__umul64hi), register
// groups exchanged through shared memory, asynchronous copies into a
// persistent block's double buffer with a barrier a level, and the loader
// and launch counting of kernels.py, shared with the other entries.
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"

using vpt::F2;
using vpt::u64;

namespace {

typedef long long i64;

constexpr int FOLD_THREADS = 256;  // gf_fri_fold's block
constexpr int FOLD_TILE_LOG = 11;  // entries a fold tile (log2): 32 KB, and 32 of products
constexpr int LAUNCH_LEVELS = 8;   // most levels a launch: a tile keeps >= 4 columns
constexpr int MIN_COLS_LOG = 2;    // columns a tile (log2) where the row has them
constexpr int FOLD_SMS = 132;      // fewer tiles: fewer columns a tile
constexpr int FOLD_BLOCKS = 132 * 4;    // the persistent grid's most blocks
constexpr int TILE_LOG = 11;       // most stages a launch: 2^11 entries, 32 KB
constexpr int BLOCK_LOG = 10;      // entries a block (log2), columns allowing
constexpr int FFT_BLOCKS = 264;    // fewer blocks: fewer columns a block
constexpr int FFT_THREADS = 1 << (TILE_LOG - 2);   // a thread four slots
constexpr int FFT_PAIRS_BELOW = 16384;   // fewer threads at four slots: two a thread
constexpr int FFT_AXES = 3;        // lead axes of the input rows
constexpr int MAX_LOG = 40;        // largest log2 of a transform's order
constexpr u64 INV2 = (vpt::P + 1) / 2;  // 1/2 in GF(p)

// the input rows: FFT_AXES lead axes (sizes, element strides), the plane
// and last-axis element strides
struct Rows {
    unsigned size[FFT_AXES];
    i64 stride[FFT_AXES];
    i64 plane, term;
};

// the first element of row `row` (< 2^31: 32-bit divisions)
__device__ __forceinline__ i64 row_offset(const Rows& R, unsigned row) {
    i64 off = 0;
#pragma unroll
    for (int d = FFT_AXES - 1; d >= 0; --d) {
        off += (i64)(row % R.size[d]) * R.stride[d];
        row /= R.size[d];
    }
    return off;
}

// ---------------------------------------------------------------------------
// gf_fft
// ---------------------------------------------------------------------------

struct FftArgs {
    const u64* in;
    Rows rows;
    const ulonglong2* tw;   // S_dep at 2^L - 2^(L-dep), (re, im) pairs
    u64* out;               // (2, R, 2^L) contiguous
    unsigned cols;          // tiles: R 2^(L-k)
    int L;                  // log2 of the order
    int k;                  // stages of this launch
    int D;                  // its first stage's dep
    int g;                  // log2 of the tiles (columns) a block
    int in_log;             // log2 of an input row's length
    int i_neg;              // rou^(2^(L-2)) = -i (else i)
    int scaled;             // multiply the stores by (s_re, s_im)
    u64 s_re, s_im;
};

// b with a zero bit inserted at pos
__device__ __forceinline__ unsigned insert0(unsigned b, int pos) {
    return ((b >> pos) << (pos + 1)) | (b & ((1u << pos) - 1));
}

__device__ __forceinline__ u64 negp(u64 x) { return x ? vpt::P - x : 0; }

// the top r bits of t (of k) reversed
__device__ __forceinline__ unsigned top_rev(unsigned t, int k, int r) {
    return r ? __brev(t >> (k - r)) >> (32 - r) : 0;
}

__device__ __forceinline__ F2 tw_at(const ulonglong2* tw, unsigned e) {
    const ulonglong2 w = tw[e];
    return {w.x, w.y};
}

// a pass of the launch: its first stage r, radix 2 or 4, and the bits
// (hi > lo) of the block's slot index s = t 2^g + column that vary across a
// thread's V slots: with four slots the pair bit(s), and for radix 2 a
// spare bit (the next tile bit, or for a one-stage tile a column bit);
// with two slots the pair bit (a column bit for a tile of one slot)
struct Pass {
    int r, radix4, hi, lo;
};

template <int V>
__device__ __forceinline__ Pass pass_of(const FftArgs& A, int i) {
    if (V == 2) return A.k ? Pass{i, 0, A.k - 1 - i + A.g, 0} : Pass{0, 0, 0, 0};
    if (A.k == 0) return {0, 0, 1, 0};          // four columns, no stage
    if (A.k & 1) {
        if (i == 0) return {0, 0, A.k - 1 + A.g, A.k >= 3 ? A.k - 2 + A.g : A.g - 1};
        const int r = 2 * i - 1;
        return {r, 1, A.k - 1 - r + A.g, A.k - 2 - r + A.g};
    }
    const int r = 2 * i;
    return {r, 1, A.k - 1 - r + A.g, A.k - 2 - r + A.g};
}

// the first slot of thread b in pass P, and its slot e
template <int V>
__device__ __forceinline__ unsigned first_slot(unsigned b, const Pass& P) {
    return V == 2 ? insert0(b, P.hi) : insert0(insert0(b, P.lo), P.hi);
}

template <int V>
__device__ __forceinline__ unsigned slot(unsigned s0, const Pass& P, int e) {
    return V == 2 ? s0 | (e << P.hi) : s0 | ((e & 1) << P.lo) | ((e >> 1) << P.hi);
}

// the twiddles of pass P for the thread whose first slot is s0: radix 4
// (w_a, w_b, w_c); radix 2 with four slots the twiddle of each pair's
// column (its first stage); with two slots the stage's
template <int V>
__device__ __forceinline__ void pass_twiddles(const FftArgs& A, const Pass& P, unsigned s0,
                                              F2 (&w)[3]) {
    const int low = A.D - A.k + 1;
    const unsigned c_mask = (1u << (A.L - A.k)) - 1;
    const unsigned gmask = (1u << A.g) - 1;
    const unsigned C0 = blockIdx.x << A.g;
    const int dep = A.D - P.r;
    const unsigned base = (1u << A.L) - (1u << (A.L - dep));   // S_dep
    const unsigned j = (((C0 + (s0 & gmask)) & c_mask) >> low)
                       | (top_rev(s0 >> A.g, A.k, P.r) << (A.L - 1 - A.D));
    w[0] = tw_at(A.tw, base + j);
    if (V == 2) return;
    if (!P.radix4) {
        const unsigned s1 = s0 | (1u << P.lo);
        w[1] = tw_at(A.tw, base + (((C0 + (s1 & gmask)) & c_mask) >> low));
        return;
    }
    const unsigned below = (1u << A.L) - (1u << (A.L - dep + 1));   // S_{dep-1}
    const unsigned half = 1u << (A.L - dep);                       // its length
    w[1] = tw_at(A.tw, below + j);
    const unsigned j3 = 3 * j;
    w[2] = tw_at(A.tw, below + (j3 < half ? j3 : j3 - half));
    if (j3 >= half) w[2] = {negp(w[2].re), negp(w[2].im)};
}

// the butterflies of a pass, lazily: each product folded once (below p +
// 8, mul2_fold), the sums carry multiples of p that keep them positive
// (2p, 4p), and each output component is reduced once (vpt::canon); every
// value stays below 2^64 (radix 4: u, sp < 2^62 + 16; v, dm < 2^62 +
// 2^61 + 8 < 4p; the outputs below 2^63 + 2^62 + 2^61)
template <int V>
__device__ __forceinline__ void run_pass(const Pass& P, bool i_neg, const F2 (&w)[3],
                                         F2 (&x)[V]) {
    constexpr u64 P2 = 2 * vpt::P, P4 = 4 * vpt::P;
    using vpt::canon;
    auto radix2 = [](F2& a, F2& b, const F2& w) {
        const F2 t = vpt::mul2_fold(w, b);
        b = {canon(a.re + (P2 - t.re)), canon(a.im + (P2 - t.im))};
        a = {canon(a.re + t.re), canon(a.im + t.im)};
    };
    if constexpr (V == 2) {
        radix2(x[0], x[1], w[0]);
    } else {
        if (!P.radix4) {
            radix2(x[0], x[2], w[0]);
            radix2(x[1], x[3], w[1]);
            return;
        }
        const F2 c = vpt::mul2_fold(w[0], x[2]);
        const F2 b = vpt::mul2_fold(w[1], x[1]);
        const F2 d = vpt::mul2_fold(w[2], x[3]);
        const F2 u = {x[0].re + c.re, x[0].im + c.im};
        const F2 v = {x[0].re + (P2 - c.re), x[0].im + (P2 - c.im)};
        const F2 sp = {b.re + d.re, b.im + d.im};
        const F2 dm = {b.re + (P2 - d.re), b.im + (P2 - d.im)};
        // (+-i) dm: a swap and a negation (-y = 4p - y)
        const F2 idm = i_neg ? F2{dm.im, P4 - dm.re} : F2{P4 - dm.im, dm.re};
        x[0] = {canon(u.re + sp.re), canon(u.im + sp.im)};
        x[1] = {canon(u.re + (P4 - sp.re)), canon(u.im + (P4 - sp.im))};
        x[2] = {canon(v.re + idm.re), canon(v.im + idm.im)};
        x[3] = {canon(v.re + (P4 - idm.re)), canon(v.im + (P4 - idm.im))};
    }
}

// V slots a thread: four (radix-4 passes), or two (radix-2 stages, twice
// the threads, for grids short of threads)
template <int V>
__global__ void __launch_bounds__(FFT_THREADS) gf_fft_tile(FftArgs A) {
    extern __shared__ ulonglong2 sm[];
    const int cols_log = A.L - A.k;
    const unsigned c_mask = (1u << cols_log) - 1;
    const unsigned gmask = (1u << A.g) - 1;
    const unsigned C0 = blockIdx.x << A.g;
    const int low = A.D - A.k + 1;             // column bits below the tile's
    const unsigned in_mask = (1u << A.in_log) - 1;
    const int passes = V == 2 ? A.k : (A.k + 1) >> 1;

    // a pass's twiddles are loaded a pass ahead of it
    Pass P = pass_of<V>(A, 0), Pn = P;
    unsigned s0 = first_slot<V>(threadIdx.x, P), sn = s0;
    F2 w[3], wn[3];
    if (passes > 0) pass_twiddles<V>(A, P, s0, w);
    if (passes > 1) {
        Pn = pass_of<V>(A, 1);
        sn = first_slot<V>(threadIdx.x, Pn);
        pass_twiddles<V>(A, Pn, sn, wn);
    }
    F2 x[V];
    unsigned row = ~0u;
    i64 off = 0;
#pragma unroll
    for (int e = 0; e < V; ++e) {
        const unsigned s = slot<V>(s0, P, e);
        const unsigned C = C0 + (s & gmask);
        x[e] = {0, 0};
        if (C >= A.cols) continue;
        if (C >> cols_log != row) {
            row = C >> cols_log;
            off = row_offset(A.rows, row);
        }
        const unsigned c = C & c_mask;
        const unsigned xi = (c & ((1u << low) - 1)) | ((s >> A.g) << low)
                            | ((c >> low) << (A.D + 1));
        const u64* p = A.in + off + (i64)(xi & in_mask) * A.rows.term;
        x[e] = {p[0], p[A.rows.plane]};
    }
    for (int i = 0; i < passes; ++i) {
        run_pass<V>(P, A.i_neg, w, x);
        if (i + 1 == passes) break;
#pragma unroll
        for (int e = 0; e < V; ++e) sm[slot<V>(s0, P, e)] = {x[e].re, x[e].im};
        P = Pn;
        s0 = sn;
#pragma unroll
        for (int e = 0; e < 3; ++e) w[e] = wn[e];
        if (i + 2 < passes) {
            Pn = pass_of<V>(A, i + 2);
            sn = first_slot<V>(threadIdx.x, Pn);
            pass_twiddles<V>(A, Pn, sn, wn);
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const ulonglong2 v = sm[slot<V>(s0, P, e)];
            x[e] = {v.x, v.y};
        }
    }
    const size_t plane = (size_t)(A.cols >> cols_log) << A.L;
#pragma unroll
    for (int e = 0; e < V; ++e) {
        const unsigned s = slot<V>(s0, P, e);
        const unsigned C = C0 + (s & gmask);
        if (C >= A.cols) continue;
        const unsigned t = s >> A.g;
        const unsigned rev = A.k ? __brev(t) >> (32 - A.k) : 0;
        const size_t o = ((size_t)(C >> cols_log) << A.L) + (C & c_mask) + (rev << cols_log);
        F2 v = x[e];
        if (A.scaled) {
            v = A.s_im ? vpt::mul2_split(v, {A.s_re, A.s_im})
                       : F2{vpt::mulp(v.re, A.s_re), vpt::mulp(v.im, A.s_re)};
        }
        A.out[o] = v.re;
        A.out[plane + o] = v.im;
    }
}

// ---------------------------------------------------------------------------
// gf_fri_fold
// ---------------------------------------------------------------------------

struct FoldArgs {
    const u64* cw;
    Rows rows;
    const ulonglong2* tw;      // the top table's stages, (re, im) pairs
    const u64* r[LAUNCH_LEVELS];    // this launch's challenges
    i64 r_plane[LAUNCH_LEVELS];     // and their plane strides
    u64* out;                  // this launch's first level, the others after it
    long long R;
    unsigned tiles;            // R 2^tile_log, tile_log = n_log - L - c_log
    int n_log;                 // log2 of an input row's entries
    int L;                     // this launch's levels
    int c_log;                 // log2 of a tile's columns
    int lg;                    // log2 of the top table's order
    int first;                 // the top level of this launch's first
    long long S, q;            // shards, and this rank's index among them
};

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// x / 2 mod p of a canonical x: (x + p) / 2 for odd x, below p
__device__ __forceinline__ u64 halve(u64 x) { return (x >> 1) + ((x & 1) ? INV2 : 0); }

// the first column of tile t
__device__ __forceinline__ i64 tile_j0(const FoldArgs& A, unsigned t) {
    const int tile_log = A.n_log - A.L - A.c_log;
    return (i64)(t & ((1u << tile_log) - 1)) << A.c_log;
}

// tile t's entries into buf: the re plane, then the im plane (2^(c_log +
// L) words each; entry c + m C is column j0 + c, position m: row entry
// j0 + c + m cols)
__device__ __forceinline__ void fold_load(const FoldArgs& A, unsigned t, u64* buf) {
    const unsigned row = t >> (A.n_log - A.L - A.c_log);
    const i64 j0 = tile_j0(A, t);
    const i64 cols = (i64)1 << (A.n_log - A.L);
    const unsigned E = 1u << (A.c_log + A.L), cmask = (1u << A.c_log) - 1;
    const u64* base = A.cw + row_offset(A.rows, row);
    for (unsigned e = threadIdx.x; e < E; e += FOLD_THREADS) {
        const i64 x = (j0 + (e & cmask) + (i64)(e >> A.c_log) * cols) * A.rows.term;
        cp_async8(buf + e, base + x);
        cp_async8(buf + E + e, base + A.rows.plane + x);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the products w_k[i] r_k of every level of the column sets from j0:
// level k's item it at E - E/2^k + it of wr
__device__ __forceinline__ void fold_twiddles(const FoldArgs& A, i64 j0, const F2* rs, F2* wr) {
    const i64 cols = (i64)1 << (A.n_log - A.L);
    const unsigned E = 1u << (A.c_log + A.L), cmask = (1u << A.c_log) - 1;
    for (int k = 0; k < A.L; ++k) {
        const ulonglong2* stage =
            A.tw + ((1ull << A.lg) - ((1ull << A.lg) >> (A.first + k)));
        const unsigned items = E >> (k + 1), at = E - (E >> k);
        for (unsigned it = threadIdx.x; it < items; it += FOLD_THREADS) {
            const i64 i = j0 + (it & cmask) + (i64)(it >> A.c_log) * cols;
            const ulonglong2 w = stage[i * A.S + A.q];
            wr[at + it] = vpt::mul2_split({w.x, w.y}, rs[k]);
        }
    }
}

// every level of tile t in buf, in place: level k's item (c, m), m <
// 2^(L-1-k), folds entries c + m C and c + (m + 2^(L-1-k)) C into c + m C
// and stores it at row position j0 + c + m cols of level k
__device__ __forceinline__ void fold_tile(const FoldArgs& A, unsigned t, u64* buf,
                                          const F2* wr) {
    const unsigned row = t >> (A.n_log - A.L - A.c_log);
    const i64 j0 = tile_j0(A, t);
    const i64 cols = (i64)1 << (A.n_log - A.L);
    const unsigned E = 1u << (A.c_log + A.L), cmask = (1u << A.c_log) - 1;
    const i64 n = (i64)1 << A.n_log;
    for (int k = 0; k < A.L; ++k) {
        const unsigned items = E >> (k + 1), at = E - (E >> k);
        const i64 n_out = n >> (k + 1);
        u64* o = A.out + 2 * A.R * (n - (n >> k)) + (i64)row * n_out;
        const i64 plane = A.R * n_out;
#pragma unroll 2
        for (unsigned it = threadIdx.x; it < items; it += FOLD_THREADS) {
            const unsigned s1 = it + items;
            const F2 a = {buf[it], buf[E + it]};
            const F2 b = {buf[s1], buf[E + s1]};
            const F2 d = vpt::mul2_split(vpt::sub2(a, b), wr[at + it]);
            const F2 v = vpt::add2(vpt::add2(a, b), d);
            const u64 re = halve(v.re), im = halve(v.im);
            const i64 i = j0 + (it & cmask) + (i64)(it >> A.c_log) * cols;
            o[i] = re;
            o[plane + i] = im;
            if (k + 1 < A.L) {
                buf[it] = re;
                buf[E + it] = im;
            }
        }
        if (k + 1 < A.L) __syncthreads();
    }
}

// a persistent block: tiles blockIdx.x, + gridDim.x, ...; with more than
// one, tile i + 1 loads into the other buffer while tile i folds.  Its
// twiddle products are made while its first tile loads, and again only
// where a tile starts at other columns (the grid is a multiple of the
// tiles a row where it can be, so a block keeps its columns)
__global__ void __launch_bounds__(FOLD_THREADS) gf_fri_fold(const __grid_constant__ FoldArgs A) {
    extern __shared__ u64 fold_sm[];
    __shared__ F2 rs[LAUNCH_LEVELS];
    const unsigned E = 1u << (A.c_log + A.L);
    F2* wr = reinterpret_cast<F2*>(fold_sm);            // E - C products
    u64* bufs = fold_sm + 2 * E;                        // the tiles' entries
    unsigned t = blockIdx.x;
    fold_load(A, t, bufs);
    if ((int)threadIdx.x < A.L) rs[threadIdx.x] = {A.r[threadIdx.x][0],
                                                   A.r[threadIdx.x][A.r_plane[threadIdx.x]]};
    __syncthreads();
    i64 j0 = -1;
    int cur = 0;
    for (; t < A.tiles; t += gridDim.x) {
        if (t + gridDim.x < A.tiles) fold_load(A, t + gridDim.x, bufs + (cur ^ 1) * 2 * E);
        if (tile_j0(A, t) != j0) {
            j0 = tile_j0(A, t);
            fold_twiddles(A, j0, rs, wr);
        }
        if (t + gridDim.x < A.tiles)
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        fold_tile(A, t, bufs + cur * 2 * E, wr);
        __syncthreads();
        cur ^= 1;
    }
}

Rows rows_of(int d0, int d1, int d2, long long s0, long long s1, long long s2,
             long long plane, long long term) {
    return {{(unsigned)d0, (unsigned)d1, (unsigned)d2}, {s0, s1, s2}, plane, term};
}

}  // namespace

// out (2, R, 2^log_order) = the FFT of the (2, R, 2^lg_coef) coefficient
// rows `in` (lead sizes d0 d1 d2 = R, element strides s0 s1 s2, plane and
// last-axis strides) at the root whose stage tables tw (pc/fft.py
// twiddles: (2^log_order - 1) (re, im) pairs) holds, i_neg when
// rou^(2^(log_order-2)) = -i, times (s_re, s_im) if scaled.
// ceil(lg_coef / TILE_LOG) launches (one for lg_coef = 0), through tmp
// (out's shape) when more than one; none for R = 0.  R 2^log_order must
// be below 2^31 (32-bit indices).
extern "C" int vpt_gf_fft(const u64* in, int d0, int d1, int d2, long long s0,
                          long long s1, long long s2, long long plane, long long term,
                          const u64* tw, u64* out, u64* tmp, int lg_coef, int log_order,
                          int i_neg, int scaled, u64 s_re, u64 s_im, void* stream_ptr) {
    const long long R = (long long)d0 * d1 * d2;
    if (R <= 0) return 0;
    if (lg_coef < 0 || lg_coef > log_order || log_order > MAX_LOG
        || (R << log_order) >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    const int n = lg_coef ? (lg_coef + TILE_LOG - 1) / TILE_LOG : 1;
    if (n > 1 && !tmp) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    FftArgs A = {in, rows_of(d0, d1, d2, s0, s1, s2, plane, term),
                 reinterpret_cast<const ulonglong2*>(tw), nullptr, 0, log_order, 0,
                 lg_coef - 1, 0, lg_coef, i_neg, 0, s_re, s_im};
    for (int i = 0; i < n; ++i) {
        A.k = lg_coef / n + (i < lg_coef % n);
        A.out = (n - 1 - i) % 2 == 0 ? out : tmp;     // the last launch writes out
        A.scaled = scaled && i == n - 1;
        A.cols = (unsigned)(R << (log_order - A.k));
        // two slots a thread where four would leave the grid short of
        // threads (and a block's tile fits 2 FFT_THREADS slots)
        const int V = A.k <= BLOCK_LOG && ((unsigned long long)A.cols << A.k) < 4ull * FFT_PAIRS_BELOW
                          ? 2 : 4;
        // 2^BLOCK_LOG entries a block, at least V; fewer columns a block
        // while the grid is short of FFT_BLOCKS
        const int v_log = V == 2 ? 1 : 2;
        const int g_min = A.k < v_log ? v_log - A.k : 0;
        A.g = A.k < BLOCK_LOG ? BLOCK_LOG - A.k : 0;
        auto blocks = [&](int g) { return (A.cols + (1u << g) - 1) >> g; };
        while (A.g > g_min && blocks(A.g) < FFT_BLOCKS) --A.g;
        const unsigned threads = 1u << (A.k + A.g - v_log);
        const size_t smem = sizeof(ulonglong2) << (A.k + A.g);
        if (V == 2)
            gf_fft_tile<2><<<blocks(A.g), threads, smem, stream>>>(A);
        else
            gf_fft_tile<4><<<blocks(A.g), threads, smem, stream>>>(A);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        // the next launch reads this one's output, rows contiguous
        A.in = A.out;
        A.rows = rows_of(1, 1, (int)R, 0, 0, 1ll << log_order, R << log_order, 1);
        A.D -= A.k;
        A.in_log = log_order;
    }
    return 0;
}

// out = L FRI folds of the codeword rows cw (lead sizes d0 d1 d2 = R,
// element strides, plane and last-axis strides; 2^n_log entries a row),
// level k into out + 2 R (2^n_log - 2^(n_log - k)) as (2, R, 2^(n_log-k-1)):
// with the challenges r[k] (device pointers, plane strides r_plane[k],
// host arrays) and the twiddles tw (pc/fft.py twiddles of the inverse
// root of order 2^lg = S 2^n_log: 2^lg - 1 (re, im) pairs) at the
// positions of rank q of S.  ceil(L / LAUNCH_LEVELS) launches, none for
// R = 0.
extern "C" int vpt_gf_fri_fold(const u64* cw, int d0, int d1, int d2, long long s0,
                               long long s1, long long s2, long long plane,
                               long long term, const u64* tw, int lg, long long S,
                               long long q, const u64* const* r, const long long* r_plane,
                               int levels, u64* out, int n_log, void* stream_ptr) {
    const long long R = (long long)d0 * d1 * d2;
    if (R <= 0) return 0;
    if (levels < 1 || levels > n_log || n_log > lg || lg > MAX_LOG
        || S != (1ll << (lg - n_log)) || q < 0 || q >= S || R >= (1ll << 31)
        || (R << n_log) >= (1ll << 40))
        return (int)cudaErrorInvalidValue;
    static bool big_smem[64] = {};     // the shared-memory attributes, once a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const int n = (levels + LAUNCH_LEVELS - 1) / LAUNCH_LEVELS;
    FoldArgs A = {cw, rows_of(d0, d1, d2, s0, s1, s2, plane, term),
                  reinterpret_cast<const ulonglong2*>(tw), {}, {}, out, R, 0, n_log,
                  0, 0, lg, 0, S, q};
    for (int i = 0; i < n; ++i) {
        A.L = levels / n + (i < levels % n);
        for (int k = 0; k < A.L; ++k) {
            A.r[k] = r[A.first + k];
            A.r_plane[k] = r_plane[A.first + k];
        }
        const int free_log = A.n_log - A.L;        // column sets a row (log2)
        A.c_log = free_log < FOLD_TILE_LOG - A.L ? free_log : FOLD_TILE_LOG - A.L;
        while (A.c_log > MIN_COLS_LOG && (R << (free_log - A.c_log)) < FOLD_SMS) --A.c_log;
        const long long tiles = R << (free_log - A.c_log);
        if (tiles >= (1ll << 32)) return (int)cudaErrorInvalidValue;
        A.tiles = (unsigned)tiles;
        // the twiddle products (16 bytes an entry), then a buffer of the
        // entries' two planes, two for a block of several tiles; as many
        // blocks as fit on the card at once, at most FOLD_BLOCKS, and a
        // multiple of the tiles a row where that leaves some
        const size_t smem = sizeof(u64) * (2u << (A.c_log + A.L));
        if (!(dev < 64 && big_smem[dev])) {
            err = cudaFuncSetAttribute(gf_fri_fold, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(6 * sizeof(u64) << FOLD_TILE_LOG));
            if (err != cudaSuccess) return (int)err;
            err = cudaFuncSetAttribute(gf_fri_fold, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
            if (err != cudaSuccess) return (int)err;
            if (dev < 64) big_smem[dev] = true;
        }
        int per_sm = 0, sms = 0;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_fri_fold,
                                                                 FOLD_THREADS, 3 * smem))
                != cudaSuccess
            || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
                != cudaSuccess)
            return (int)err;
        const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
        long long cap = fit < FOLD_BLOCKS ? fit : FOLD_BLOCKS;
        const long long per_row = 1ll << (free_log - A.c_log);
        if (cap >= per_row) cap -= cap % per_row;
        const unsigned grid = tiles < cap ? (unsigned)tiles : (unsigned)cap;
        const size_t dyn = (tiles > grid ? 3 : 2) * smem;
        gf_fri_fold<<<grid, FOLD_THREADS, dyn, stream>>>(A);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        // the next launch reads this one's last level, rows contiguous
        const long long nn = 1ll << A.n_log;
        const long long last = nn >> A.L;
        A.cw = A.out + 2 * R * (nn - 2 * last);
        A.rows = rows_of(1, 1, (int)R, 0, 0, last, R * last, 1);
        A.out += 2 * R * (nn - last);
        A.first += A.L;
        A.n_log -= A.L;
    }
    return 0;
}
