// X1 transforms: the radix-2 FFT and the FRI fold over GF((2^61-1)^2) on
// Hopper (sm_90a).
//
// Replaces chains of the JAX package's GF(p^2) ops that XLA fuses inside
// the jits, and that the port ran as a gf_table, a gf_mul, two gf_lin and a
// concatenation a butterfly stage (csrc/gf_ops.cu, csrc/gf_chains.cu):
// - gf_fft, one transform (virgo_plus_tpu/pc/fft.py:38 fft, :74 ifft):
//   every butterfly stage of (2, R, coef_len) coefficient rows onto
//   (2, R, 2^L) evaluations, in one launch up to 2^TILE_LOG coefficients;
// - gf_fri_fold, one FRI fold level (virgo_plus_tpu/pc/virgo_pc.py:197
//   fold_step): (2, R, N) -> (2, R, N/2),
//   out[i] = ((a + b) + (a - b) w[i] r) / 2, a = cw[i], b = cw[i + N/2].
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
// fixed.  A launch loads each tile into shared memory once, runs its k
// stages in place (stage r pairs tile slots t and t | 2^(k-1-r), each
// thread two slots, one barrier a stage) and writes slot t to
// c + bitrev_k(t) 2^(L-k), which is where the k rotations put it.  The
// twiddle of stage r is T[j 2^dep], dep = D - r, T[e] = rou^e (e < 2^(L-1),
// one gf_table launch by the wrapper), j = high + the top r bits of t
// reversed, placed at bits L - D - 2 + r - q (derivation: the rotations).
// Replicated coefficients need no copy: entry x of the first launch's
// input is coefficient x mod coef_len, so a 128-coefficient row onto 4096
// points is 32 tiles of 128 that all read the same row.  A block holds
// 2^g tiles of consecutive columns (2^(k+g) >= 2^BLOCK_LOG entries where
// the columns allow, several rows where rows are short), so that its
// loads and stores run along consecutive columns: coalesced stores of
// 2^g words, and coefficient reads that hit one row.  Up to TILE_LOG
// stages are one launch (32 KB of shared memory, under the 48 KB a block
// gets without an attribute); more coefficients take ceil(lg_coef /
// TILE_LOG) launches of near-equal stage counts through a scratch buffer.
// An inverse transform's 1/n is multiplied in the last launch's store.
// Input rows are read in place from FFT_AXES lead sizes and strides, a
// plane stride and an element stride passed by value (h_coef = lq_coef[...,
// srec:] is a strided view), so nothing is copied and nothing comes from
// the host: a CUDA graph captures the launches.
// What bounds it: the integer units, lg_coef butterflies per pair of
// outputs, each a GF(p^2) product and two sums (chip_smoke.py's bound
// counts 36 32-bit operations a butterfly; the three 64x64->128 products
// and their Mersenne folds compile to several times that), before the
// bytes (each coefficient read and each evaluation written once, 16 bytes
// an element at 3.35 TB/s).
//
// gf_fri_fold: a thread an output pair of words, the rows over grid axis
// y; the codeword rows read in place like gf_fft's, w and r by strides.
// What bounds it: 1.5 codeword words read a word written (48 bytes an
// output element), three products' worth of integer work an element.
//
// Bits.  Every operation returns the canonical representative, so on the
// canonical inputs every caller passes, kernel and twin give the same
// bits as the JAX package, whatever the order of the stages' work.
//
// Why CUDA and not Triton: exact 64-bit products (__umul64hi), shared
// memory tiles with a barrier a stage, and the loader and launch counting
// of kernels.py, shared with the other entries.
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"

using vpt::F2;
using vpt::u64;

namespace {

typedef long long i64;

constexpr int THREADS = 256;
constexpr int TILE_LOG = 11;       // most stages a launch: 2^11 entries, 32 KB
constexpr int BLOCK_LOG = 9;       // least entries a block, columns allowing
constexpr int FFT_AXES = 3;        // lead axes of the input rows
constexpr int MAX_LOG = 40;        // largest log2 of a transform's order
constexpr int MAX_ROW_BLOCKS = 65535;   // grid axis y of gf_fri_fold
constexpr int MAX_BLOCKS = 132 * 16;    // grid cap of gf_fri_fold's axis x
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
    const u64* tw;       // T (2, 2^(L-1)) contiguous
    u64* out;            // (2, R, 2^L) contiguous
    long long R;         // rows
    int L;               // log2 of the order
    int k;               // stages of this launch
    int D;               // its first stage's dep
    int g;               // log2 of the tiles (columns) a block
    int in_log;          // log2 of an input row's length
    int scaled;          // multiply the stores by (s_re, s_im)
    u64 s_re, s_im;
};

__global__ void __launch_bounds__(THREADS) gf_fft_tile(FftArgs A) {
    extern __shared__ u64 sm[];
    const int E = 1 << (A.k + A.g);
    u64* s_re = sm;
    u64* s_im = sm + E;
    const int cols_log = A.L - A.k;
    const long long cols = A.R << cols_log;
    const long long c_mask = (1ll << cols_log) - 1;
    const long long C0 = (long long)blockIdx.x << A.g;
    const int g_mask = (1 << A.g) - 1;
    const int low = A.D - A.k + 1;             // column bits below the tile's
    const long long order = 1ll << A.L;
    const long long half = order >> 1;
    const u64 in_mask = (1ull << A.in_log) - 1;

    long long row_of = -1;     // the row of `in`, recomputed when it changes
    const u64* in = A.in;
    for (int s = threadIdx.x; s < E; s += THREADS) {
        const long long C = C0 + (s & g_mask);
        if (C >= cols) continue;
        if (C >> cols_log != row_of) {
            row_of = C >> cols_log;
            in = A.in + row_offset(A.rows, (unsigned)row_of);
        }
        const long long c = C & c_mask;
        const long long x = (c & ((1ll << low) - 1)) | ((long long)(s >> A.g) << low)
                            | ((c >> low) << (A.D + 1));
        const u64* p = in + (i64)(x & in_mask) * A.rows.term;
        s_re[s] = p[0];
        s_im[s] = p[A.rows.plane];
    }
    __syncthreads();
    for (int r = 0; r < A.k; ++r) {
        const int dep = A.D - r;
        const int p = A.k - 1 - r;             // the tile bit this stage pairs on
        for (int b = threadIdx.x; b < E / 2; b += THREADS) {
            const int cc = b & g_mask;
            const int tb = b >> A.g;
            const int te = ((tb >> p) << (p + 1)) | (tb & ((1 << p) - 1));
            long long j = ((C0 + cc) & c_mask) >> low;
            for (int q = 0; q < r; ++q)
                j |= (long long)((te >> (A.k - r + q)) & 1) << (A.L - A.D - 2 + r - q);
            const long long e = j << dep;
            const F2 w = {A.tw[e], A.tw[half + e]};
            const int se = (te << A.g) | cc;
            const int so = se + (1 << (p + A.g));
            const F2 t = vpt::mul2(w, {s_re[so], s_im[so]});
            const F2 ev = {s_re[se], s_im[se]};
            const F2 lo = vpt::add2(ev, t);
            const F2 hi = vpt::sub2(ev, t);
            s_re[se] = lo.re;
            s_im[se] = lo.im;
            s_re[so] = hi.re;
            s_im[so] = hi.im;
        }
        __syncthreads();
    }
    const long long plane = A.R * order;
    for (int s = threadIdx.x; s < E; s += THREADS) {
        const long long C = C0 + (s & g_mask);
        if (C >= cols) continue;
        const int t = s >> A.g;
        const long long rev = A.k ? (long long)(__brev(t) >> (32 - A.k)) : 0;
        const long long o = (C >> cols_log) * order + (C & c_mask) + (rev << cols_log);
        F2 v = {s_re[s], s_im[s]};
        if (A.scaled) v = vpt::mul2(v, {A.s_re, A.s_im});
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
    const u64* w;        // twiddles, element strides (w_plane, w_term)
    const u64* r;        // the challenge, plane stride r_plane
    u64* out;            // (2, R, 2^half_log) contiguous
    i64 w_plane, w_term, r_plane;
    long long R;
    int half_log;
};

__global__ void __launch_bounds__(THREADS) gf_fri_fold(FoldArgs A) {
    const long long half = 1ll << A.half_log;
    const long long plane = A.R * half;
    const F2 r = {A.r[0], A.r[A.r_plane]};
    const i64 hb = half * A.rows.term;
    for (long long row = blockIdx.y; row < A.R; row += gridDim.y) {
        const u64* cw = A.cw + row_offset(A.rows, (unsigned)row);
        for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < half;
             i += (long long)gridDim.x * THREADS) {
            const u64* p = cw + i * A.rows.term;
            const F2 a = {p[0], p[A.rows.plane]};
            const F2 b = {p[hb], p[hb + A.rows.plane]};
            const F2 w = {A.w[i * A.w_term], A.w[i * A.w_term + A.w_plane]};
            const F2 d = vpt::mul2(vpt::mul2(vpt::sub2(a, b), w), r);
            const F2 v = vpt::add2(vpt::add2(a, b), d);
            A.out[row * half + i] = vpt::mulp(v.re, INV2);
            A.out[plane + row * half + i] = vpt::mulp(v.im, INV2);
        }
    }
}

Rows rows_of(int d0, int d1, int d2, long long s0, long long s1, long long s2,
             long long plane, long long term) {
    return {{(unsigned)d0, (unsigned)d1, (unsigned)d2}, {s0, s1, s2}, plane, term};
}

}  // namespace

// out (2, R, 2^log_order) = the FFT of the (2, R, 2^lg_coef) coefficient
// rows `in` (lead sizes d0 d1 d2 = R, element strides s0 s1 s2, plane and
// last-axis strides) at the root whose powers tw (2, 2^(log_order-1))
// holds, times (s_re, s_im) if scaled.  ceil(lg_coef / TILE_LOG) launches
// (one for lg_coef = 0), through tmp (out's shape) when more than one;
// none for R = 0.
extern "C" int vpt_gf_fft(const u64* in, int d0, int d1, int d2, long long s0,
                          long long s1, long long s2, long long plane, long long term,
                          const u64* tw, u64* out, u64* tmp, int lg_coef, int log_order,
                          int scaled, u64 s_re, u64 s_im, void* stream_ptr) {
    const long long R = (long long)d0 * d1 * d2;
    if (R <= 0) return 0;
    if (lg_coef < 0 || lg_coef > log_order || log_order > MAX_LOG)
        return (int)cudaErrorInvalidValue;
    const int n = lg_coef ? (lg_coef + TILE_LOG - 1) / TILE_LOG : 1;
    if (n > 1 && !tmp) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    FftArgs A = {in, rows_of(d0, d1, d2, s0, s1, s2, plane, term), tw, nullptr, R,
                 log_order, 0, lg_coef - 1, 0, lg_coef, 0, s_re, s_im};
    for (int i = 0; i < n; ++i) {
        A.k = lg_coef / n + (i < lg_coef % n);
        A.out = (n - 1 - i) % 2 == 0 ? out : tmp;     // the last launch writes out
        A.scaled = scaled && i == n - 1;
        const long long cols = R << (log_order - A.k);
        A.g = A.k < BLOCK_LOG ? BLOCK_LOG - A.k : 0;
        while (A.g > 0 && (1ll << (A.g - 1)) >= cols) --A.g;
        const long long blocks = (cols + (1ll << A.g) - 1) >> A.g;
        if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
        const size_t smem = 2 * sizeof(u64) << (A.k + A.g);
        gf_fft_tile<<<(unsigned)blocks, THREADS, smem, stream>>>(A);
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

// out (2, R, 2^half_log) = one FRI fold of the codeword rows cw (lead
// sizes d0 d1 d2 = R, element strides, plane and last-axis strides; 2^(half_log
// + 1) entries a row) with the twiddles w (element strides w_plane, w_term)
// and the challenge r (plane stride r_plane).  One launch, none for an
// empty output.
extern "C" int vpt_gf_fri_fold(const u64* cw, int d0, int d1, int d2, long long s0,
                               long long s1, long long s2, long long plane,
                               long long term, const u64* w, long long w_plane,
                               long long w_term, const u64* r, long long r_plane,
                               u64* out, int half_log, void* stream_ptr) {
    const long long R = (long long)d0 * d1 * d2;
    if (R <= 0) return 0;
    if (half_log < 0 || half_log > MAX_LOG) return (int)cudaErrorInvalidValue;
    const FoldArgs A = {cw, rows_of(d0, d1, d2, s0, s1, s2, plane, term), w, r, out,
                        w_plane, w_term, r_plane, R, half_log};
    const long long x = ((1ll << half_log) + THREADS - 1) / THREADS;
    const dim3 grid((unsigned)(x < MAX_BLOCKS ? x : MAX_BLOCKS),
                    (unsigned)(R < MAX_ROW_BLOCKS ? R : MAX_ROW_BLOCKS));
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    gf_fri_fold<<<grid, THREADS, 0, stream>>>(A);
    return (int)cudaGetLastError();
}
