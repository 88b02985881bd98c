// X1: a whole circuit evaluation on Hopper (sm_90a): gf_evaluate.
//
// Replaces X1, which is no Pallas kernel: the JAX package's evaluate
// (virgo_plus_tpu/circuits/compile.py:185-207) zero-fills the values
// buffer, copies the inputs in, and for each layer gathers its left and
// right inputs, computes A*x + B*y + C*(x*y) + D with its gf ops and
// writes the layer's block; XLA fuses each layer into one loop inside the
// jit.  Written as one launch a layer (gf_eval_layer, beside a zero fill
// and an input copy) a randomize(14, 13) evaluation was 15 launches; here
// it is one.
//
// What a call computes.  values is (2, R, T) int64 planes (R rows of one
// circuit's T values; R = 1 for one prove, B for a batch), written whole:
//   step 0 (the input copy): values[r, g] = inputs[r, g] for g < n_in, 0
//   up to the input block's padded size;
//   each layer step, for each row r and gate g < size:
//     x = values[r, x_off + x_idx[g]], y = values[r, y_idx[g]],
//     values[r, out_off + g] = add(add(mul(A, x), mul(B, y)),
//                                  add(mul(C, mul(x, y)), D)),
//   A-D the gate's words in co (4, 2, gates) at the layer's first gate g0,
//   in that order of operations; the words from out_off + size up to
//   out_off + padded are 0.
// The steps' blocks tile [0, T), so every word of every row is written
// once and the buffer comes from torch.empty.  A step reads only words of
// earlier steps' blocks of its own row.
//
// Bits.  The field steps are gf_int64.cuh's, the int64 steps of gf.py's
// plain ops, so the result equals the plain twin's on any input.  A
// product by a coefficient of two zero words is (0, 0) whatever the other
// factor (mymult(0, v) = 0 for every v), so it is skipped (gate_value):
// an add gate (C = 0) makes its two products A x and B y, a mul gate
// (A = B = 0) its x y and C (x y), and a warp of both kinds two rounds.
//
// Design: thread-block clusters.  Rows are independent, and a layer
// depends only on earlier layers of its row.  So a cluster of blocks owns
// a group of whole rows and runs a range of steps in one launch; between
// two steps, cg::this_cluster().sync() (barrier.cluster arrive.release /
// wait.acquire) makes the step's global writes visible to the cluster's
// threads, where a launch boundary did before.  No two clusters share a
// row, so no barrier spans the grid.  A thread takes one gate of a step
// at a time, loads its coefficients and indices once (its first gate's
// before the barrier: they read only the plan) and loops over the group's
// rows.
//
// The launch shape (circuits/compile.py eval_launches).  A step's gates
// are compute: a product is three 64-bit multiplies and the int64 steps'
// reductions, hundreds of issue slots, so a row's step wants many SMs.
// The cluster size (1 to CLUSTER = 16 blocks, non-portable above 8) is
// the one whose row groups carry the fewest rows a block, the groups as
// many as fit on the card at once (cudaOccupancyMaxActiveClusters,
// queried once a device and size): on an H100 16 blocks at 1 to 16 rows
// (one cluster a row at 1 to 4; 16 SMs issue a step of 8,192 gates) and
// 2 at 64 (a cluster a row on 128 SMs).
// Consecutive steps share a launch while each step's gate-rows a thread
// (padded * rows a group / (blocks a cluster * THREADS)) stay at most
// EVAL_WORK = 16, and at most MAX_LAYERS steps.  A step above that bound
// gets a launch of its own, over a grid that spans the card (its gates
// split over blocks, clusters of one block, no barrier): one kernel, two
// launch shapes.  randomize(14, 13) is one launch at 1 to 64 rows (1 to
// 8 gate-rows a thread); a layer of 2^18 gates at one row (32) is a launch
// of its own, so a very wide layer is not left to 16 SMs.  Everything
// comes by pointer or by value (the steps in the launch's
// __grid_constant__ arguments), and the kernel allocates nothing: a CUDA
// graph captures the launch.
//
// What bounds it: bytes, by the bound's count.  The inputs and the plan
// read once (a gate's 64 coefficient and 8 index bytes), every word
// written once: at one row of randomize(14, 13) ~9.6 MB, ~2.9 us at 3.35
// TB/s (its products and sums, counted as 12 32-bit operations a word,
// take less).  On the card a step is issue-bound (the products' int64
// steps) and, at one row, a chain: a dependent gather, the products, a
// cluster barrier.
//
// Why CUDA and not Triton: exact 64-bit wrap-around and signed and
// unsigned shifts on the same words, cluster barriers, and kernels.py's
// loader and launch counting.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "gf_int64.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace vpt64;

constexpr int THREADS = 512;
constexpr int CLUSTER = 16;       // most blocks a cluster
constexpr int MAX_LAYERS = 32;    // steps a launch
constexpr int COPY = -1;          // a step's size: the input copy
constexpr int SIZES = 5;          // cluster sizes 1, 2, 4, 8, 16

// one step of a launch, as the plan's host table holds it (int64 each)
struct Step {
    i64 g0;        // its first gate in the flat plan
    i64 size;      // gates, or COPY
    i64 x_off;     // the left inputs' block
    i64 out_off;   // its block
    i64 padded;    // its block's words
};

struct EvalArgs {
    u64* values;              // (2, rows, total)
    const u64* inputs;        // (2, rows, n_in): strides in_plane, in_row, 1
    const int* __restrict__ xi;   // (gates,) left input, in the x_off block
    const int* __restrict__ yi;   // (gates,) right input, in the row
    const u64* __restrict__ co;   // (4, 2, gates)
    i64 plane, total, gates, in_plane, in_row, n_in;
    int rows, rows_per_group, gate_split, count;
    Step L[MAX_LAYERS];
};

// a gate's coefficients and its inputs' positions in a row
struct Gate {
    E a, b, c, d;
    i64 x, y;
};

// element i of the plan's (2, plane) read-only words (the non-coherent
// path: the kernel never writes the plan)
__device__ __forceinline__ E ldg(const u64* p, i64 plane, i64 i) {
    return {__ldg(p + i), __ldg(p + plane + i)};
}

// the words of gate g of step S (none past its size)
__device__ __forceinline__ Gate gate(const EvalArgs& A, const Step& S, i64 g) {
    Gate G = {{0, 0}, {0, 0}, {0, 0}, {0, 0}, 0, 0};
    if (g < S.size) {
        const i64 f = S.g0 + g;
        G.a = ldg(A.co, A.gates, f);
        G.b = ldg(A.co + 2 * A.gates, A.gates, f);
        G.c = ldg(A.co + 4 * A.gates, A.gates, f);
        G.d = ldg(A.co + 6 * A.gates, A.gates, f);
        G.x = S.x_off + __ldg(A.xi + f);
        G.y = __ldg(A.yi + f);
    }
    return G;
}

__device__ __forceinline__ bool nonzero(E c) { return (c.re | c.im) != 0; }

// A x + B y + C (x y) + D in the twin's order of gf_int64.cuh's steps.
// A product by a coefficient (0, 0) is (0, 0) whatever the other factor
// (mymult(0, v) = 0 for every v), so only the gate's other products are
// made, as a list that a round of the warp takes one of: A x, B y, then
// x y and C (x y), those whose coefficient is not (0, 0).  An add gate
// (C = 0) and a mul gate (A = B = 0) each need two, so a warp of both
// kinds makes two rounds, not four.
__device__ __forceinline__ E gate_value(const Gate& G, E x, E y) {
    const int na = nonzero(G.a), nb = nonzero(G.b), nc = nonzero(G.c);
    const int m = na + nb, n = m + 2 * nc;
    E p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        p[k] = E{0, 0};
        if (k < n) {
            const bool first = k == 0 && na;
            const E s = k < m ? (first ? G.a : G.b) : k == m ? x : G.c;
            const E t = k < m ? (first ? x : y) : k == m ? y : p[k > 0 ? k - 1 : 0];
            p[k] = mul(s, t);
        }
    }
    const E zero = {0, 0};
    const E ax = na ? p[0] : zero;
    const E by = nb ? (na ? p[1] : p[0]) : zero;
    const E cxy = nc ? (m == 0 ? p[1] : m == 1 ? p[2] : p[3]) : zero;
    return add(add(ax, by), add(cxy, G.d));
}

__global__ void __launch_bounds__(THREADS, 1) gf_evaluate_kernel(const __grid_constant__ EvalArgs A) {
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks();
    const int c = blockIdx.x / cs;
    const int group = c / A.gate_split, part = c - group * A.gate_split;
    const i64 step = (i64)A.gate_split * cs * THREADS;
    const i64 t0 = ((i64)part * cs + (int)cluster.block_rank()) * THREADS + threadIdx.x;
    const int r0 = group * A.rows_per_group;
    const int r1 = min(A.rows, r0 + A.rows_per_group);
    for (int l = 0; l < A.count; ++l) {
        const Step& S = A.L[l];
        Gate G = gate(A, S, t0);
        if (l) cluster.sync();
        if (S.size == COPY) {
            for (i64 g = t0; g < S.padded; g += step)
                for (int r = r0; r < r1; ++r) {
                    const u64* in = A.inputs + r * A.in_row + g;
                    const E v = g < A.n_in ? E{in[0], in[A.in_plane]} : E{0, 0};
                    store(A.values + r * A.total, A.plane, S.out_off + g, v);
                }
            continue;
        }
        for (i64 g = t0; g < S.padded; g += step) {
            if (g != t0) G = gate(A, S, g);
            for (int r = r0; r < r1; ++r) {
                u64* row = A.values + r * A.total;
                if (g < S.size) {
                    const E x = load(row, A.plane, G.x), y = load(row, A.plane, G.y);
                    store(row, A.plane, S.out_off + g, gate_value(G, x, y));
                } else {
                    store(row, A.plane, S.out_off + g, E{0, 0});
                }
            }
        }
    }
}

}  // namespace

// The clusters of `cluster` blocks (1, 2, 4, 8 or 16) that fit on the
// current device at once, into *out: 0 when the card takes no such
// cluster; the error when the query fails.  Above 8 blocks a cluster is
// non-portable: the query sets the kernel's attribute that allows it (a
// card that refuses the attribute fits none), so a launch of 16-block
// clusters comes after this query of them.  The wrapper
// (circuits/compile.py _fits) asks once a device and keeps the answers.
extern "C" int vpt_gf_evaluate_clusters(int cluster, int* out) {
    int k = 0;
    while (k < SIZES && (1 << k) != cluster) ++k;
    if (k == SIZES || cluster > CLUSTER) return (int)cudaErrorInvalidValue;
    *out = 0;
    if (cluster > 8 && cudaFuncSetAttribute(
            (void*)gf_evaluate_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
            1) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3(THREADS);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(out, (void*)gf_evaluate_kernel, &cfg);
    if (err != cudaSuccess && cluster > 8) {
        cudaGetLastError();   // a refused non-portable size: none fit
        *out = 0;
        return 0;
    }
    return (int)err;
}

// values (2, rows, total) = steps [0, count) of the host table `steps`
// ((count, 5) int64: g0, size or COPY, x_off, out_off, padded) for every
// row, from inputs (2, rows, n_in; strides in_plane, in_row, 1) and the
// flat plan xi, yi (gates,), co (4, 2, gates).  One launch of groups *
// gate_split clusters of `cluster` blocks (gate_split > 1: one step over
// gate_split clusters of one block), rows_per_group rows a group; the
// caller picks a shape that fits (vpt_gf_evaluate_clusters), and a launch
// the card refuses returns its error.
extern "C" int vpt_gf_evaluate(u64* values, const u64* inputs, long long in_plane,
                               long long in_row, long long n_in, int rows, long long total,
                               const int* xi, const int* yi, const u64* co, long long gates,
                               const long long* steps, int count, int cluster, int groups,
                               int rows_per_group, int gate_split, void* stream_ptr) {
    if (rows <= 0 || count <= 0) return 0;
    if (count > MAX_LAYERS || groups <= 0 || rows_per_group <= 0 || gate_split <= 0
        || (gate_split > 1 && (cluster != 1 || count != 1))
        || (long long)groups * rows_per_group < rows
        || (long long)groups * gate_split * cluster >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    EvalArgs A = {values, inputs, xi, yi, co, (i64)rows * total, total, gates, in_plane,
                  in_row, n_in, rows, rows_per_group, gate_split, count, {}};
    for (int l = 0; l < count; ++l) {
        const long long* s = steps + 5 * l;
        A.L[l] = {s[0], s[1], s[2], s[3], s[4]};
        if (s[1] < COPY || s[1] > s[4] || s[3] < 0 || s[3] + s[4] > total)
            return (int)cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(groups * gate_split * cluster));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, gf_evaluate_kernel, A);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
