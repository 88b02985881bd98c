// X1: one layer of circuit evaluation on Hopper (sm_90a): gf_eval_layer.
//
// Replaces X1, which is no Pallas kernel: the JAX package's evaluate
// (virgo_plus_tpu/circuits/compile.py:185-207) gathers each layer's left
// and right inputs, computes A*x + B*y + C*(x*y) + D with its gf ops and
// writes the layer's block, and XLA fuses that into one loop inside the
// jit.  Written as field ops, a layer was two gathers, 4 gf_mul, 3 gf_lin
// and a slice copy; here it is one launch.
//
// What a call computes.  values is (2, R, T) int64 planes (R rows of one
// circuit's T values; R = 1 for one prove, B for a batch).  For each row r
// and gate g < size of the layer:
//   x = values[r, x_off + x_idx[g]], y = values[r, y_idx[g]],
//   values[r, out_off + g] = add(add(mul(A, x), mul(B, y)),
//                                add(mul(C, mul(x, y)), D)),
// A-D the gate's words in co (4, 2, size), in that order of operations,
// in place.  The layer's padding (out_off + size up to the next power of
// two) is not written.  The inputs come from earlier layers' blocks, so no
// word a launch reads is one it writes; the launch boundary is the barrier
// between layers.
//
// Bits.  The field steps are gf_int64.cuh's, the int64 steps of gf.py's
// plain ops, so the result equals the plain twin's (and the gf_mul /
// gf_lin chain it replaces) on any input.
//
// Design.  A thread a gate: it loads the gate's eight coefficient words
// and two indices once, then loops over its block's rows, so a batch
// reads the circuit's words once; consecutive threads write consecutive
// words of each row.  With many rows, blockIdx.y splits them so that the
// grid fills the card.  Everything comes by pointer or by value, and the
// kernel allocates nothing: a CUDA graph captures the launch.
//
// What bounds it: bytes.  A gate's 64 coefficient and 16 index bytes once,
// then per row the gathered x and y (32 bytes, L2-resident for a gate's
// neighbours) and the 16 written: at one row and 8,192 gates ~1 MB, ~0.3
// us at 3.35 TB/s, below a launch.  The 4 products and 3 sums a row
// (about 84 32-bit operations) are a fraction of that.
//
// Why CUDA and not Triton: exact 64-bit wrap-around and signed and
// unsigned shifts on the same words, and kernels.py's loader and launch
// counting.
#include <cuda_runtime.h>
#include <stdint.h>
#include "gf_int64.cuh"

namespace {

using namespace vpt64;

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 2;   // blocks the row split aims for

__global__ void __launch_bounds__(THREADS)
gf_eval_layer_kernel(u64* values, i64 plane, i64 total, int rows, int rows_per_block,
                     const i64* __restrict__ x_idx, const i64* __restrict__ y_idx,
                     const u64* __restrict__ co, int size, i64 x_off, i64 out_off) {
    const int g = blockIdx.x * THREADS + threadIdx.x;
    if (g >= size) return;
    const E A = load(co, size, g), B = load(co + 2 * (i64)size, size, g);
    const E C = load(co + 4 * (i64)size, size, g), D = load(co + 6 * (i64)size, size, g);
    const i64 xi = x_off + x_idx[g], yi = y_idx[g], oi = out_off + g;
    const int r0 = blockIdx.y * rows_per_block;
    const int r1 = min(rows, r0 + rows_per_block);
    for (int r = r0; r < r1; ++r) {
        u64* row = values + r * total;
        const E x = load(row, plane, xi), y = load(row, plane, yi);
        store(row, plane, oi, add(add(mul(A, x), mul(B, y)), add(mul(C, mul(x, y)), D)));
    }
}

}  // namespace

// values (2, rows, total) in place: the layer's `size` gates at out_off of
// each row from the words at x_off + x_idx and y_idx; co (4, 2, size).
// One launch, none for an empty layer or no rows.
extern "C" int vpt_gf_eval_layer(u64* values, int rows, i64 total, const i64* x_idx,
                                 const i64* y_idx, const u64* co, int size, i64 x_off,
                                 i64 out_off, void* stream_ptr) {
    if (size <= 0 || rows <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const int bx = (size + THREADS - 1) / THREADS;
    // rows a block: as few as keep about TARGET_BLOCKS blocks in the grid
    const int want = (TARGET_BLOCKS + bx - 1) / bx;
    const int split = want < rows ? want : rows;
    const int per = (rows + split - 1) / split;
    const dim3 grid(bx, (rows + per - 1) / per);
    gf_eval_layer_kernel<<<grid, THREADS, 0, stream>>>(
        values, (i64)rows * total, total, rows, per, x_idx, y_idx, co, size, x_off, out_off);
    return (int)cudaGetLastError();
}
