// X1: the public commit's virtual oracle on Hopper (sm_90a):
// pc_virtual_oracle, the aggregated oracle and the h codeword in one pass.
//
// Replaces X1, which is no Pallas kernel: in the JAX package's
// commit_public_eval (virgo_plus_tpu/pc/virgo_pc.py:142-186, the virtual
// oracle at :172-185) XLA fuses the oracle's products, sums and power
// tables and the two mask-slice concatenations into a few loops inside the
// commit's jit.  Written as field ops it was 13 launches (4 gf_mul, 3
// gf_lin, 2 gf_table power tables, 2 fills and 2 whole-codeword copies),
// about nine passes over (2, ..., 64, ss) words where one does.
//
// What a call computes.  For instance b of the lead axes, slice s < 64 and
// column j < L: with lq = l[b, s, j] q[s, j] and h = h[b, s, j],
//   vo[b, s, j] = ((lq - xn1[j] h) - c0[b, s]) srec inv_x[j],
//   h_full[b, s, j] = h,
// and vo[b, 64, j] = h_full[b, 64, j] = 0 (the mask slice), in the JAX
// package's order of operations (g = lq - (x^n - 1) h, then (g - c0) srec
// inv_x).  l (2, ..., 65, L) is read in place (its 64 data slices), q (2,
// Q, L), Q >= 64, is shared by a batch, and the tables xn1 = x^srec - 1 and
// inv_x = x^-1 (2, L) at the columns' points x are made once per (root,
// order, columns, device) by virgo_pc.oracle_tables and kept; a sharded
// rank passes its own columns' tables.
//
// Bits.  gf_int64.cuh's steps, the plain ops' int64 steps, so vo and h_full
// equal the plain twin's (virgo_pc.virtual_oracle_plain) on any input.
//
// Design.  Elementwise: a grid-stride loop over the outputs' (2, ..., 65,
// L) elements in order, a thread an element, consecutive threads on
// consecutive words of each plane; a thread reads its l, q, h, c0 and two
// table words and writes its vo and h_full words (zeros on the mask slice).
// q and the tables are read once per instance and stay in L2 across a
// batch.  No host copy, so a CUDA graph captures the launch.
//
// What bounds it: bytes.  At B instances of 64 x L columns it reads l and h
// (32 B an element), q and the tables (once, 64 B a column) and writes 32 B
// an element: at B = 64, L = 4096 ~1.08 GB, ~0.32 ms at 3.35 TB/s; four
// products and two sums an element (~0.05 ms of 32-bit issue).
//
// Why CUDA and not Triton: exact 64-bit wrap-around and signed and
// unsigned shifts on the same words (gf_int64.cuh), and kernels.py's
// loader and launch counting.
#include <cuda_runtime.h>
#include <stdint.h>
#include "gf_int64.cuh"

namespace {

using namespace vpt64;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int SLICES = 64;             // data slices; slice 64 is the mask

__global__ void __launch_bounds__(THREADS)
pc_virtual_oracle_kernel(const u64* __restrict__ l, i64 l_plane, const u64* __restrict__ q,
                         i64 q_plane, const u64* __restrict__ h, i64 h_plane,
                         const u64* __restrict__ c0, i64 c0_plane, const u64* __restrict__ xn1,
                         const u64* __restrict__ inv_x, u64 srec, u64* __restrict__ vo,
                         u64* __restrict__ h_full, i64 items, int lg_len) {
    const i64 len = (i64)1 << lg_len;
    const E srec_el = {srec, 0};
    const E zero = {0, 0};
    for (i64 i = (i64)blockIdx.x * THREADS + threadIdx.x; i < items;
         i += (i64)gridDim.x * THREADS) {
        const i64 j = i & (len - 1), row = i >> lg_len;
        const i64 inst = row / (SLICES + 1);
        const int s = (int)(row - inst * (SLICES + 1));
        if (s == SLICES) {
            store(vo, items, i, zero);
            store(h_full, items, i, zero);
            continue;
        }
        const i64 hrow = inst * SLICES + s;
        const E hv = load(h, h_plane, (hrow << lg_len) + j);
        const E lq = mul(load(l, l_plane, i), load(q, q_plane, ((i64)s << lg_len) + j));
        const E g = sub(lq, mul(load(xn1, len, j), hv));
        store(vo, items, i,
              mul(mul(sub(g, load(c0, c0_plane, hrow)), srec_el), load(inv_x, len, j)));
        store(h_full, items, i, hv);
    }
}

}  // namespace

// vo and h_full (2, B, 65, 2^lg_len), items = B 65 2^lg_len elements a
// plane, from l (2, B, 65, 2^lg_len), q (2, Q, 2^lg_len), h (2, B, 64,
// 2^lg_len), c0 (2, B, 64), all contiguous (their plane strides given),
// the tables (2, 2^lg_len) and srec by value.  One launch, none for no
// element.
extern "C" int vpt_pc_virtual_oracle(const u64* l, i64 l_plane, const u64* q, i64 q_plane,
                                     const u64* h, i64 h_plane, const u64* c0, i64 c0_plane,
                                     const u64* xn1, const u64* inv_x, u64 srec, u64* vo,
                                     u64* h_full, i64 items, int lg_len, void* stream_ptr) {
    if (items <= 0) return 0;
    if (lg_len < 0 || lg_len > 40) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    const i64 want = (items + THREADS - 1) / THREADS;
    const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
    pc_virtual_oracle_kernel<<<blocks, THREADS, 0, stream>>>(l, l_plane, q, q_plane, h, h_plane, c0, c0_plane, xn1, inv_x, srec, vo, h_full, items, lg_len);
    return (int)cudaGetLastError();
}
