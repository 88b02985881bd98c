// K2: SHA3-256 of 64-byte messages on Hopper (sm_90a): single hashes, the
// fused leaf chain, and the Merkle forest.
//
// Replaces the TPU kernel virgo_plus_tpu/pallas_kernels/keccak_chain.py
// (_call :100, body _kernel :85 with _keccak_f :55, entry
// sha3_256_x64_pallas :116), which hashes one step per call: every step of
// the 65-hash leaf chains (virgo_pc.py:120-124) and every Merkle level is a
// call of its own there.  Every hash is the function of the plain twin
// virgo_plus_tpu_torch/pc/keccak.py:sha3_256_x64_plain: absorb the 8
// little-endian message words, pad 0x06 at byte 64 and 0x80 at byte 135,
// run one Keccak-f[1600], squeeze 4 words.
//
// What is dropped from the TPU design: the (lo, hi) u32 pairs of every
// 64-bit lane, which exist because Mosaic has no 64-bit integers.  Here a
// state stays in registers, split over a lane pair in bit-interleaved form
// (keccak_f_pair below), and every rotate has a compile-time amount.
//
// What bounds it on the H100: 96 bytes of memory traffic per hash against
// about 4320 32-bit logic and shift operations, so operations bound it, not
// memory.  At the main path's widths (about 6000 leaves) one thread per
// hash fills less than half a warp per scheduler, so a chain or a tree
// level is bound by the latency of one Keccak-f, and a launch per step or
// level would cost more than the step.  So a lane pair runs each
// permutation, which halves the instructions on its critical path, and
// three entries share it:
// - sha3_256_x64: N independent messages, one launch (the TPU kernel's
//   direct counterpart);
// - sha3_chain_x64: all S steps of every leaf chain in one launch, the
//   chain state in registers between steps (state <- H(xs[s] || state) from
//   zero); the next step's words are loaded before the current permutation
//   runs;
// - merkle_forest: every level of every tree of a forest in one launch.  A
//   block builds a subtree of up to 2^sub_log leaves (pc/merkle.py's
//   FOREST_SUB_LOG) level by level,
//   straight in the tree's heap, with a barrier between levels; the last
//   block of a tree to finish its subtree (a device-scope fence, then an
//   atomic ticket) builds the levels above the subtree roots.  Small
//   subtrees spread the wide bottom levels over many SMs; only the top
//   levels, a few hashes each, run in one block.
#include "keccak.cuh"

namespace {

// The digest in s[0..3] to out[w * stride + idx], if `write`: role 0 writes
// words 0 and 1, role 1 words 2 and 3.  Every lane must take part.
__device__ __forceinline__ void store_digest(const u32 s[25], int role, u64* out,
                                             size_t stride, size_t idx, bool write) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        const u32 p = __shfl_xor_sync(0xffffffffu, s[w], 1);
        if (write && w / 2 == role)
            out[w * stride + idx] = role ? join_halves(p, s[w]) : join_halves(s[w], p);
    }
}

// in: (8, n) message words; out: (4, n) digest words.  Two lanes a message;
// lanes past the last message shadow it, since every lane of a warp takes
// part in the shuffles.
__global__ void sha3_256_x64(const u64* __restrict__ in, u64* __restrict__ out, int n) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int role = t & 1;
    const size_t msg = t >> 1;
    const size_t i = msg < (size_t)n ? msg : n - 1;
    u32 s[25];
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] = half_of(in[w * (size_t)n + i], role);
    sha3_64_pair(s, role);
    store_digest(s, role, out, n, msg, msg < (size_t)n);
}

// xs: (steps, 4, n) slice words; out: (4, n) final chain states.  Two lanes
// a leaf, shadowing as in sha3_256_x64.
__global__ void sha3_chain_x64(const u64* __restrict__ xs, u64* __restrict__ out,
                               int steps, int n) {
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int role = t & 1;
    const size_t leaf = t >> 1;
    const size_t i = leaf < (size_t)n ? leaf : n - 1;
    const size_t step = 4 * (size_t)n;
    u32 s[25] = {};
    u32 nxt[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) nxt[w] = steps > 0 ? half_of(xs[w * (size_t)n + i], role) : 0u;
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            s[4 + w] = s[w];  // the chain state after the slice words
            s[w] = nxt[w];
        }
        if (k + 1 < steps) {
            const u64* src = xs + (size_t)(k + 1) * step + i;
#pragma unroll
            for (int w = 0; w < 4; ++w) nxt[w] = half_of(src[w * (size_t)n], role);
        }
        sha3_64_pair(s, role);
    }
    store_digest(s, role, out, n, leaf, leaf < (size_t)n);
}

constexpr int FOREST_THREADS = 128;
constexpr int TREE_FIELDS = 5;  // per tree: leaf offset, log2 leaves, heap offset (words
                                // from `heaps`), first block, ticket (zero on entry;
                                // the tree's last block sets it back to zero)

// heap (4, stride) word-major: node p = H(node 2p || node 2p+1), on this
// lane and its partner; only `write` pairs store it.  Reads go through L2
// (ld.global.cg): the children may come from another block.
__device__ __forceinline__ void hash_node(u64* heap, size_t stride, size_t p, int role,
                                          bool write) {
    u32 s[25];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        s[w] = half_of(__ldcg(heap + w * stride + 2 * p), role);
        s[4 + w] = half_of(__ldcg(heap + w * stride + 2 * p + 1), role);
    }
    sha3_64_pair(s, role);
    store_digest(s, role, heap, stride, p, write);
}

// Nodes [first, first + cnt) of one level, a lane pair each; pairs past the
// end repeat the last node without storing it, since every lane takes part
// in the shuffles.
__device__ __forceinline__ void hash_level(u64* heap, size_t stride, size_t first, size_t cnt) {
    for (size_t base = 0; base < cnt; base += FOREST_THREADS / 2) {
        const size_t i = base + (threadIdx.x >> 1);
        hash_node(heap, stride, first + (i < cnt ? i : cnt - 1), threadIdx.x & 1, i < cnt);
    }
}

// leaves: (4, total) leaf digests of all trees side by side; trees:
// (n_trees, TREE_FIELDS).  Tree t of n = 2^lg leaves gets its heap (4, 2n)
// at heaps + its heap offset: node 0 = 0, root at 1, leaves at [n, 2n).
// The table holds no address and its tickets end at zero, so one table
// serves every call on the same tree sizes, and a captured graph replays it.
__global__ void __launch_bounds__(FOREST_THREADS) merkle_forest(
        const u64* __restrict__ leaves, long long total, long long* trees, u64* heaps,
        int n_trees, int sub_log) {
    __shared__ int last;
    int t = 0;
    while (t + 1 < n_trees && trees[(t + 1) * TREE_FIELDS + 3] <= blockIdx.x) ++t;
    long long* row = trees + t * TREE_FIELDS;
    const int lg = (int)row[1];
    const int slg = lg < sub_log ? lg : sub_log;
    const size_t n = (size_t)1 << lg;
    const size_t S = (size_t)1 << slg;         // leaves of this block's subtree
    const size_t nsub = n >> slg;
    const size_t sb = blockIdx.x - (size_t)row[3];
    u64* heap = heaps + row[2];
    const size_t stride = 2 * n;

    const u64* src = leaves + row[0] + sb * S;
    for (size_t i = threadIdx.x; i < S; i += FOREST_THREADS) {
#pragma unroll
        for (int w = 0; w < 4; ++w) heap[w * stride + n + sb * S + i] = src[w * total + i];
    }
    if (sb == 0 && threadIdx.x < 4) heap[threadIdx.x * stride] = 0ull;
    __syncthreads();
    for (int h = 1; h <= slg; ++h) {
        const size_t cnt = S >> h;
        hash_level(heap, stride, (n >> h) + sb * cnt, cnt);
        __syncthreads();
    }
    if (nsub == 1) return;

    __threadfence();  // this subtree's root before the ticket
    if (threadIdx.x == 0)
        last = atomicAdd(reinterpret_cast<unsigned long long*>(row + 4), 1ull) == nsub - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) row[4] = 0;  // every block of the tree has taken its ticket
    __threadfence();
    for (int h = slg + 1; h <= lg; ++h) {
        const size_t cnt = n >> h;  // nodes of this level, heap [cnt, 2 cnt)
        hash_level(heap, stride, cnt, cnt);
        __syncthreads();
    }
}

}  // namespace

// One launch of 2n threads.
extern "C" int vpt_sha3_256_x64(const u64* in, u64* out, int n, void* stream_ptr) {
    if (n <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    constexpr int T = 128;
    sha3_256_x64<<<(int)((2 * (long long)n + T - 1) / T), T, 0, stream>>>(in, out, n);
    return (int)cudaGetLastError();
}

// One launch of 2n threads; 64 a block, so that the few warps of a
// main-path call spread over the SMs.
extern "C" int vpt_sha3_chain_x64(const u64* xs, u64* out, int steps, int n,
                                  void* stream_ptr) {
    if (n <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    constexpr int T = 64;
    sha3_chain_x64<<<(int)((2 * (long long)n + T - 1) / T), T, 0, stream>>>(xs, out, steps, n);
    return (int)cudaGetLastError();
}

// One launch of n_blocks = sum over trees of 2^(lg - min(lg, sub_log)) blocks.
extern "C" int vpt_merkle_forest(const u64* leaves, long long total, long long* trees,
                                 u64* heaps, int n_trees, int n_blocks, int sub_log,
                                 void* stream_ptr) {
    if (n_blocks <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    merkle_forest<<<n_blocks, FOREST_THREADS, 0, stream>>>(leaves, total, trees, heaps,
                                                           n_trees, sub_log);
    return (int)cudaGetLastError();
}
