// K2: SHA3-256 of N independent 64-byte messages on Hopper (sm_90a).
//
// Replaces the TPU kernel virgo_plus_tpu/pallas_kernels/keccak_chain.py
// (_call :100, body _kernel :85 with _keccak_f :55, entry
// sha3_256_x64_pallas :116).  Same function as the plain twin
// virgo_plus_tpu_torch/pc/keccak.py:sha3_256_x64_plain: absorb the 8
// little-endian message words, pad 0x06 at byte 64 and 0x80 at byte 135,
// run one Keccak-f[1600], squeeze 4 words.
//
// What is dropped from the TPU design: the (lo, hi) u32 pairs of every
// 64-bit lane, which exist because Mosaic has no 64-bit integers.  Here one
// thread hashes one message; its 25-word state stays in registers as
// uint64_t, the 24 rounds are unrolled, and every rotate has a compile-time
// amount.
//
// Bound on the H100: 96 bytes of memory traffic per message (8 words in, 4
// out, each coalesced across the warp: word w of message i sits at w*N + i)
// against about 24 * 160 64-bit logical operations, so the kernel is bound by
// the integer/logic issue rate, not by memory.  At the main path's widths
// (a few thousand messages per call) one launch fills only part of the card;
// fusing the 65-step leaf chain into one launch is the planned redesign.
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

__constant__ u64 RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

template <int R>
__device__ __forceinline__ u64 rotl(u64 x) {
    if constexpr (R == 0) {
        return x;
    } else {
        return (x << R) | (x >> (64 - R));
    }
}

// state index x + 5*y, as in the SHA3 lane order
__device__ __forceinline__ void keccak_f(u64 s[25]) {
#pragma unroll
    for (int round = 0; round < 24; ++round) {
        // theta
        u64 c[5], d[5];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
        for (int i = 0; i < 25; ++i) s[i] ^= d[i % 5];
        // rho + pi: b[y + 5*((2x+3y)%5)] = rotl(s[x+5y], r[x][y])
        u64 b[25];
        b[0] = rotl<0>(s[0]);
        b[1] = rotl<44>(s[6]);
        b[2] = rotl<43>(s[12]);
        b[3] = rotl<21>(s[18]);
        b[4] = rotl<14>(s[24]);
        b[5] = rotl<28>(s[3]);
        b[6] = rotl<20>(s[9]);
        b[7] = rotl<3>(s[10]);
        b[8] = rotl<45>(s[16]);
        b[9] = rotl<61>(s[22]);
        b[10] = rotl<1>(s[1]);
        b[11] = rotl<6>(s[7]);
        b[12] = rotl<25>(s[13]);
        b[13] = rotl<8>(s[19]);
        b[14] = rotl<18>(s[20]);
        b[15] = rotl<27>(s[4]);
        b[16] = rotl<36>(s[5]);
        b[17] = rotl<10>(s[11]);
        b[18] = rotl<15>(s[17]);
        b[19] = rotl<56>(s[23]);
        b[20] = rotl<62>(s[2]);
        b[21] = rotl<55>(s[8]);
        b[22] = rotl<39>(s[14]);
        b[23] = rotl<41>(s[15]);
        b[24] = rotl<2>(s[21]);
        // chi
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x)
                s[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        // iota
        s[0] ^= RC[round];
    }
}

// in: (8, n) message words; out: (4, n) digest words
__global__ void sha3_256_x64(const u64* __restrict__ in, u64* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 s[25];
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] = in[(size_t)w * n + i];
    s[8] = 0x06ull;
#pragma unroll
    for (int w = 9; w < 25; ++w) s[w] = 0ull;
    s[16] = 0x8000000000000000ull;
    keccak_f(s);
#pragma unroll
    for (int w = 0; w < 4; ++w) out[(size_t)w * n + i] = s[w];
}

}  // namespace

extern "C" int vpt_sha3_256_x64(const u64* in, u64* out, int n, void* stream_ptr) {
    if (n <= 0) return 0;
    cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
    constexpr int T = 128;
    sha3_256_x64<<<(n + T - 1) / T, T, 0, stream>>>(in, out, n);
    return (int)cudaGetLastError();
}
