// The lane-pair Keccak-f[1600] of K2 (csrc/keccak.cu), shared with the
// Fiat-Shamir sponge kernels (csrc/fs_rounds.cu): one SHA3-256 state split
// over a lane pair in bit-interleaved form, and the single-block SHA3-256 of
// 64-byte messages on it.  Every lane of the warp takes part in each call
// (the odd rotations are shuffles of the full warp).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

// ---- the bit-interleaved permutation on two lanes --------------------------
//
// Lane pair (lane, lane ^ 1) holds one state: role 0 the even bits of every
// 64-bit word, role 1 the odd bits, each as a 32-bit word.  XOR, AND and NOT
// act on each half alone; a rotation by an even amount 2k is a 32-bit
// rotation by k of each half; one by an odd amount 2k + 1 swaps the halves:
// the even half becomes the partner's odd half rotated by k + 1, the odd
// half the partner's even half rotated by k.  So each lane runs half of the
// logic, plus one shuffle per odd rotation (5 in theta, 12 in rho).

typedef unsigned int u32;

// RC split into even and odd bits
__constant__ u32 RC_EVEN[24] = {
    0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0x00000001u,
    0x00000001u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000001u, 0x00000000u,
    0x00000001u, 0x00000001u, 0x00000001u, 0x00000001u, 0x00000000u, 0x00000000u,
    0x00000000u, 0x00000000u, 0x00000001u, 0x00000000u, 0x00000001u, 0x00000000u,
};
__constant__ u32 RC_ODD[24] = {
    0x00000000u, 0x00000089u, 0x8000008Bu, 0x80008080u, 0x0000008Bu, 0x00008000u,
    0x80008088u, 0x80000082u, 0x0000000Bu, 0x0000000Au, 0x00008082u, 0x00008003u,
    0x0000808Bu, 0x8000000Bu, 0x8000008Au, 0x80000081u, 0x80000081u, 0x80000008u,
    0x00000083u, 0x80008003u, 0x80008088u, 0x80000088u, 0x00008000u, 0x80008082u,
};

// rotation of a 64-bit word by R, on this lane's half; odd_extra = 1 - role
template <int R>
__device__ __forceinline__ u32 rot_half(u32 x, int odd_extra) {
    if constexpr (R % 2 == 0) {
        return __funnelshift_l(x, x, R / 2);
    } else {
        const u32 p = __shfl_xor_sync(0xffffffffu, x, 1);
        return __funnelshift_l(p, p, (R - 1) / 2 + odd_extra);
    }
}

__device__ __forceinline__ void keccak_f_pair(u32 s[25], int role) {
    const int e = 1 - role;
#pragma unroll 4
    for (int round = 0; round < 24; ++round) {
        u32 c[5], d[5];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rot_half<1>(c[(x + 1) % 5], e);
#pragma unroll
        for (int i = 0; i < 25; ++i) s[i] ^= d[i % 5];
        u32 b[25];
        b[0] = s[0];
        b[1] = rot_half<44>(s[6], e);
        b[2] = rot_half<43>(s[12], e);
        b[3] = rot_half<21>(s[18], e);
        b[4] = rot_half<14>(s[24], e);
        b[5] = rot_half<28>(s[3], e);
        b[6] = rot_half<20>(s[9], e);
        b[7] = rot_half<3>(s[10], e);
        b[8] = rot_half<45>(s[16], e);
        b[9] = rot_half<61>(s[22], e);
        b[10] = rot_half<1>(s[1], e);
        b[11] = rot_half<6>(s[7], e);
        b[12] = rot_half<25>(s[13], e);
        b[13] = rot_half<8>(s[19], e);
        b[14] = rot_half<18>(s[20], e);
        b[15] = rot_half<27>(s[4], e);
        b[16] = rot_half<36>(s[5], e);
        b[17] = rot_half<10>(s[11], e);
        b[18] = rot_half<15>(s[17], e);
        b[19] = rot_half<56>(s[23], e);
        b[20] = rot_half<62>(s[2], e);
        b[21] = rot_half<55>(s[8], e);
        b[22] = rot_half<39>(s[14], e);
        b[23] = rot_half<41>(s[15], e);
        b[24] = rot_half<2>(s[21], e);
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x)
                s[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        s[0] ^= role ? RC_ODD[round] : RC_EVEN[round];
    }
}

// even bits of x to the low 16, odd bits to the high 16 (and back)
__device__ __forceinline__ u32 unshuffle32(u32 x) {
    u32 t;
    t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
    t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
    t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
    t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
    return x;
}

__device__ __forceinline__ u32 shuffle32(u32 x) {
    u32 t;
    t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
    t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
    t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
    t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
    return x;
}

// this lane's half (role 0: even bits, role 1: odd bits) of a 64-bit word
__device__ __forceinline__ u32 half_of(u64 w, int role) {
    const u32 lo = unshuffle32((u32)w);
    const u32 hi = unshuffle32((u32)(w >> 32));
    return role ? (lo >> 16) | (hi & 0xFFFF0000u) : (lo & 0xFFFFu) | (hi << 16);
}

__device__ __forceinline__ u64 join_halves(u32 even, u32 odd) {
    const u32 lo = shuffle32((even & 0xFFFFu) | (odd << 16));
    const u32 hi = shuffle32((even >> 16) | (odd & 0xFFFF0000u));
    return (u64)lo | ((u64)hi << 32);
}

// s[0..7] hold this lane's halves of the 8 message words: pad and permute;
// the digest is s[0..3]
__device__ __forceinline__ void sha3_64_pair(u32 s[25], int role) {
    s[8] = role ? 0x1u : 0x2u;  // 0x06 at byte 64
#pragma unroll
    for (int w = 9; w < 25; ++w) s[w] = 0u;
    s[16] = role ? 0x80000000u : 0u;  // 0x80 at byte 135
    keccak_f_pair(s, role);
}

}  // namespace
