"""SHA3-256 on 64-byte blocks (kernel K2) and its plain PyTorch twin.

Counterpart of ``virgo_plus_tpu/pc/keccak.py``.  The reference hashes exactly
64-byte blocks with XKCP's SHA3_256 (lib/virgo/src/my_hhash.h:27-33): absorb
8 words, pad 0x06 at byte 64 and 0x80 at byte 135, one Keccak-f[1600],
squeeze 4 words.  ``sha3_256_x64`` (one hash per message) and
``sha3_chain_x64`` (the fused leaf chain) send CUDA tensors to the
hand-written kernels of K2 (``csrc/keccak.cu``) and CPU tensors to their
plain twins, which keep the state as a (25, N) int64 tensor, one column per
message.  The Merkle forest, K2's third entry, is wrapped in ``merkle.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64).view(np.int64)

# rotation offsets r[x][y], flat state index = x + 5*y
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

# rho+pi as one permutation: b[y + 5*((2x+3y)%5)] = rotl(a[x+5y], ROT[x][y])
_PERM_SRC = np.zeros(25, dtype=np.int64)
_PERM_ROT = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _j = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PERM_SRC[_j] = _x + 5 * _y
        _PERM_ROT[_j] = _ROT[_x][_y]

_PAD_HI = int(np.array([0x80 << 56], dtype=np.uint64).view(np.int64)[0])


def _rotl(x, r):
    """64-bit rotate left of int64 bit patterns; r: int or per-row tensor
    of amounts in [0, 64)."""
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def _round(a, rc: int, src, rot):
    """One Keccak round; a: (25, N) int64."""
    n = a.shape[1]
    A = a.reshape(5, 5, n)                       # [y, x]
    c = A[0] ^ A[1] ^ A[2] ^ A[3] ^ A[4]         # (5, N) indexed by x
    d = torch.roll(c, 1, 0) ^ _rotl(torch.roll(c, -1, 0), 1)
    a = a ^ d.repeat(5, 1)                       # row i gets d[i % 5]
    b = _rotl(a[src], rot)                       # rho + pi
    B = b.reshape(5, 5, n)
    chi = b ^ (~torch.roll(B, -1, 1).reshape(25, n)
               & torch.roll(B, -2, 1).reshape(25, n))
    chi[0] ^= rc
    return chi


def keccak_f(state):
    """state: (25, N) int64 -> (25, N)."""
    src = torch.from_numpy(_PERM_SRC).to(state.device)
    rot = torch.from_numpy(_PERM_ROT).to(state.device)[:, None]
    for rc in _RC:
        state = _round(state, int(rc), src, rot)
    return state


def sha3_256_x64_plain(words):
    """Plain twin of K2: (8, N) int64 LE words -> (4, N) digest words."""
    kernels.PLAIN_CALLS["sha3_256_x64"] += 1
    n = words.shape[1]
    state = torch.zeros((25, n), dtype=torch.int64, device=words.device)
    state[:8] = words
    state[8] = 0x06                   # pad (byte 64)
    state[16] = _PAD_HI               # 0x80 at byte 135
    return keccak_f(state)[:4]


def sha3_256_x64_cuda(words):
    """K2 on the card: same signature and bits as sha3_256_x64_plain."""
    n = words.shape[1]
    kernels.check_cuda("sha3_256_x64", (words,), [(8, n)])
    kernels.check_int("sha3_256_x64", messages=n)
    out = torch.empty((4, n), dtype=torch.int64, device=words.device)
    if n:
        kernels.launch("sha3_256_x64", 1, words.data_ptr(), out.data_ptr(), n,
                       kernels.stream_ptr())
    return out


def sha3_chain_x64_plain(xs):
    """Plain twin of the fused leaf chain: xs (S, 4, L) slice words ->
    (4, L); state <- SHA3-256(xs[s] || state) for s = 0..S-1, from zero."""
    kernels.PLAIN_CALLS["sha3_chain_x64"] += 1
    state = torch.zeros((4, xs.shape[2]), dtype=torch.int64, device=xs.device)
    for s in range(xs.shape[0]):
        state = sha3_256_x64_plain(torch.cat([xs[s], state], dim=0))
    return state


def sha3_chain_x64_cuda(xs):
    """The fused leaf chain on the card, one launch: same signature and
    bits as sha3_chain_x64_plain."""
    steps, _, n = xs.shape
    kernels.check_cuda("sha3_chain_x64", (xs,), [(steps, 4, n)])
    kernels.check_int("sha3_chain_x64", steps=steps, leaves=n)
    out = torch.empty((4, n), dtype=torch.int64, device=xs.device)
    if n:
        kernels.launch("sha3_chain_x64", 1, xs.data_ptr(), out.data_ptr(),
                       steps, n, kernels.stream_ptr())
    return out


def on_cuda(x, what: str) -> bool:
    """True for a CUDA tensor (its kernel runs), False for a CPU tensor (its
    plain twin runs); any other device raises."""
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"no {what} for device {x.device}")


def sha3_256_x64(words):
    """SHA3-256 of 64-byte messages given as (8, N) int64 words (LE).
    Returns (4, N) digest words."""
    if on_cuda(words, "SHA3 kernel"):
        return sha3_256_x64_cuda(words.contiguous())
    return sha3_256_x64_plain(words)


def sha3_chain_x64(xs):
    """The SHA3 chain of every leaf: xs (S, 4, L) -> (4, L) digests."""
    if on_cuda(xs, "SHA3 chain kernel"):
        return sha3_chain_x64_cuda(xs.contiguous())
    return sha3_chain_x64_plain(xs)


def digest_to_bytes(d):
    """(4,) digest words -> 32 bytes (host-side): u64 words, or a port
    tensor of int64 words with the same bits."""
    w = d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else d
    return b"".join((int(x) % 2 ** 64).to_bytes(8, "little") for x in w)
