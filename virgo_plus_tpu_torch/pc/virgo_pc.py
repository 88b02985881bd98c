"""Virgo polynomial commitment (VPD), prover side.

Counterpart of ``virgo_plus_tpu/pc/virgo_pc.py`` (reference
lib/virgo/src/poly_commit.h, fri.cpp, vpd_prover.cpp).  Codewords stay in
natural (2, 65, N) layout; a Merkle leaf j hashes the (j, j+N/2) value pairs
of all 65 slices as a 65-step SHA3 chain (fri.cpp:96-124), which here is
one launch of K2's chain kernel over every leaf at once, and the trees are
one launch of its forest kernel.  Fold step
(fri.cpp:315-334):
    next[i] = 1/2 * ((v[i] + v[i+N/2]) + r * rou^{-i} * (v[i] - v[i+N/2])).
Slice 64 is the reference's single zero mask slice, hashed into every chain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

from .. import kernels
from ..field import gf
from ..gkr.beta import beta_table
from .fft import FFT_AXES, fft, ifft, powers
from . import merkle
from .keccak import sha3_chain_x64

LOG_SLICE = 6
SLICES = 1 << LOG_SLICE       # 64 real slices (+1 mask)
RATE = 5                      # RS code rate 1/32
LDT_REPEATS = 33


def _chain_inputs(codeword):
    """(2, ..., 65, N) -> (65, 4, ..., N/2): [x.real, x.img, y.real, y.img]
    per slice with x = v[j], y = v[j + N/2]; the middle axes (a batch of
    codewords) stay between the word axis and the leaf axis."""
    half = codeword.shape[-1] // 2
    x = codeword[..., :half].movedim(-2, 1)
    y = codeword[..., half:].movedim(-2, 1)
    return torch.stack([x[0], x[1], y[0], y[1]], dim=1)


def leaf_chain_hash(codeword):
    """codeword: (2, ..., 65, N) natural layout -> (4, ..., N/2) leaf
    digests: the 65-step SHA3 chain, state <- H(slice words || state) from
    zero; every leaf of a batch in one chain call."""
    xs = _chain_inputs(codeword)
    return sha3_chain_x64(xs.reshape(xs.shape[0], 4, -1)).reshape(
        xs.shape[1:])


def _slice_encode(values, bl: int):
    """The commit FFT pipeline (poly_commit.h:75-110): split 2^bl values
    into 64 slices, IFFT each to coefficients, FFT onto the 32x domain.
    values: (2, ..., 2^bl) -> ((2, ..., 65, 2^(bl-1)), coefs (2, ..., 64,
    srec)); slice 64 (mask) is zero."""
    srec = 1 << (bl - LOG_SLICE)
    lg_ss = bl + RATE - LOG_SLICE
    ss = 1 << lg_ss
    lead = values.shape[1:-1]
    rou_small = gf.root_of_unity_int(bl - LOG_SLICE)
    rou_big = gf.root_of_unity_int(lg_ss)
    coefs = ifft(values.reshape((2,) + lead + (SLICES, srec)), rou_small)
    evals = fft(coefs, lg_ss, rou_big)
    mask = torch.zeros((2,) + lead + (1, ss), dtype=torch.int64,
                       device=values.device)
    return torch.cat([evals, mask], dim=-2), coefs


@dataclass
class Oracle:
    """One oracle, or a batch of them (the middle axes, as in the
    codeword); the root is tree[..., 1]."""
    codeword: torch.Tensor       # (2, ..., 65, N) natural layout
    leaves: torch.Tensor         # (4, ..., N/2)
    tree: torch.Tensor           # (4, ..., N)


def _trees(heaps, lead):
    """A batch's heaps [(4, N)] side by side -> (4, *lead, N); one heap is
    returned as it is."""
    if not lead:
        return heaps[0]
    return torch.stack(heaps, dim=1).reshape((4,) + lead + (-1,))


def make_oracle(codeword) -> Oracle:
    return make_oracles_batched([codeword])[0]


def make_oracles_batched(codewords) -> List[Oracle]:
    """Hash many oracles together: all leaf chains (of every codeword and
    every instance of a batch) concatenate along the leaf axis into one
    65-step chain, and all trees build as one forest.  Bit-identical to
    make_oracle per codeword."""
    parts = [_chain_inputs(cw) for cw in codewords]
    parts = [p.reshape(p.shape[0], 4, -1) for p in parts]
    lead = codewords[0].shape[1:-2]
    halves = [cw.shape[-1] // 2 for cw in codewords]
    all_leaves = sha3_chain_x64(parts[0] if len(parts) == 1
                                else torch.cat(parts, dim=2))
    nb = math.prod(lead)
    trees = merkle.forest(all_leaves, [h for h in halves for _ in range(nb)])
    out = []
    off = 0
    for k, (cw, h) in enumerate(zip(codewords, halves)):
        leaves = all_leaves[:, off:off + nb * h].reshape((4,) + lead + (h,))
        off += nb * h
        out.append(Oracle(codeword=cw, leaves=leaves,
                          tree=_trees(trees[k * nb:(k + 1) * nb], lead)))
    return out


def commit_private(values, bl: int):
    """poly_commit.h:41-124 + fri::request_init_commit(bl, 0).
    Returns (Oracle, l_coefs) — root is oracle.tree[:, 1]."""
    l_eval, l_coefs = _slice_encode(values, bl)
    return make_oracle(l_eval), l_coefs


def q_tables(final_point, bl: int):
    """The q side of the opening at final_point (verifier.cpp:348-361):
    q_values, the beta table (2, 2^bl), and its per-slice IFFT
    coefficients (2, SLICES, 2^(bl - LOG_SLICE))."""
    q_values = beta_table(final_point, bl, gf.ones((), final_point.device))
    srec_lg = bl - LOG_SLICE
    return q_values, ifft(q_values.reshape(2, SLICES, 1 << srec_lg),
                          gf.root_of_unity_int(srec_lg))


def commit_public_eval(l_eval, q_values, bl: int):
    """poly_commit.h:126-349 compute half (no hashing).  Returns
    (h_codeword (2,65,ss), q_eval, q_coefs, all_sum (2,65),
    virtual_oracle (2,65,ss)).  A batch of l codewords (2, ..., 65, ss)
    shares q_values (2, 2^bl) and gives h, all_sum and the virtual oracle
    with the same middle axes."""
    dev = l_eval.device
    srec = 1 << (bl - LOG_SLICE)
    lg_ss = bl + RATE - LOG_SLICE
    ss = 1 << lg_ss
    lead = l_eval.shape[1:-2]
    q_eval, q_coefs = _slice_encode(q_values, bl)

    # per-slice product polynomial: sample l*q on the 2*srec subgroup
    stride = ss // (2 * srec)
    lq = gf.mul(l_eval[..., :SLICES, ::stride], q_eval[:, :SLICES, ::stride])
    lq_coef = ifft(lq, gf.root_of_unity_int(bl - LOG_SLICE + 1))
    h_coef = lq_coef[..., srec:]
    h_eval = fft(h_coef, lg_ss, gf.root_of_unity_int(lg_ss))

    # all_sum[i] = (lq_coef[0] + h_coef[0]) * srec  (poly_commit.h:323)
    c0 = gf.add(lq_coef[..., 0], h_coef[..., 0])        # (2, ..., 64)
    srec_el = gf.full((1,), srec % gf.MOD, 0, dev)
    all_sum = torch.cat([gf.mul(c0, srec_el),
                         torch.zeros((2,) + lead + (1,), dtype=torch.int64,
                                     device=dev)],
                        dim=-1)                         # mask slice: 0

    # virtual oracle (poly_commit.h:294-318):
    #   vo[j] = (l*q[j] - (x^srec - 1)*h[j] - c0) * srec * rou^{-j}
    rou_int = gf.root_of_unity_int(lg_ss)
    xn = powers(gf.pow_int(rou_int, srec), ss, dev)     # rou^(srec*j)
    inv_x = powers(gf.inv_int(rou_int), ss, dev)        # rou^{-j}
    one = gf.ones((1,), dev)
    lq_full = gf.mul(l_eval[..., :SLICES, :], q_eval[:, :SLICES])
    g = gf.sub(lq_full, gf.mul(gf.sub(xn, one)[:, None, :], h_eval))
    vo = gf.mul(gf.mul(gf.sub(g, c0[..., None]), srec_el[:, :, None]),
                inv_x[:, None, :])
    zero_slice = torch.zeros((2,) + lead + (1, ss), dtype=torch.int64,
                             device=dev)
    vo = torch.cat([vo, zero_slice], dim=-2)
    h_full = torch.cat([h_eval, zero_slice], dim=-2)
    return h_full, q_eval, q_coefs, all_sum, vo


def commit_public(l_eval, q_values, bl: int):
    """commit_public_eval + the h-oracle hash (poly_commit.h:342)."""
    h_full, q_eval, q_coefs, all_sum, vo = commit_public_eval(
        l_eval, q_values, bl)
    return make_oracle(h_full), q_eval, q_coefs, all_sum, vo


def fold_step(codeword, r, lg_n: int):
    """One FRI fold (fri.cpp:315-334): codeword (2, ..., 65, N) -> (2, ...,
    65, N/2).  r: (2,) challenge, shared by a batch; rou of order N fixed
    by lg_n.  Two launches on the card: the twiddles' table and gf_fri_fold."""
    inv_mu = powers(gf.inv_int(gf.root_of_unity_int(lg_n)), (1 << lg_n) // 2,
                    codeword.device)
    return fold_pairs(codeword, inv_mu, r)


def fold_pairs(codeword, w, r):
    """out[..., i] = ((a + b) + (a - b)·w[i]·r) / 2 with a = codeword[...,
    i], b = codeword[..., i + N/2]: w (2, N/2), r (2,).  A CUDA tensor goes
    to gf_fri_fold (``csrc/gf_fft.cu``), a CPU tensor to fold_step_plain."""
    fn = fold_step_cuda if gf._on_cuda(codeword) else fold_step_plain
    return fn(codeword, w, r)


def fold_step_plain(codeword, w, r):
    """Plain twin of gf_fri_fold, on gf's plain ops."""
    kernels.PLAIN_CALLS["gf_fri_fold"] += 1
    half = codeword.shape[-1] // 2
    a = codeword[..., :half]
    b = codeword[..., half:]
    s = gf.add_plain(a, b)
    d = gf.mul_plain(gf.mul_plain(gf.sub_plain(a, b), w[:, None, :]),
                     r[:, None, None])
    inv2 = gf.inv_int((2, 0))
    return gf.mul_plain(gf.add_plain(s, d),
                        gf.full((1, 1), inv2[0], inv2[1], codeword.device))


def fold_step_cuda(codeword, w, r):
    """gf_fri_fold on the card, one launch: same signature and bits as
    fold_step_plain on canonical inputs."""
    if codeword.device.type != "cuda" or w.device != codeword.device or \
            r.device != codeword.device:
        raise ValueError("gf_fri_fold: codeword, w and r must be on one CUDA "
                         "device")
    if any(t.dtype != torch.int64 for t in (codeword, w, r)):
        raise TypeError("gf_fri_fold: expected int64 tensors")
    n = codeword.shape[-1] if codeword.dim() >= 2 else 0
    half_log = max(n // 2, 1).bit_length() - 1
    if codeword.shape[0] != 2 or n < 2 or n != 2 << half_log:
        raise ValueError(f"gf_fri_fold: codeword {tuple(codeword.shape)}, "
                         f"(2, ..., N) with N a power of two >= 2 taken")
    if tuple(w.shape) != (2, n // 2) or tuple(r.shape) != (2,):
        raise ValueError(f"gf_fri_fold: w {tuple(w.shape)}, r "
                         f"{tuple(r.shape)} against N = {n}")
    sizes, strides = kernels.row_layout("gf_fri_fold", codeword, FFT_AXES)
    out = torch.empty(tuple(codeword.shape[:-1]) + (n // 2,),
                      dtype=torch.int64, device=codeword.device)
    if out.numel():
        kernels.check_int("gf_fri_fold", rows=out.numel() // n)
        kernels.launch("gf_fri_fold", 1, codeword.data_ptr(), *sizes,
                       *strides, codeword.stride(0), codeword.stride(-1),
                       w.data_ptr(), w.stride(0), w.stride(1), r.data_ptr(),
                       r.stride(0), out.data_ptr(), half_log,
                       kernels.stream_ptr())
    return out


@dataclass
class LDTCommitment:
    oracles: List[Oracle]        # one per fold step
    randomness: List[torch.Tensor]
    final_codeword: torch.Tensor  # (2, 65, 2^RATE) last level codeword


def fold_codewords(vo, bl: int, randomness: List):
    """All LDT fold-level codewords (no hashing): vo folded until each
    slice is 2^RATE (vpd_verifier.cpp:44-74)."""
    lg = bl + RATE - LOG_SLICE
    cur = vo
    cws = []
    for r in randomness:
        cur = fold_step(cur, r, lg)
        lg -= 1
        cws.append(cur)
    assert cur.shape[-1] == 1 << RATE
    return cws


def commit_phase(vo, bl: int, randomness: List) -> LDTCommitment:
    """vpd_verifier.cpp:44-74: fold the virtual oracle, then hash every
    level's leaf chains and trees together."""
    cws = fold_codewords(vo, bl, randomness)
    return LDTCommitment(oracles=make_oracles_batched(cws),
                         randomness=list(randomness), final_codeword=cws[-1])
