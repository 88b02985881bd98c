"""Sharded polynomial commitment: codewords strided over the sp ranks.

Counterpart of ``virgo_plus_tpu/parallel/pc_sharded.py``.  Codeword
position p lives on rank p mod S, at local position p // S.  Then:

* **Encode**: rank q computes X[t·S + q] = FFT_L(c_n · w^(q·n)), a local
  FFT of order L = N/S of coset-twiddled coefficients.  The coefficients
  are 32x smaller than the codeword, so every rank computes all of them.
* **FRI folds**: the pair (i, i + N/2) has one residue mod S, so every fold
  is local, down to the last level.
* **Leaf chains**: leaf j hashes the pairs (j, j + N/2) of all 65 slices,
  also local: one ``sha3_chain_x64`` launch per rank and oracle build.
* **Merkle tree**: the leaf digests are gathered over sp and rank q keeps
  the contiguous leaves [q·half, (q+1)·half) (what the JAX package's
  all_to_all delivers); one ``merkle_forest`` launch builds its subtree;
  the S subtree roots are gathered, and every rank hashes the top log S
  levels (``sha3_256_x64``, one call a level).  A tree with fewer than S
  leaves a rank (``ShardedOracle.tiny``) is built whole on every rank from
  the gathered leaves, in that forest launch.

Field arithmetic is exact, so the twiddle products regroup without a
change of bits: roots and codewords equal the single-device ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gf
from ..pc import merkle, virgo_pc
from ..pc.fft import fft, ifft, powers
from ..pc.keccak import sha3_256_x64
from ..pc.virgo_pc import LOG_SLICE, RATE, SLICES
from .mesh import Mesh
from .sharded_queries import ShardedOracle


def _coset_fft(coefs, lg_n: int, mesh: Mesh):
    """Rank q's strided evaluations X[t·S + q], t < 2^lg_n / S, of coefs
    (2, ..., m) on the 2^lg_n domain: FFT_L(c_n · (w^q)^n), w of order
    2^lg_n."""
    S, q = mesh.sp, mesh.sp_rank
    rou = gf.root_of_unity_int(lg_n)
    tw = powers(gf.pow_int(rou, q), coefs.shape[-1], coefs.device)
    return fft(gf.mul(coefs, tw[:, None, :]), lg_n - (S.bit_length() - 1),
               gf.pow_int(rou, S))


def _local_powers(base_int, n_local: int, mesh: Mesh, device):
    """base^p at this rank's local positions p = t·S + q, t < n_local."""
    step = powers(gf.pow_int(base_int, mesh.sp), n_local, device)
    r, i = gf.pow_int(base_int, mesh.sp_rank)
    return gf.mul(step, gf.full((1,), r, i, device))


def _with_mask_slice(x):
    """(2, 64, L) -> (2, 65, L): the zero mask slice appended."""
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)


def sharded_oracle_trees(cws, mesh: Mesh):
    """This rank's strided codewords [(2, 65, L)] -> [ShardedOracle]: one
    chain launch for every leaf of every codeword, one gather of the leaf
    digests, one forest launch for the rank's subtrees (and the tiny trees
    whole), one gather of the subtree roots and log S hashes of the tops."""
    S, q = mesh.sp, mesh.sp_rank
    halves = [cw.shape[-1] // 2 for cw in cws]    # local leaves each
    leaves = virgo_pc.sha3_chain_x64(torch.cat(
        [virgo_pc._chain_inputs(cw) for cw in cws], dim=2))
    gathered = mesh.all_gather(leaves)                 # (S, 4, sum(halves))
    blocks, sizes, off = [], [], 0
    for half in halves:
        # natural leaf t·S + q' is gathered[q', :, t]
        full = gathered[:, :, off:off + half].permute(1, 2, 0).reshape(4, -1)
        off += half
        if half < S:                                   # tiny: whole tree
            blocks.append(full)
        else:
            blocks.append(full[:, q * half:(q + 1) * half])
        sizes.append(blocks[-1].shape[1])
    heaps = merkle.forest(torch.cat(blocks, dim=1), sizes)
    big = [k for k, half in enumerate(halves) if half >= S]
    tops = {}
    if big:
        lvl = mesh.all_gather(torch.stack([heaps[k][:, 1] for k in big], 1))
        lvl = lvl.permute(1, 2, 0)                     # (4, n_big, S)
        levels = [lvl]
        while lvl.shape[-1] > 1:
            n = lvl.shape[-1] // 2
            lvl = sha3_256_x64(torch.cat([lvl[..., 0::2], lvl[..., 1::2]])
                               .reshape(8, -1)).reshape(4, -1, n)
            levels.append(lvl)
        for j, k in enumerate(big):
            tops[k] = merkle._heap([x[:, j] for x in levels])
    return [ShardedOracle(cw=cw, sub=heaps[k] if k in tops else None,
                          top=tops.get(k, heaps[k]), n=2 * half * S, S=S,
                          q=q)
            for k, (cw, half) in enumerate(zip(cws, halves))]


def sharded_oracle_tree(cw, mesh: Mesh) -> ShardedOracle:
    return sharded_oracle_trees([cw], mesh)[0]


def sharded_commit_private(mesh: Mesh, bl: int):
    """Returns fn(values (2, 2^bl), the same on every rank) -> the
    ShardedOracle of the input codeword (root = .root)."""
    lg_ss = bl + RATE - LOG_SLICE
    srec = 1 << (bl - LOG_SLICE)
    if (1 << lg_ss) // mesh.sp < 2:
        raise ValueError(f"2^{lg_ss} positions do not spread over "
                         f"{mesh.sp} ranks")
    rou_small = gf.root_of_unity_int(bl - LOG_SLICE)

    def run(values):
        coefs = ifft(values.reshape(2, SLICES, srec), rou_small)
        return sharded_oracle_tree(
            _with_mask_slice(_coset_fft(coefs, lg_ss, mesh)), mesh)

    return run


def sharded_commit_public(mesh: Mesh, bl: int):
    """poly_commit.h:126-349 on strided codewords.  Returns fn(l_local
    (2, 65, L) this rank's block of the input codeword, q_values (2, 2^bl)
    the same on every rank) -> (h ShardedOracle, all_sum (2, 65), vo_local
    (2, 65, L)).  The l·q samples on the 2·srec subgroup sit at global
    stride 2^(RATE-1), all on rank 0 when S <= 2^(RATE-1)."""
    S = mesh.sp
    if S > 1 << (RATE - 1):
        raise ValueError(f"S = {S}: the l·q subsample must sit on rank 0")
    lg_ss = bl + RATE - LOG_SLICE
    srec = 1 << (bl - LOG_SLICE)
    st_local = (1 << (RATE - 1)) // S
    rou_small = gf.root_of_unity_int(bl - LOG_SLICE)
    rou_2s = gf.root_of_unity_int(bl - LOG_SLICE + 1)

    def run(l_local, q_values):
        dev = l_local.device
        L = l_local.shape[-1]
        q_coefs = ifft(q_values.reshape(2, SLICES, srec), rou_small)
        q_local = _coset_fft(q_coefs, lg_ss, mesh)          # (2, 64, L)
        lq = gf.mul(l_local[:, :SLICES, ::st_local], q_local[:, :, ::st_local])
        if mesh.sp_rank:
            lq = torch.zeros_like(lq)
        lq_coef = ifft(mesh.all_sum(lq), rou_2s)            # rank 0's
        h_coef = lq_coef[..., srec:]
        c0 = gf.add(lq_coef[..., 0], h_coef[..., 0])        # (2, 64)
        srec_el = gf.full((1,), srec % gf.MOD, 0, dev)
        all_sum = torch.cat([gf.mul(c0, srec_el), gf.zeros((1,), dev)], 1)
        h_local = _coset_fft(h_coef, lg_ss, mesh)
        # vo[p] = (l·q[p] - (x^srec - 1)·h[p] - c0)·srec·rou^(-p) at this
        # rank's columns p = t·S + q, with the mask slices
        xn1, inv_x = virgo_pc.oracle_tables(lg_ss, srec, L, dev, S,
                                            mesh.sp_rank)
        vo, h_full = virgo_pc.virtual_oracle(l_local, q_local, h_local, c0,
                                             srec, xn1, inv_x)
        return sharded_oracle_tree(h_full, mesh), all_sum, vo

    return run


def sharded_fold_step(cw_local, r, lg_n: int, mesh: Mesh):
    """One FRI fold (fri.cpp:315-334) of this rank's block of a 2^lg_n
    codeword, no communication: global pair (t·S + q, t·S + q + N/2) is
    the local pair (t, t + L/2), and the output's local position t is
    global position t·S + q of the halved codeword."""
    inv_mu = _local_powers(gf.inv_int(gf.root_of_unity_int(lg_n)),
                           cw_local.shape[-1] // 2, mesh, cw_local.device)
    return virgo_pc.fold_pairs(cw_local, inv_mu, r)


def gather_strided(cw_local, mesh: Mesh):
    """This rank's (2, 65, L) block -> the (2, 65, S·L) shard-major
    codeword (rank q's block at [q·L, (q+1)·L)), on every rank."""
    return torch.cat(list(mesh.all_gather(cw_local)), dim=-1)


def unstride(cw_strided, S: int) -> np.ndarray:
    """(2, 65, N) shard-major codeword (numpy) -> natural position order."""
    cw = np.asarray(cw_strided)
    L = cw.shape[2] // S
    out = np.empty_like(cw)
    for q in range(S):
        out[:, :, q::S] = cw[:, :, q * L:(q + 1) * L]
    return out


def sharded_pc_prove(mesh: Mesh, bl: int):
    """The whole sharded PC prove: private commit, public commit and every
    LDT fold level.  Returns fn(values (2, 2^bl), q_values (2, 2^bl),
    randomness [(2,)]) -> dict(l, h: ShardedOracle, all_sum (2, 65),
    levels: [ShardedOracle]) with every codeword and tree left sharded;
    the level oracles are hashed together, one chain and one forest launch
    (as virgo_pc.commit_phase)."""
    commit = sharded_commit_private(mesh, bl)
    public = sharded_commit_public(mesh, bl)
    lg = bl + RATE - LOG_SLICE

    def run(values, q_values, randomness):
        l_oracle = commit(values)
        h_oracle, all_sum, vo = public(l_oracle.cw, q_values)
        cws, cur = [], vo
        for k, r in enumerate(randomness):
            cur = sharded_fold_step(cur, r, lg - k, mesh)
            cws.append(cur)
        return dict(l=l_oracle, h=h_oracle, all_sum=all_sum,
                    levels=sharded_oracle_trees(cws, mesh))

    return run
