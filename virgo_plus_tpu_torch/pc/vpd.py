"""VPD opening: LDT commit phase driver, FRI query walks, and verification.

Reference: lib/virgo/src/vpd_verifier.cpp.  The prover-side
folds/commits run on device (virgo_pc.py); the query phase is host-side
control logic over tiny gathers (33 repetitions x log-many levels), using
exact python-int field arithmetic (field/ref.py) and hashlib SHA3 — the
succinct verifier is latency-bound, not throughput-bound.

Proof-size accounting replicates the reference's visited-bitmap dedup
byte-for-byte, including its quirk of resetting the counter between the l
and h initial queries so only the h bytes are charged
(vpd_verifier.cpp:152-155).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List

import numpy as np

from ..field import gf
from ..field.ref import Fq2
from . import virgo_pc
from .virgo_pc import LOG_SLICE, SLICES, RATE

def _hash64(data: bytes) -> bytes:
    assert len(data) == 64
    return hashlib.sha3_256(data).digest()


@dataclass
class OracleHost:
    """Host mirror of a committed oracle for query answering."""
    codeword: np.ndarray     # (2, 65, N) uint64
    tree: np.ndarray         # (4, 2*(N/2)) digest words
    n: int                   # N (values per slice)

    @staticmethod
    def of(oracle: virgo_pc.Oracle) -> "OracleHost":
        cw = gf.to_numpy(oracle.codeword)
        return OracleHost(codeword=cw, tree=gf.to_numpy(oracle.tree),
                          n=cw.shape[2])


class SizeAccount:
    """Replicates the reference's visited-bitmap proof-size dedup."""

    def __init__(self, bl: int, n_levels: int):
        n = 1 << (bl + RATE - LOG_SLICE)
        self.visited_init = [np.zeros(n, bool), np.zeros(n, bool)]
        self.visited_witness = [np.zeros(1 << (bl + RATE), bool),
                                np.zeros(1 << (bl + RATE), bool)]
        self.visited = [np.zeros((1 << (bl + RATE - LOG_SLICE)) * 4 *
                                 (SLICES + 1), bool)
                        for _ in range(n_levels)]

    def init_query(self, oracle_ind: int, pos: int, depth: int,
                   path_positions) -> int:
        """fri.cpp:148-205 accounting for one initial-oracle query."""
        new = 0
        vw = self.visited_witness[oracle_ind]
        for i in range(SLICES):
            for s in range(2):
                idx = pos << (LOG_SLICE + 1) | i << 1 | s
                if not vw[idx]:
                    vw[idx] = True
                    new += 16
        vi = self.visited_init[oracle_ind]
        p = path_positions
        for q in p:
            if not vi[q ^ 1]:
                new += 32
            vi[q] = True
            vi[q ^ 1] = True
        return new

    def step_query(self, lvl: int, bp: int, path_positions) -> int:
        """fri.cpp:229-287 accounting.  NB the reference's value-dedup
        check reads ``visited[lvl][mapping & ~1]`` — *codeword* interleaved
        indices — from the same array its path walk marks with *heap*
        indices (fri.cpp:254-266 vs 276-281).  When a prior path marking
        aliases one of the pair bases, the 16-byte value charge is skipped;
        we replicate the aliasing bit-for-bit."""
        v = self.visited[lvl]
        visited_element = False
        for j in range(SLICES):
            if v[bp << (LOG_SLICE + 1) | j << 1]:
                visited_element = True
        new = 0 if visited_element else 16
        for q in path_positions:
            if not v[q ^ 1]:
                new += 32
                v[q ^ 1] = True
                v[q] = True
        return new


def merkle_root_of_codeword(cw: np.ndarray) -> bytes:
    """Recompute the committed Merkle root of a (2, 65, N) codeword
    entirely host-side: the 65-step leaf chains (fri.cpp:96-124 layout —
    leaf j packs (v[s][j], v[s][j+N/2]) as a.real, a.img, b.real, b.img LE
    u64) followed by the heap tree (merkle_tree.cpp:7-51, parent =
    SHA3-256(left || right)).  Bit-identical to make_oracle's device
    pipeline; used to bind the serialized ``final_codeword`` to
    ``level_roots[-1]`` (N = 2^RATE, so 16 leaves — trivial cost)."""
    cw = np.ascontiguousarray(np.asarray(cw, dtype=np.uint64))
    half = cw.shape[2] // 2
    a, b = cw[:, :, :half], cw[:, :, half:]
    blocks = np.stack([a[0], a[1], b[0], b[1]], axis=-1)   # (65, half, 4)
    level = []
    for j in range(half):
        h = b"\x00" * 32
        for s in range(cw.shape[1]):
            h = _hash64(blocks[s, j].tobytes() + h)
        level.append(h)
    while len(level) > 1:
        level = [_hash64(level[2 * k] + level[2 * k + 1])
                 for k in range(len(level) // 2)]
    return level[0]


def _fq2_of(arr, idx=None) -> Fq2:
    a = np.asarray(arr)
    if idx is None:
        return Fq2.raw(int(a[0]), int(a[1]))
    return Fq2.raw(int(a[0, idx]), int(a[1, idx]))


def draw_positions(rng, bl: int) -> List[int]:
    """Per-repetition initial query position (vpd_verifier.cpp:120-122):
    rand() with rejection until even and >= 2^(bl - LOG_SLICE)."""
    lg0 = bl + RATE - LOG_SLICE
    pows = []
    for _ in range(virgo_pc.LDT_REPEATS):
        while True:
            p = rng.rand() % (1 << lg0)
            if not (p < (1 << (bl - LOG_SLICE)) or p % 2 == 1):
                break
        pows.append(p)
    return pows


@dataclass
class QueryAnswers:
    """The serialized content of the FRI opening (the reference's
    request_init_value_with_merkle / request_step_commit responses), stored
    as uniform arrays so the prover answers and the verifier checks all 33
    repetitions with vectorized gathers / field math.

    *_vals: (R, 65, 2, 2) u64 — [rep, slice, pair a/b, (real, img)].
    *_paths: (R, D, 4) u64 — per rep the sibling digests bottom-up followed
    by the leaf digest (fri.cpp:177-204 response layout)."""
    init_l_vals: np.ndarray
    init_l_paths: np.ndarray
    init_h_vals: np.ndarray
    init_h_paths: np.ndarray
    lvl_vals: list        # per level (R, 65, 2, 2)
    lvl_paths: list       # per level (R, D_l, 4)


def _gather_vals(cw: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """cw (2, 65, N), pos (R,) -> (R, 65, 2, 2) value pairs (pos, pos+N/2)."""
    half = cw.shape[2] // 2
    a = cw[:, :, pos]                     # (2, 65, R)
    b = cw[:, :, pos + half]
    out = np.stack([a, b], axis=3)        # (2, 65, R, 2)
    return np.ascontiguousarray(out.transpose(2, 1, 3, 0))


def _gather_paths(tree: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """tree (4, 2N), pos (R,) leaf positions -> (R, depth+1, 4): siblings
    bottom-up then the leaf digest."""
    nleaf = tree.shape[1] // 2
    depth = nleaf.bit_length() - 1
    p = nleaf + pos.astype(np.int64)
    leaf = tree[:, p]                     # (4, R)
    sibs = np.zeros((depth, 4, len(pos)), np.uint64)
    for d in range(depth):
        sibs[d] = tree[:, p ^ 1]
        p >>= 1
    out = np.concatenate([sibs, leaf[None]], axis=0)   # (depth+1, 4, R)
    return np.ascontiguousarray(out.transpose(2, 0, 1))


def answer_queries(pows: List[int], bl: int, l_host: OracleHost,
                   h_host: OracleHost,
                   level_hosts: List[OracleHost]):
    """Prover side: vectorized gathers of value pairs and Merkle paths for
    every query.  Also computes the reference's deduplicated proof size."""
    lg0 = bl + RATE - LOG_SLICE
    pows_np = np.asarray(pows, dtype=np.int64)
    p0s = pows_np // 2
    init_l_vals = _gather_vals(l_host.codeword, p0s)
    init_l_paths = _gather_paths(l_host.tree, p0s)
    init_h_vals = _gather_vals(h_host.codeword, p0s)
    init_h_paths = _gather_paths(h_host.tree, p0s)
    lvl_vals, lvl_paths = [], []
    pw = pows_np.copy()
    for lvl, host in enumerate(level_hosts):
        if lvl > 0:
            pw = pw % (1 << (lg0 - lvl))
        bps = (pw // 2) % (host.n // 2)
        lvl_vals.append(_gather_vals(host.codeword, bps))
        lvl_paths.append(_gather_paths(host.tree, bps))
    proof_size = dedup_proof_size(pows, bl, len(level_hosts))
    return QueryAnswers(init_l_vals=init_l_vals, init_l_paths=init_l_paths,
                        init_h_vals=init_h_vals, init_h_paths=init_h_paths,
                        lvl_vals=lvl_vals, lvl_paths=lvl_paths), proof_size


def dedup_proof_size(pows: List[int], bl: int, n_levels: int) -> int:
    """The reference's deduplicated opening size in bytes (positions-only
    computation; sequential by construction — the bitmaps carry state
    across repetitions exactly as fri.cpp:148-287 does)."""
    lg0 = bl + RATE - LOG_SLICE
    n_init_leaf = 1 << (lg0 - 1)
    acct = SizeAccount(bl, n_levels)
    proof_size = 0
    for pow0 in pows:
        p0 = pow0 // 2
        ppos = _path_positions(p0, n_init_leaf)
        acct.init_query(0, p0, lg0 - 1, ppos)
        proof_size += acct.init_query(1, p0, lg0 - 1, ppos)
        pw = pow0
        for lvl in range(n_levels):
            if lvl > 0:
                pw = pw % (1 << (lg0 - lvl))
            n_leaf = 1 << (lg0 - lvl - 2)
            bp = (pw // 2) % n_leaf
            proof_size += acct.step_query(lvl, bp,
                                          _path_positions(bp, n_leaf))
    return proof_size


def _leaf_digests(vals: np.ndarray) -> List[bytes]:
    """(R, 65, 2, 2) value pairs -> per-rep 65-step chain digests
    (fri.cpp:96-124).  vals[r, s].tobytes() is exactly the reference's
    64-byte block: a.real, a.img, b.real, b.img as LE u64."""
    out = []
    for r in range(vals.shape[0]):
        h = b"\x00" * 32
        vr = vals[r]
        for s in range(vr.shape[0]):
            h = _hash64(vr[s].tobytes() + h)
        out.append(h)
    return out


def _verify_paths(root: bytes, paths: np.ndarray, positions: np.ndarray,
                  vals: np.ndarray) -> bool:
    """Array form of verify_merkle_host over all repetitions."""
    leaves = _leaf_digests(vals)
    for r in range(paths.shape[0]):
        cur = paths[r, -1].tobytes()
        if cur != leaves[r]:
            return False
        pos = int(positions[r])
        for d in range(paths.shape[1] - 1):
            sib = paths[r, d].tobytes()
            cur = _hash64(sib + cur) if pos & 1 else _hash64(cur + sib)
            pos //= 2
        if cur != root:
            return False
    return True


def _comp_first(vals: np.ndarray, pair: int) -> np.ndarray:
    """(R, 65, 2, 2) -> (2, R, 65) for one pair side."""
    return np.ascontiguousarray(vals[:, :, pair, :].transpose(2, 0, 1))


def check_queries(pows: List[int], answers: QueryAnswers, bl: int,
                  level_randomness, level_roots: List[bytes],
                  q_coefs: np.ndarray, all_sum: np.ndarray, root_l: bytes,
                  root_h: bytes, final_codeword: np.ndarray):
    """Verifier side of the 33 query walks + final-codeword checks
    (vpd_verifier.cpp:101-326), consuming only serialized answers.

    All 33 repetitions x 65 slices check together per fold level with exact
    numpy u64 field math (field/np_ops.py); only the Merkle path hashing
    stays per-repetition (hashlib SHA3, C speed).

    level_randomness: (2, L) u64 array (or list of Fq2, converted);
    all_sum: (2, 65) u64 array (or list of Fq2, converted)."""
    from ..field import np_ops as fnp

    R = virgo_pc.LDT_REPEATS
    lg0 = bl + RATE - LOG_SLICE              # log initial codeword size
    srec = 1 << (bl - LOG_SLICE)
    n_levels = bl - LOG_SLICE

    if isinstance(level_randomness, list) and level_randomness and \
            isinstance(level_randomness[0], Fq2):
        level_randomness = np.array(
            [[e.real for e in level_randomness],
             [e.img for e in level_randomness]], dtype=np.uint64)
    else:
        level_randomness = np.asarray(level_randomness, dtype=np.uint64)
    if isinstance(all_sum, list):
        all_sum = np.array([[e.real for e in all_sum],
                            [e.img for e in all_sum]], dtype=np.uint64)
    else:
        all_sum = np.asarray(all_sum, dtype=np.uint64)

    q_coefs = np.asarray(q_coefs)            # (2, 64, srec)
    pows_np = np.asarray(pows, dtype=np.int64)

    inv2_int = Fq2.raw(2, 0).inv()
    inv2 = np.array([[inv2_int.real], [inv2_int.img]],
                    dtype=np.uint64)[:, :, None]          # (2, 1, 1)

    def eq(x, y):
        return (x == y).all(axis=0)

    def pow2k(x, k):
        for _ in range(k):
            x = fnp.mul(x, x)
        return x

    ok = True
    pow_ = pows_np.copy()
    for i in range(n_levels):
        lg_cur = lg0 - i
        if i > 0:
            pow_ = pow_ % (1 << lg_cur)
        rou_int = gf.root_of_unity_int(lg_cur)
        half_pow = pow_ // 2
        inv_mu = fnp.inv(fnp.pow_int(rou_int, half_pow))[:, :, None]
        r_i = level_randomness[:, i][:, None, None]        # (2, 1, 1)

        # this level's opened pairs + Merkle check
        nl_half = 1 << (lg_cur - 2)          # level-i leaves per slice tree
        bp = half_pow % nl_half
        if not _verify_paths(level_roots[i], answers.lvl_paths[i], bp,
                             answers.lvl_vals[i]):
            return False
        b0 = _comp_first(answers.lvl_vals[i], 0)           # (2, R, 65)
        b1 = _comp_first(answers.lvl_vals[i], 1)

        if i == 0:
            # initial oracle openings (both l and h at the paired points)
            s0_pow = pow_ // 2
            s1_pow = (pow_ + (1 << lg_cur)) // 2
            p0 = np.minimum(s0_pow, s1_pow)
            if not _verify_paths(root_l, answers.init_l_paths, p0,
                                 answers.init_l_vals):
                return False
            if not _verify_paths(root_h, answers.init_h_paths, p0,
                                 answers.init_h_vals):
                return False

            s0 = fnp.pow_int(rou_int, s0_pow)              # (2, R)
            s1 = fnp.pow_int(rou_int, s1_pow)

            # q(s0), q(s1) per slice; mask slice's q is identically zero
            x_pts = np.concatenate([s0, s1], axis=1)       # (2, 2R)
            q_at = fnp.horner(q_coefs, x_pts)              # (2, 2R, 64)
            z = np.zeros((2, R, 1), np.uint64)
            tst0 = np.concatenate([q_at[:, :R], z], axis=2)    # (2, R, 65)
            tst1 = np.concatenate([q_at[:, R:], z], axis=2)

            al0, al1 = (_comp_first(answers.init_l_vals, 0),
                        _comp_first(answers.init_l_vals, 1))
            ah0, ah1 = (_comp_first(answers.init_h_vals, 0),
                        _comp_first(answers.init_h_vals, 1))

            # vanishing factor: (x^srec - 1) for real slices, (x - 1) for
            # the mask slice (gap == slice size there); srec scale only on
            # real slices (vpd_verifier.cpp:206-250)
            one = fnp.ones((R, 1))
            mask_col = np.zeros((1, R, SLICES + 1), bool)
            mask_col[0, :, SLICES] = True
            x0c = s0[:, :, None]
            x1c = s1[:, :, None]
            van0 = np.where(mask_col, fnp.sub(x0c, one),
                            fnp.sub(pow2k(s0, bl - LOG_SLICE)[:, :, None],
                                    one))
            van1 = np.where(mask_col, fnp.sub(x1c, one),
                            fnp.sub(pow2k(s1, bl - LOG_SLICE)[:, :, None],
                                    one))
            srec_el = fnp.zeros((1, 1))
            srec_el[0] = srec % fnp.MOD
            scale = np.where(mask_col, fnp.ones((R, SLICES + 1)),
                             np.broadcast_to(srec_el[:, :1, :1],
                                             (2, R, SLICES + 1)))
            x0inv = fnp.inv(s0)[:, :, None]
            x1inv = fnp.inv(s1)[:, :, None]
            asum = np.broadcast_to(all_sum[:, None, :], (2, R, SLICES + 1))
            v0 = fnp.mul(fnp.sub(fnp.mul(fnp.sub(fnp.mul(al0, tst0),
                                                 fnp.mul(van0, ah0)),
                                         scale), asum), x0inv)
            v1 = fnp.mul(fnp.sub(fnp.mul(fnp.sub(fnp.mul(al1, tst1),
                                                 fnp.mul(van1, ah1)),
                                         scale), asum), x1inv)
            swap = (s0_pow > s1_pow)[None, :, None]
            v0, v1 = (np.where(swap, v1, v0), np.where(swap, v0, v1))
            p_val = fnp.add(fnp.mul(fnp.add(v0, v1), inv2),
                            fnp.mul(fnp.mul(fnp.mul(fnp.sub(v0, v1), inv2),
                                            r_i), inv_mu))
            match = eq(p_val, b0) | eq(p_val, b1)
            if not match.all():
                return False
        else:
            a0 = _comp_first(answers.lvl_vals[i - 1], 0)
            a1 = _comp_first(answers.lvl_vals[i - 1], 1)
            s_half = fnp.mul(fnp.add(a0, a1), inv2)
            d_half = fnp.mul(fnp.mul(fnp.mul(fnp.sub(a0, a1), inv2), r_i),
                             inv_mu)
            p0v = fnp.add(s_half, d_half)
            p1v = fnp.sub(s_half, d_half)
            match = (eq(p0v, b0) | eq(p0v, b1) | eq(p1v, b0) | eq(p1v, b1))
            if not match.all():
                return False

    # Bind the serialized final codeword to the commitment: its recomputed
    # leaf chains + Merkle root must equal the last committed level root.
    # The reference reads the codeword directly out of the prover's
    # committed state (vpd_verifier.cpp:311-325 reads
    # fri::cpd.rs_codeword[mx_depth-1]) so it is bound by construction; a
    # standalone proof carries it as an array, so without this check a
    # prover of a non-low-degree oracle could ship a fake constant array
    # and pass the constancy test below.
    fc = np.asarray(final_codeword)
    if n_levels > 0 and merkle_root_of_codeword(fc) != level_roots[-1]:
        return False

    # final codeword constancy (vpd_verifier.cpp:311-325): the reference
    # checks only the first 2^(RATE-1) positions per real slice, but every
    # adjacent pair of the mask slice.
    hr = 1 << (RATE - 1)
    if not (fc[:, :SLICES, :hr] == fc[:, :SLICES, :1]).all():
        return False
    if not (fc[:, SLICES, :] == fc[:, SLICES, :1]).all():
        return False
    return ok


def verify_queries(rng, bl: int, l_host: OracleHost, h_host: OracleHost,
                   level_hosts: List[OracleHost], level_randomness,
                   level_roots: List[bytes], q_coefs: np.ndarray,
                   all_sum, root_l: bytes, root_h: bytes,
                   final_codeword: np.ndarray):
    """Interactive-equivalent wrapper: draw positions, answer, check.
    Returns (ok, dedup proof size in bytes)."""
    pows = draw_positions(rng, bl)
    answers, proof_size = answer_queries(pows, bl, l_host, h_host,
                                         level_hosts)
    ok = check_queries(pows, answers, bl, level_randomness, level_roots,
                       q_coefs, all_sum, root_l, root_h, final_codeword)
    return ok, proof_size


def _path_positions(pos: int, nleaf: int):
    out = []
    p = nleaf + pos
    while p > 1:
        out.append(p)
        p //= 2
    return out
