"""The FS scans of ``csrc/fs_rounds.cu`` (``fs_sponge``, ``fs_sumcheck``):
their plain twins == the JAX package's scans, and a Python model of the
kernel's block schedule == the plain twin.

On the CPU: ``fs_sponge_plain`` against the JAX ``absorb_elems`` then
``squeeze_vec``; ``fs_sumcheck_plain`` of one table, with and without the
claim's absorb, against the JAX ``fs_scan_sumcheck`` (then
``absorb_elems``); the joint phase 2 of every layer of the port's FS prove
of randomize(4, 3, seed=3) against the JAX prover's p2_polys, r_v and
claims_v (the session's shared JAX reference); and the model of
``fs_sumcheck``'s schedule (each block's chunks and part, the hand-over
into the tail, the tail's rounds, the a_term chain, the sponge, the
scratch and shared-memory offsets) at 1, 2, 8 and 16 blocks, held against
the twin.  Inputs from numpy with a seed; tolerance 0 (bit equality)."""

import hashlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virgo_plus_tpu.gkr import fs as jfs
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import fs, protocol

import torch_shared  # one torch thread; the session's JAX reference

M = gf.MOD
SOURCE = (Path(fs.__file__).resolve().parent.parent / "csrc"
          / "fs_rounds.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _state(seed):
    return np.random.default_rng(seed).integers(0, 2 ** 64, size=4,
                                                dtype=np.uint64)


def _canon(rng, *shape):
    return rng.integers(0, M, size=shape, dtype=np.uint64)


def _same(port, jax_value):
    x, y = gf.to_numpy(port), np.asarray(jax_value)
    return x.shape == y.shape and np.array_equal(x, y)


def test_constants_match_the_source():
    assert fs.SUMCHECK_THREADS == _constant("THREADS")
    assert fs.SUMCHECK_CLUSTER == _constant("MAX_CLUSTER")
    assert fs.SUMCHECK_TABLES == _constant("MAX_TABLES")


@pytest.mark.parametrize("k, n", [(0, 1), (1, 0), (3, 1), (9, 5), (0, 64)])
def test_sponge_plain_matches_jax(k, n):
    rng = np.random.default_rng(100 + 7 * k + n)
    D, e = _state(k + 31 * n), _canon(rng, 2, k)
    ch, gD = fs.fs_sponge_plain(gf.tensor(D), gf.tensor(e) if k else None, n)
    jD = jfs.absorb_elems(jnp.asarray(D), jnp.asarray(e))
    if n:
        jch, jD = jfs.squeeze_vec(jD, n)
    else:
        jch = np.zeros((2, 0), dtype=np.uint64)
    assert _same(ch, jch) and _same(gD, jD)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("bl", [0, 1, 3, 6])
def test_sumcheck_plain_one_table_matches_jax(bl, absorb):
    rng = np.random.default_rng(200 + bl)
    v, a, m = (_canon(rng, 2, 1 << bl) for _ in range(3))
    D = _state(300 + bl)
    polys, rs, bounds, gD = fs.fs_sumcheck_plain(
        [(gf.tensor(v), gf.tensor(a), gf.tensor(m), bl)], bl, gf.tensor(D),
        absorb)
    jpolys, jrs, jbound, jD = jfs.fs_scan_sumcheck(
        jnp.asarray(v), jnp.asarray(a), jnp.asarray(m), bl, jnp.asarray(D))
    if absorb:
        jD = jfs.absorb_elems(jD, jbound[0][:, None])
    assert _same(polys, jpolys) and _same(rs, jrs) and _same(gD, jD)
    assert _same(bounds[0], np.stack([np.asarray(b) for b in jbound], 1))


@pytest.fixture(scope="module")
def phase2_calls(tmp_path_factory):
    """The port's FS prove of randomize(4, 3, seed=3) on the JAX values,
    with every fs_sumcheck_plain call (its arguments and results) recorded;
    and the JAX reference."""
    ref = torch_shared.jax_fs_reference(tmp_path_factory)
    c = randomize(4, 3, seed=3)
    subset_init(c)
    cc = compile_circuit(c)
    plans = protocol.build_plans(cc)
    calls = []
    plain = fs.fs_sumcheck_plain

    def recorded(*args):
        out = plain(*args)
        calls.append((args, out))
        return out

    fs.fs_sumcheck_plain = recorded
    try:
        fs.fs_prove(cc, plans, gf.tensor(ref["values"]),
                    gf.tensor(ref["root_l"]),
                    protocol.circuit_arrays(cc, plans, "cpu"),
                    fs.fs_arrays(cc, plans, "cpu"))
    finally:
        fs.fs_sumcheck_plain = plain
    return cc, calls, ref


def test_joint_phase2_matches_jax(phase2_calls):
    cc, calls, ref = phase2_calls
    # each layer i from the top: phase 1, the joint phase 2 (when layer i
    # has dad tables), Liu
    it = iter(calls)
    bit_lengths = set()
    for i in range(cc.depth - 1, 0, -1):
        L = cc.layers[i]
        next(it)
        if L.max_dad_bit_length < 0:
            assert f"L{i}.p2_polys" not in ref
            next(it)
            continue
        (tables, mdb, _D, absorb), (polys, rs, bounds, _gD) = next(it)
        next(it)
        assert mdb == L.max_dad_bit_length and not absorb
        assert _same(polys, ref[f"L{i}.p2_polys"])
        assert _same(rs, ref[f"C{i}.r_v"])
        # the claims: each dad table's bound v, in layer order (zero where
        # a layer gives layer i no table)
        lis = [li for li in range(i) if L.dad_sizes[li]]
        claims = np.zeros((i, 2), dtype=np.uint64)
        for k, li in enumerate(lis):
            claims[li] = gf.to_numpy(bounds[k, :, 0])
        assert np.array_equal(claims, ref[f"L{i}.claims_v"])
        bit_lengths.add(tuple(t[3] for t in tables))
    # the walk met tables of several bit lengths in one phase 2: tables
    # exhausted before the last round, whose a_term chain ran
    assert any(len(set(bls)) > 1 for bls in bit_lengths), bit_lengths


# ---- a model of fs_sumcheck's block schedule (csrc/fs_rounds.cu) ----------

def _add(x, y):
    return ((x[0] + y[0]) % M, (x[1] + y[1]) % M)


def _sub(x, y):
    return ((x[0] - y[0]) % M, (x[1] - y[1]) % M)


def _mul(x, y):
    return ((x[0] * y[0] - x[1] * y[1]) % M, (x[0] * y[1] + x[1] * y[0]) % M)


def _hash(words8):
    d = hashlib.sha3_256(b"".join(int(w).to_bytes(8, "little")
                                  for w in words8)).digest()
    return [int.from_bytes(d[8 * i:8 * i + 8], "little") for i in range(4)]


def _terms(v0, v1, a0, a1, m0, m1):
    dv, da, dm = _sub(v1, v0), _sub(a1, a0), _sub(m1, m0)
    return [_mul(dm, dv), _add(_add(_mul(dm, v0), _mul(m0, dv)), da),
            _add(_mul(m0, v0), a0)]


def _bind(x0, x1, r):
    return _add(x0, _mul(_sub(x1, x0), r))


def schedule_model(tables, mdb, D, absorb, C):
    """fs_sumcheck's schedule on a cluster of C blocks, in Python ints:
    tables [(v, a or None, m, bl)] as lists of (re, im); D 4 words.  The
    scratch, pub and tail buffers are flat lists at the kernel's offsets.
    Returns (polys [j][k], rs [j], bounds [t][arr], D)."""
    n, c, Q = len(tables), C.bit_length() - 1, 6
    soffs, words = [], 0
    for *_, bl in tables:
        soffs.append(words)
        words += (6 << bl) if bl >= c + 2 else 0
    assert words == fs.sumcheck_scratch(tables, C)
    scratch = [None] * words
    pub = [[None] * (n * Q) for _ in range(C)]
    tail = [[None] * (2 * n * Q * C) for _ in range(C)]

    def tl(par, t, q):
        return ((par * n + t) * Q + q) * C

    def read(t, j, r, i):
        v, a, m, bl = tables[t]
        if j == 0:
            x = (v, a, m)[r]
            return (0, 0) if x is None else x[i]
        half = 1 << (bl - 1)
        base = soffs[t] + ((j & 1) * 3 + r) * 2 * half
        return (scratch[base + i], scratch[base + half + i])

    def tail_el(T, par, t, r, i):
        return (T[tl(par, t, 2 * r) + i], T[tl(par, t, 2 * r + 1) + i])

    polys, rs = [], []
    a_term, r = (0, 0), None
    for j in range(mdb + 1):
        # 1. each block's part over its chunks
        parts = []
        for b in range(C):
            acc = [(0, 0)] * 3
            for t, (*_, bl) in enumerate(tables):
                if bl - j > c:
                    pairs = 1 << (bl - j - 1 - c)
                    for p in range(pairs):
                        i = 2 * (b * pairs + p)
                        x = _terms(*(read(t, j, rr, i + s) for rr in range(3)
                                     for s in (0, 1)))
                        acc = [_add(u, w) for u, w in zip(acc, x)]
            parts.append(acc)
        # 2. after the barrier, every block gathers what enters its tail
        for b in range(C):
            T = tail[b]
            for t, (v, a, m, bl) in enumerate(tables):
                if bl > c and j == bl - c:
                    for q in range(Q):
                        for i in range(C):
                            T[tl(j & 1, t, q) + i] = pub[i][t * Q + q]
                elif bl <= c and j == 0:
                    for q in range(Q):
                        x = (v, a, m)[q >> 1]
                        for i in range(1 << bl):
                            T[tl(0, t, q) + i] = 0 if x is None else \
                                x[i][q & 1]
        if j == mdb:
            T = tail[0]
            bounds = [[tail_el(T, bl & 1, t, rr, 0) for rr in range(3)]
                      for t, (*_, bl) in enumerate(tables)]
            if absorb:
                D = _hash([*bounds[0][0], 0, 0] + D)
            return polys, rs, bounds, D
        # 3. the round polynomial, the same in every block
        seen = []
        for b in range(C):
            T = tail[b]
            poly = [(0, 0)] * 3
            for part in parts:
                poly = [_add(u, w) for u, w in zip(poly, part)]
            for t, (*_, bl) in enumerate(tables):
                if j < bl and bl - j <= c:
                    for i in range(0, 1 << (bl - j), 2):
                        x = _terms(*(tail_el(T, j & 1, t, rr, i + s)
                                     for rr in range(3) for s in (0, 1)))
                        poly = [_add(u, w) for u, w in zip(poly, x)]
            at = a_term if j == 0 else _mul(a_term, _sub((1, 0), r))
            for t, (*_, bl) in enumerate(tables):
                if bl == j:
                    v, a, m = (tail_el(T, j & 1, t, rr, 0) for rr in range(3))
                    at = _add(at, _add(_mul(v, m), a))
            poly[1] = _add(poly[1], _sub((0, 0), at))
            poly[2] = _add(poly[2], at)
            seen.append((poly, at))
        assert all(x == seen[0] for x in seen)
        poly, a_term = seen[0]
        # 4. the sponge
        D = _hash([*poly[0], *poly[1]] + D)
        D = _hash([*poly[2], 0, 0] + D)
        h, D = _hash(D + [1, 0, 0, 0]), _hash(D + [2, 0, 0, 0])
        r = (h[0] % M, h[1] % M)
        polys.append(poly)
        rs.append(r)
        # 5. every block binds its tail, 6. then its chunks
        for b in range(C):
            T = tail[b]
            for t, (*_, bl) in enumerate(tables):
                if j < bl and bl - j <= c:
                    for i in range(1 << (bl - j - 1)):
                        for rr in range(3):
                            y = _bind(tail_el(T, j & 1, t, rr, 2 * i),
                                      tail_el(T, j & 1, t, rr, 2 * i + 1), r)
                            T[tl((j + 1) & 1, t, 2 * rr) + i] = y[0]
                            T[tl((j + 1) & 1, t, 2 * rr + 1) + i] = y[1]
        for b in range(C):
            for t, (*_, bl) in enumerate(tables):
                if bl - j > c:
                    pairs, half = 1 << (bl - j - 1 - c), 1 << (bl - 1)
                    dst = soffs[t] + ((j + 1) & 1) * 3 * 2 * half
                    for p in range(pairs):
                        o = b * pairs + p
                        for rr in range(3):
                            y = _bind(read(t, j, rr, 2 * o),
                                      read(t, j, rr, 2 * o + 1), r)
                            if bl - j - 1 == c:
                                pub[b][t * Q + 2 * rr:t * Q + 2 * rr + 2] = y
                            else:
                                scratch[dst + rr * 2 * half + o] = y[0]
                                scratch[dst + rr * 2 * half + half + o] = y[1]


def _as_pairs(x):
    w = gf.to_numpy(x)
    return [(int(w[0, i]), int(w[1, i])) for i in range(w.shape[1])]


@pytest.mark.parametrize("C", [1, 2, 8, 16])
def test_block_schedule_model_matches_plain(C):
    """Tables of every kind at C blocks (c = log2 C): more than 2C
    elements (chunks, then the scratch, then pub), exactly 2C (pub in
    round 0), at most C (the tail from round 0), one element; a joint
    phase 2 with exhausted tables, one table with the claim's absorb, and
    Liu's (a = 0)."""
    c = C.bit_length() - 1
    rng = np.random.default_rng(400 + C)
    cases = [([c + 3, c + 3, c + 2, c + 1, c, 0], c + 3, True, False),
             ([c + 3], c + 3, True, True), ([c + 2], c + 2, False, True)]
    for bls, mdb, has_a, absorb in cases:
        raw = [tuple(_canon(rng, 2, 1 << bl) for _ in range(3)) for bl in bls]
        D = _state(500 + C + mdb)
        tables = [(gf.tensor(v), gf.tensor(a) if has_a else None,
                   gf.tensor(m), bl) for (v, a, m), bl in zip(raw, bls)]
        polys, rs, bounds, gD = fs.fs_sumcheck_plain(tables, mdb,
                                                     gf.tensor(D), absorb)
        model = [(_as_pairs(gf.tensor(v)),
                  _as_pairs(gf.tensor(a)) if has_a else None,
                  _as_pairs(gf.tensor(m)), bl)
                 for (v, a, m), bl in zip(raw, bls)]
        mp, mr, mb, mD = schedule_model(model, mdb, [int(w) for w in D],
                                        absorb, C)
        P, R, B = (gf.to_numpy(x) for x in (polys, rs, bounds))
        assert [[(int(P[j, 0, k]), int(P[j, 1, k])) for k in range(3)]
                for j in range(mdb)] == mp
        assert [(int(R[0, j]), int(R[1, j])) for j in range(mdb)] == mr
        assert [[(int(B[t, 0, k]), int(B[t, 1, k])) for k in range(3)]
                for t in range(len(bls))] == mb
        assert [int(w) for w in gf.to_numpy(gD)] == mD
