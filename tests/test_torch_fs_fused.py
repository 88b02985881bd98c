"""The FS scans of ``csrc/fs_rounds.cu`` (``fs_sponge``, ``fs_sumcheck``):
their plain twins == the JAX package's scans, and a Python model of the
kernel's block schedule == the plain twin.

On the CPU: ``fs_sponge_plain`` against the JAX ``absorb_elems`` then
``squeeze_vec``; ``fs_sumcheck_plain`` of one table, with and without the
claim's absorb, against the JAX ``fs_scan_sumcheck`` (then
``absorb_elems``); the joint phase 2 of every layer of the port's FS prove
of randomize(4, 3, seed=3) against the JAX prover's p2_polys, r_v and
claims_v (the session's shared JAX reference); a model of
``fs_sumcheck``'s schedule (the plan, each block's chunks, the passes
that bind a round ahead and sum the next round's coefficients as
quadratics in its challenge, the blocks' parts into every block and the
bytes each mbarrier expects, the gather into block 0 and its rounds
alone, the rounds' evaluation, the a_term chain and the sponge, every
buffer's offsets in shared memory and the global stores, both routes) at
1, 2, 8 and 16 blocks, held against the twin; and the sponge's permutation
(K2's lane-pair Keccak-f of ``csrc/keccak.cuh``: the halves, shuffles,
rotation table, split round constants and padding), read from the source
and run in Python ints, against ``gkr/fs.py``'s ``_sha3_one`` and
``hashlib``.  Inputs from numpy with a seed; tolerance 0 (bit
equality)."""

import hashlib
import re
from pathlib import Path
from typing import NamedTuple

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
CSRC = Path(fs.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "fs_rounds.cu").read_text()
KECCAK = (CSRC / "keccak.cuh").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# fs_sumcheck's block layout, read from the source: a block's threads, its
# worker warps, a part's words, the parts' buffers and the words ahead of
# them
THREADS, WORKERS, QW, RING, HEAD = (_constant(x) for x in (
    "THREADS", "WORKERS", "QW", "RING", "HEAD"))


def _state(seed):
    return np.random.default_rng(seed).integers(0, 2 ** 64, size=4,
                                                dtype=np.uint64)


def _canon(rng, *shape):
    return rng.integers(0, M, size=shape, dtype=np.uint64)


def _same(port, jax_value):
    x, y = gf.to_numpy(port), np.asarray(jax_value)
    return x.shape == y.shape and np.array_equal(x, y)


def test_constants_match_the_source():
    assert fs.SUMCHECK_THREADS == THREADS
    assert fs.SUMCHECK_CLUSTER == _constant("MAX_CLUSTER")
    assert fs.SUMCHECK_TABLES == _constant("MAX_TABLES")
    assert fs.SUMCHECK_SMEM == _constant("SMEM_MAX")
    assert THREADS == 32 * (WORKERS + 2) and QW == 4 * 3 * 2


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


def _lin_mul(x, y):
    """The product of two linear polynomials (c0, c1) in r: [c0, c1, c2]."""
    return [_mul(x[0], y[0]), _add(_mul(x[0], y[1]), _mul(x[1], y[0])),
            _mul(x[1], y[1])]


def _qadd(x, y):
    return [_add(u, w) for u, w in zip(x, y)]


class _Plan(NamedTuple):
    """The C entry's make_plan (csrc/fs_rounds.cu), in Python: rounds 0 ..
    J - 2 on the whole cluster, pass J gathers every table's T_{J-1} into
    block 0's tail (`gather` bytes), later rounds in block 0; table t cut
    into 2^k[t] chunks; the word offsets of each table's buffers in a
    block's store (sx: T_j of odd j <= J - 2, sy: even) and in the tail
    (tx: j - (J - 1) even, ty: odd); a block's store and tail words."""
    J: int
    k: tuple
    sx: tuple
    sy: tuple
    tx: tuple
    ty: tuple
    gather: int
    store_words: int
    tail_words: int


def _cap(e):
    """Words of a plane of a buffer for 2^e elements (at least two)."""
    return 1 << e if e >= 1 else 2


def _plan(bls, mdb, C):
    c = C.bit_length() - 1
    if C == 1:
        J = 1
    else:
        J = max(2, c + 1)
        assert J <= mdb - 1, (bls, mdb, C)
        while J < mdb - 1 and sum((1 << (b - J - 1)) if b > J else int(
                b == J) for b in bls) > THREADS:
            J += 1
    ks, sx, sy, tx, ty = [], [], [], [], []
    s = tl = gather = 0
    for bl in bls:
        k = min(c, max(0, bl - J - 1))
        ks.append(k)
        offs = [0, 0, 0, 0]
        if J - 2 >= 1 and bl >= 1:
            offs[0], s = s, s + 6 * _cap(bl - 1 - k)
        if J - 2 >= 2 and bl >= 2:
            offs[1], s = s, s + 6 * _cap(bl - 2 - k)
        if (bl >= J - 1) if J >= 2 else (bl >= 2):
            offs[2], tl = tl, tl + 6 * _cap(bl - J + 1 if J >= 2 else bl - 2)
        if bl >= J:
            offs[3], tl = tl, tl + 6 * _cap(bl - J)
        if J >= 2 and bl >= J - 1:
            gather += 48 << (bl - J + 1)
        for lst, o in zip((sx, sy, tx, ty), offs):
            lst.append(o)
    return _Plan(J, tuple(ks), tuple(sx), tuple(sy), tuple(tx), tuple(ty),
                 gather, s, tl)


def _smem(plan, C, smem_store):
    """A block's shared memory bytes (the C entry's plan_smem)."""
    return 8 * (HEAD + 2 * WORKERS * QW + RING * C * QW + plan.tail_words
                + (plan.store_words if smem_store else 0))


def _route(bls, mdb, C):
    """The wrapper's route (gkr/fs.py sumcheck_route) on this plan."""
    fits = _smem(_plan(bls, mdb, C), C, True) <= fs.SUMCHECK_SMEM
    return "smem" if fits else "global"


def schedule_model(tables, mdb, D, absorb, C, route=None):
    """fs_sumcheck's schedule on a cluster of C blocks, in Python ints:
    tables [(v, a or None, m, bl)] as lists of (re, im); D 4 words; route
    "smem" or "global" (default: the wrapper's, gkr/fs.py sumcheck_route).
    Passes and rounds in the order their data allows (pass 0, pass 1, round
    0, pass 2, round 1, ...): pass p binds T_{p-2} at R_{p-2} into T_{p-1}
    and sums round p's coefficients (a quadratic in R_{p-1}) from T_{p-1}'s
    quads; round j evaluates them at R_{j-1}.  Each block's shared memory
    and the global stores are flat lists at the kernel's offsets; a pass
    reads only words written before it and writes each word at most once,
    none that it reads; each round's parts and gathered words are the
    bytes its mbarrier expects.  Returns (polys [j][k], rs [j], bounds
    [t][arr], D)."""
    bls = [t[3] for t in tables]
    n = len(tables)
    plan = _plan(bls, mdb, C)
    J, cap = plan.J, _cap
    if route is None:
        route = _route(bls, mdb, C)
    words = _smem(plan, C, route == "smem") // 8
    assert words * 8 <= fs.SUMCHECK_SMEM
    smem = [[None] * words for _ in range(C)]
    gstore = [None] * (C * plan.store_words)
    tail0 = HEAD + 2 * WORKERS * QW + RING * C * QW
    assert tail0 % 2 == 0 and all(o % 2 == 0 for o in plan.tx + plan.ty)

    def buf(b, t, j):
        """(memory, base word, plane words) of T_j (j >= 1) in block b."""
        bl, k = bls[t], plan.k[t]
        if j <= J - 2:
            mem, base = ((smem[b], tail0 + plan.tail_words) if route == "smem"
                         else (gstore, b * plan.store_words))
            return ((mem, base + plan.sx[t], cap(bl - 1 - k)) if j & 1
                    else (mem, base + plan.sy[t], cap(bl - 2 - k)))
        if (j - (J - 1)) & 1:
            return smem[b], tail0 + plan.ty[t], cap(bl - J)
        return smem[b], tail0 + plan.tx[t], cap(bl - J + 1 if J >= 2
                                                else bl - 2)

    def live(t, j, b):
        bl = bls[t]
        if j > bl:
            return 0
        if j <= J - 1:
            k = plan.k[t]
            return 1 << (bl - j - k) if b < (1 << k) else 0
        return 1 << (bl - j) if b == 0 else 0

    def units(L, p):
        if p == 0:
            return L >> 1 if L >= 2 else L
        return L >> 2 if L >= 4 else int(L == 2 or (L == 1 and p >= 2))

    def input_el(t, b, q, i):
        x, bl = tables[t][q], bls[t]
        idx = (b << (bl - plan.k[t])) + i
        assert 0 <= idx < (1 << bl)
        return (0, 0) if x is None else x[idx]

    def elem(b, t, j, q, i, reads=None):
        if j == 0:
            return input_el(t, b, q, i)
        mem, base, c = buf(b, t, j)
        assert 0 <= i < c
        o = (base + 2 * q * c + i, base + (2 * q + 1) * c + i)
        if reads is not None:
            reads.update((id(mem), w) for w in o)
        assert mem[o[0]] is not None and mem[o[1]] is not None, \
            "read before written"
        return (mem[o[0]], mem[o[1]])

    zero_part = [[(0, 0)] * 3 for _ in range(4)]

    def run_pass(p, b, r):
        """Pass p of block b: (its part: the quadratics of p0, p1, p2 and
        the a_term sum; the bytes it stores into block 0's tail)."""
        jt = 0 if p == 0 else p - 1
        part = [list(x) for x in zero_part]
        reads, writes, sent = set(), set(), 0
        for t in range(n):
            L = live(t, jt, b)
            ne = (2 if L >= 2 else 1) if p == 0 else min(L, 4)
            for u in range(units(L, p)):
                if p <= 1:
                    x = [[input_el(t, b, q, ne * u + h) for q in range(3)]
                         for h in range(ne)]
                else:
                    x = [[_bind(elem(b, t, p - 2, q, 2 * (ne * u + h), reads),
                                elem(b, t, p - 2, q, 2 * (ne * u + h) + 1,
                                     reads), r) for q in range(3)]
                         for h in range(ne)]
                    gather = jt == J - 1
                    mem, base, c = buf(0 if gather else b, t, jt)
                    i0 = (b * L if gather else 0) + ne * u
                    for h in range(ne):
                        assert i0 + h < c
                        for q in range(3):
                            for w in (0, 1):
                                o = base + (2 * q + w) * c + i0 + h
                                assert (id(mem), o) not in writes
                                writes.add((id(mem), o))
                                mem[o] = x[h][q][w]
                    if gather:
                        sent += 48 * ne
                if p == 0:
                    if ne == 2:
                        tm = _terms(x[0][0], x[1][0], x[0][1], x[1][1],
                                    x[0][2], x[1][2])
                        for i in range(3):
                            part[i][0] = _add(part[i][0], tm[i])
                    else:
                        part[3][0] = _add(part[3][0], _add(
                            _mul(x[0][0], x[0][2]), x[0][1]))
                elif p < mdb and ne == 4:
                    y0 = [(x[0][q], _sub(x[1][q], x[0][q])) for q in range(3)]
                    y1 = [(x[2][q], _sub(x[3][q], x[2][q])) for q in range(3)]
                    d = [(_sub(y1[q][0], y0[q][0]), _sub(y1[q][1], y0[q][1]))
                         for q in range(3)]
                    part[0] = _qadd(part[0], _lin_mul(d[2], d[0]))
                    part[1] = _qadd(part[1], _qadd(_qadd(
                        _lin_mul(d[2], y0[0]), _lin_mul(y0[2], d[0])),
                        [d[1][0], d[1][1], (0, 0)]))
                    part[2] = _qadd(part[2], _qadd(_lin_mul(y0[2], y0[0]),
                                                   [*y0[1], (0, 0)]))
                elif p < mdb and ne == 2:
                    y = [(x[0][q], _sub(x[1][q], x[0][q])) for q in range(3)]
                    part[3] = _qadd(part[3], _qadd(_lin_mul(y[0], y[2]),
                                                   [*y[1], (0, 0)]))
        assert not reads & writes, "a pass overwrites what it reads"
        return part, sent

    def evaluate(q, r):
        return _add(q[0], _mul(_add(q[1], _mul(q[2], r)), r))

    if mdb == 0:
        bounds = [[input_el(t, 0, q, 0) for q in range(3)] for t in range(n)]
        if absorb:
            D = _hash([*bounds[0][0], 0, 0] + D)
        return [], [], bounds, D
    rounds = [mdb if b == 0 else J - 1 for b in range(C)]
    last = [mdb + 1 if b == 0 else J for b in range(C)]
    inbox = {}   # (round, block) -> [parts], bytes
    R = []

    def do_pass(p):
        for b in range(C):
            if p > last[b]:
                continue
            part, sent = run_pass(p, b, R[p - 2] if p >= 2 else None)
            dests = range(C) if p <= J - 2 else [0]
            for d in dests if p < mdb else ():
                got = inbox.setdefault((p, d), [[], 0])
                got[0].append(part)
                got[1] += QW * 8
            if sent:
                inbox.setdefault((p, 0), [[], 0])[1] += sent

    do_pass(0)
    do_pass(1)
    polys, a_terms = [], [(0, 0)] * C
    for j in range(mdb):
        seen = []
        for b in range(C):
            if j >= rounds[b]:
                continue
            got, nbytes = inbox[(j, b)]
            senders = C if j <= J else 1
            assert nbytes == senders * QW * 8 + (
                plan.gather if j == J and J >= 2 else 0), (j, b, nbytes)
            tot = zero_part
            for p in got:
                tot = [_qadd(x, y) for x, y in zip(tot, p)]
            r = R[-1] if j else (0, 0)
            pa, pb, pc, aw = (evaluate(q, r) for q in tot)
            at = evaluate([a_terms[b], _sub((0, 0), a_terms[b]), (0, 0)], r)
            a_terms[b] = _add(at, aw)
            seen.append([pa, _add(pb, _sub((0, 0), a_terms[b])),
                         _add(pc, a_terms[b])])
        assert all(x == seen[0] for x in seen)
        poly = seen[0]
        D = _hash([*poly[0], *poly[1]] + D)
        D = _hash([*poly[2], 0, 0] + D)
        h, D = _hash(D + [1, 0, 0, 0]), _hash(D + [2, 0, 0, 0])
        R.append((h[0] % M, h[1] % M))
        polys.append(poly)
        do_pass(j + 2)
    bounds = [[elem(0, t, bls[t], q, 0) for q in range(3)] for t in range(n)]
    if absorb:
        D = _hash([*bounds[0][0], 0, 0] + D)
    return polys, R, bounds, D


def _as_pairs(x):
    w = gf.to_numpy(x)
    return [(int(w[0, i]), int(w[1, i])) for i in range(w.shape[1])]


def _hold_model(rng, bls, mdb, has_a, absorb, C, route=None):
    raw = [tuple(_canon(rng, 2, 1 << bl) for _ in range(3)) for bl in bls]
    D = _state(500 + C + mdb)
    tables = [(gf.tensor(v), gf.tensor(a) if has_a else None,
               gf.tensor(m), bl) for (v, a, m), bl in zip(raw, bls)]
    polys, rs, bounds, gD = fs.fs_sumcheck_plain(tables, mdb, gf.tensor(D),
                                                 absorb)
    model = [(_as_pairs(gf.tensor(v)),
              _as_pairs(gf.tensor(a)) if has_a else None,
              _as_pairs(gf.tensor(m)), bl)
             for (v, a, m), bl in zip(raw, bls)]
    mp, mr, mb, mD = schedule_model(model, mdb, [int(w) for w in D], absorb,
                                    C, route)
    P, R, B = (gf.to_numpy(x) for x in (polys, rs, bounds))
    assert [[(int(P[j, 0, k]), int(P[j, 1, k])) for k in range(3)]
            for j in range(mdb)] == mp
    assert [(int(R[0, j]), int(R[1, j])) for j in range(mdb)] == mr
    assert [[(int(B[t, 0, k]), int(B[t, 1, k])) for k in range(3)]
            for t in range(len(bls))] == mb
    assert [int(w) for w in gf.to_numpy(gD)] == mD


@pytest.mark.parametrize("C", [1, 2, 8, 16])
def test_block_schedule_model_matches_plain(C):
    """Tables of every kind at C blocks (c = log2 C), on the route the
    wrapper picks: a joint phase 2 with tables that end in the cluster's
    rounds, at the gather and in block 0's rounds (and one of one
    element), one table with the claim's absorb, and Liu's (a = 0)."""
    c = C.bit_length() - 1
    rng = np.random.default_rng(400 + C)
    cases = [([c + 3, c + 3, c + 2, c + 1, c, 0], c + 3, True, False),
             ([c + 3], c + 3, True, True), ([c + 2], c + 2, False, True)]
    for bls, mdb, has_a, absorb in cases:
        _hold_model(rng, bls, mdb, has_a, absorb, C)


@pytest.mark.parametrize("C, route", [(2, "smem"), (2, "global"),
                                      (8, "smem"), (8, "global"),
                                      (16, "global")])
def test_block_schedule_model_routes(C, route):
    """Each route at several cluster sizes, on a plan deep enough for every
    buffer: the store's both ping-pong halves (J >= 4), tables that end in
    the store, in the gather and in block 0's tail."""
    rng = np.random.default_rng(600 + C)
    bls = [9, 9, 8, 6, 4, 3, 2, 1, 0] if C > 2 else [9, 8, 5, 1]
    _hold_model(rng, bls, 9, True, False, C, route)


def test_plans_take_both_routes_and_every_phase():
    """The plan's phases at the shapes the model runs and at chip_smoke.py's
    route shapes: J >= 4 (a store of both halves), a table split over
    fewer blocks than the cluster's, and either route."""
    deep = _plan([9, 9, 8, 6, 4, 3, 2, 1, 0], 9, 8)
    assert deep.J >= 4 and 0 < min(k for k in deep.k if k) < 3, deep
    routes = set()
    for mdb, bls in ((10, (10,) * 9 + (8,) * 2 + (5,) + (0,)),
                     (14, (14,) * 8 + (12,) * 4 + (6,) + (1,))):
        tabs = [(None, None, None, b) for b in bls]
        routes.add(_route(bls, mdb, fs.sumcheck_cluster(tabs)))
    assert routes == {"smem", "global"}


# ---- the sponge's permutation (csrc/keccak.cuh), in Python ints ------------

MASK32 = (1 << 32) - 1


def _rotl(x, n, bits):
    n %= bits
    mask = (1 << bits) - 1
    return ((x << n) | (x >> (bits - n))) & mask if n else x


def _keccak_source():
    """The round constants' even and odd halves, the rho-pi table {b: (src,
    R)} and the padding's halves at words 8 and 16 (role 0, role 1), from
    keccak.cuh's keccak_f_pair and sha3_64_pair."""
    def consts(name):
        body = KECCAK[KECCAK.index(f"u32 {name}[24] = {{"):]
        return [int(x, 16) for x in re.findall(r"0x([0-9A-F]{8})u",
                                               body[:body.index("};")])]
    rc = (consts("RC_EVEN"), consts("RC_ODD"))
    perm = KECCAK[KECCAK.index("void keccak_f_pair"):
                  KECCAK.index("u32 unshuffle32")]
    table = {int(b): (int(src), int(r)) for b, r, src in re.findall(
        r"b\[(\d+)\] = rot_half<(\d+)>\(s\[(\d+)\], e\)", perm)}
    table.update({int(b): (int(src), 0) for b, src in re.findall(
        r"b\[(\d+)\] = s\[(\d+)\];", perm)})
    pad_src = KECCAK[KECCAK.index("void sha3_64_pair"):]
    pad = {int(w): (int(even, 16), int(odd, 16)) for w, odd, even in
           re.findall(r"s\[(\d+)\] = role \? 0x([0-9A-F]+)u : 0x?([0-9A-F]*)u",
                      pad_src.replace(": 0u", ": 0x0u"))}
    return rc, table, pad


def _bits(x, parity):
    return sum(((x >> (2 * i + parity)) & 1) << i for i in range(32))


def _join(even, odd):
    return sum((((even >> i) & 1) << (2 * i)) | (((odd >> i) & 1) << (2 * i + 1))
               for i in range(32))


def _keccak_pair(halves, rc, table):
    """keccak_f_pair on a lane pair: halves[role] the 25 words' even (role
    0) or odd (role 1) bits; a rotation by an even R rotates a half by R /
    2, one by an odd R reads the partner's half (a shuffle) rotated by (R
    - 1) / 2 + 1 - role."""
    s = [list(h) for h in halves]
    for rnd in range(24):
        c = [[s[ro][x] ^ s[ro][x + 5] ^ s[ro][x + 10] ^ s[ro][x + 15]
              ^ s[ro][x + 20] for x in range(5)] for ro in (0, 1)]
        for ro in (0, 1):
            e, p = 1 - ro, c[1 - ro]
            d = [c[ro][(x + 4) % 5] ^ _rotl(p[(x + 1) % 5], e, 32)
                 for x in range(5)]
            s[ro] = [s[ro][i] ^ d[i % 5] for i in range(25)]
        new = [[0] * 25, [0] * 25]
        for ro in (0, 1):
            e = 1 - ro
            b = [0] * 25
            for i, (src, r) in table.items():
                b[i] = (_rotl(s[1 - ro][src], (r - 1) // 2 + e, 32) if r % 2
                        else _rotl(s[ro][src], r // 2, 32))
            for y in range(0, 25, 5):
                for x in range(5):
                    new[ro][y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & MASK32
                                                 & b[y + (x + 2) % 5])
            new[ro][0] ^= rc[ro][rnd]
        s = new
    return s


@pytest.mark.parametrize("block", ["absorb", "absorb_last", "challenge",
                                   "next_state"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sponge_permutation_layout_matches_sha3(block, seed):
    """SHA3-256 of the sponge's 64-byte blocks (an absorb of two elements,
    the zero-padded absorb of one, a squeeze's challenge digest D || 1 and
    next state D || 2) through keccak_f_pair as the source lays it out,
    split into halves and padded as sha3_64_pair pads, against hashlib and
    gkr/fs.py's _sha3_one (K2's plain twin)."""
    rc, table, pad = _keccak_source()
    assert all(len(x) == 24 for x in rc) and sorted(table) == list(range(25))
    assert sum(r % 2 for _, r in table.values()) == 12
    assert sorted(pad) == [8, 16]
    rng = np.random.default_rng(700 + seed)
    for _ in range(2):
        msg = [int(w) for w in rng.integers(0, 2 ** 64, size=8,
                                            dtype=np.uint64)]
        if block == "absorb_last":
            msg[2:4] = [0, 0]
        elif block != "absorb":
            msg[4:] = [1 if block == "challenge" else 2, 0, 0, 0]
        halves = [[_bits(w, role) for w in msg] + [0] * 17 for role in (0, 1)]
        for w, (even, odd) in pad.items():
            halves[0][w], halves[1][w] = even, odd
        out = _keccak_pair(halves, rc, table)
        got = [_join(out[0][i], out[1][i]) for i in range(4)]
        assert got == _hash(msg)
        twin = fs._sha3_one(gf.tensor(np.array(msg, dtype=np.uint64)))
        assert got == [int(w) for w in gf.to_numpy(twin)]
