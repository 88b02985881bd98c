"""Circuit evaluation (``circuits/compile.py``: ``gf_evaluate``) and the
fft_gkr tape's stage tables (``pc/fft_gkr.py``: ``fg_stage_tables``) on
the CPU against the JAX package and the per-stage formulas, and the
kernels' schedules emulated on the host.

On a CUDA tensor ``evaluate`` is one ``gf_evaluate`` launch over the
circuit's plan (``eval_launches``: a very wide layer gets a launch of its
own), and the tape's ifft stages are one ``fg_stage_tables`` launch a
phase between two K1 calls that fold every stage at once; on a CPU
tensor the launches are the plain twins (``evaluate_plain``,
``stage_tables_plain``).  Here:

* ``evaluate`` == JAX ``evaluate`` on randomize(4, 3), on a batch of
  witnesses (2, B, n) row by row, and on a circuit with unary gates, right
  inputs from layer 0 and a layer of 13 gates (its padding stays zero);
* ``stage_tables_plain`` == the tape's per-stage formulas (each stage's
  tables built alone and interleaved, with ``fft.powers`` twiddles) at
  lg = 1, 3 and 5, and ``stage_powers`` == ``fft.powers`` stage by stage;
* ``emulate_evaluate``, a numpy copy of ``csrc/circuit_eval.cu``'s
  launches, clusters, row groups, gate walk and barriers (at the card's
  launch shape and a shrunk one, on the cut circuit and on random plans
  of mixed gate kinds with a layer too wide for a cluster), == the twin,
  writing every word once and reading only words of earlier steps; the
  launch rule on randomize(14, 13)'s shape; ``emulate_stage_tables``, a
  Python-int copy of ``csrc/fft_gkr.cu``'s index arithmetic, == the
  twin; the constants against the sources;
* a CPU call counts ``kernels.PLAIN_CALLS`` and launches nothing; the CUDA
  wrappers refuse CPU tensors.

The whole tape against JAX ``make_fg_tape`` (lg = 1 and 3) is in
``tests/test_torch_pc.py``.  Inputs are canonical, from the circuits'
witnesses and numpy with a seed; field arithmetic is exact, so the
tolerance is 0.  The kernels run only on a card: chip_smoke.py holds them
against the twins there."""

import re
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from virgo_plus_tpu.circuits import compile as jcompile
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.circuits import compile as comp
from virgo_plus_tpu_torch.circuits.compile import (compile_circuit,
                                                   eval_arrays, evaluate,
                                                   input_buffer)
from virgo_plus_tpu_torch.circuits.gates import GateType
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf, np_ops
from virgo_plus_tpu_torch.field.ref import Fq2
from virgo_plus_tpu_torch.pc import fft, fft_gkr

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
THREADS = 256                 # csrc/fft_gkr.cu
MAX_BLOCKS = 132 * 8          # csrc/fft_gkr.cu


def _unary_circuit():
    """randomize(4, 4, seed=2) with layer 2 cut to 13 gates (three padding
    slots) and, on layer 3, a Mulc, an Addc, a Not and a Copy gate and
    right inputs from layer 0."""
    c = randomize(4, 4, seed=2)
    L2, L3 = c.layers[2], c.layers[3]
    for k in ("ty", "u", "v", "l", "lv", "c_real", "c_img", "is_assert"):
        setattr(L2, k, getattr(L2, k)[:13].copy())
    L2.size = 13
    L3.u %= 13
    L3.v[L3.l == 2] %= 13
    L3.l[4:8] = 0
    rng = np.random.default_rng(4)
    for g, ty in enumerate((GateType.Mulc, GateType.Addc, GateType.Not,
                            GateType.Copy)):
        L3.ty[g], L3.l[g], L3.v[g] = int(ty), -1, 0
        L3.c_real[g] = rng.integers(0, M, dtype=np.uint64)
        L3.c_img[g] = rng.integers(0, M, dtype=np.uint64)
    subset_init(c)
    return c


def _randomize(layers, bits, seed):
    c = randomize(layers, bits, seed=seed)
    subset_init(c)
    return c


def _jax_evaluate(c, witnesses):
    """JAX ``evaluate`` (jitted) of each witness (2, n) of a list."""
    jcc = jcompile.compile_circuit(c)
    fn = jax.jit(lambda x: jcompile.evaluate(jcc, x))
    return [np.asarray(fn(jcompile.input_buffer(jcc, w))) for w in witnesses]


def _witnesses(c, b):
    """b witnesses: the circuit's inputs plus numpy integers on the real
    plane."""
    base = np.asarray(c.input_values, dtype=np.uint64)
    xs = np.stack([base] * b)
    xs[:, 0] = (xs[:, 0] + np.random.default_rng(7).integers(
        0, 5, xs[:, 0].shape, dtype=np.uint64)) % np.uint64(M)
    return xs


@pytest.mark.parametrize("name", ["randomize(4, 3)", "unary"])
def test_evaluate_matches_jax(name):
    c = _randomize(4, 3, 5) if name != "unary" else _unary_circuit()
    cc = compile_circuit(c)
    arrs = eval_arrays(cc, "cpu")
    xs = _witnesses(c, 3)
    want = _jax_evaluate(c, list(xs))
    got = gf.to_numpy(evaluate(cc, input_buffer(cc, xs, "cpu"), arrs))
    assert got.shape == (2, 3, cc.total_values)
    for b in range(3):
        assert np.array_equal(got[:, b], want[b]), b
    one = gf.to_numpy(evaluate(cc, input_buffer(cc, xs[0], "cpu"), arrs))
    assert np.array_equal(one, want[0])
    if name == "unary":
        off = int(cc.value_off[2])
        assert cc.layers[2].size == 13 and cc.layers[2].padded == 16
        assert not got[..., off + 13:off + 16].any()


def _old_stage_tables(pre_layer, bgA, bgB, x_pows, n):
    """The tape's phase-1 tables of one stage, as the stage loop made
    them before the stages were batched."""
    K, m = bgA.shape[1], bgA.shape[2]
    v_odd = pre_layer.reshape(2, K, 2, m)[:, :, 1, :]
    am_e = gf.add(bgA, bgB)
    addV_e = gf.mul(gf.mul(gf.sub(bgA, bgB), x_pows[:, :, None]), v_odd)
    zero = torch.zeros_like(am_e)
    return (torch.stack([addV_e, zero], dim=2).reshape(2, n),
            torch.stack([am_e, zero], dim=2).reshape(2, n))


def _old_stage_tables_p2(bgA, bgB, x_pows, bu_full, v_u, n):
    """The same, phase 2."""
    K, m = bgA.shape[1], bgA.shape[2]
    bu_u = bu_full.reshape(2, K, 2, m)[:, :, 0, :]
    gA_u = gf.mul(bgA, bu_u)
    gB_u = gf.mul(bgB, bu_u)
    am_o = gf.mul(gf.sub(gA_u, gB_u), x_pows[:, :, None])
    addV_o = gf.mul(gf.add(gA_u, gB_u), v_u[:, None, None])
    zero = torch.zeros_like(am_o)
    return (torch.stack([zero, addV_o], dim=2).reshape(2, n),
            torch.stack([zero, am_o], dim=2).reshape(2, n))


def _canon(rng, *shape):
    return gf.tensor(rng.integers(0, M, size=shape, dtype=np.uint64))


def _stage_inputs(lg, seed):
    rng = np.random.default_rng(seed)
    n = 1 << lg
    return (_canon(rng, 2, lg, n), _canon(rng, 2, lg, n),
            _canon(rng, 2, lg, n), _canon(rng, 2, lg))


@pytest.mark.parametrize("lg", [1, 3, 5])
def test_stage_tables_match_per_stage_formulas(lg):
    n = 1 << lg
    bg, V, bu, vu = _stage_inputs(lg, lg)
    xp = fft_gkr.stage_powers(lg, "cpu")
    rot_mul = fft_gkr._rot_mul(lg)
    p1 = fft_gkr.stage_tables_plain(1, bg, xp, V, None, 0)
    p2 = fft_gkr.stage_tables_plain(2, bg, xp, bu, vu, 0)
    for dep in range(lg):
        K, m = n >> (dep + 1), 1 << dep
        x_pows = fft.powers(rot_mul[dep], K, "cpu")
        assert torch.equal(fft_gkr.stage_twiddles(xp, lg, dep), x_pows)
        resh = bg[:, dep].reshape(2, 2, K, m)
        want1 = _old_stage_tables(V[:, dep], resh[:, 0], resh[:, 1], x_pows,
                                  n)
        want2 = _old_stage_tables_p2(resh[:, 0], resh[:, 1], x_pows,
                                     bu[:, dep], vu[:, dep], n)
        for got, want in ((p1, want1), (p2, want2)):
            assert all(torch.equal(g[:, dep], w) for g, w in zip(got, want))
        # one stage alone, as fft_gkr.run calls it
        one = fft_gkr.stage_tables_plain(2, bg[:, dep:dep + 1], xp,
                                         bu[:, dep:dep + 1],
                                         vu[:, dep:dep + 1], dep)
        assert all(torch.equal(g[:, 0], w) for g, w in zip(one, want2))


def _source_constants(name, *consts):
    src = (kernels.CSRC / name).read_text()
    return [int(re.search(rf"constexpr int {c} = (-?\d+);", src).group(1))
            for c in consts]


def test_eval_constants_match_the_source():
    assert _source_constants(
        "circuit_eval.cu", "THREADS", "CLUSTER", "MAX_LAYERS",
        "COPY") == [comp.EVAL_THREADS, comp.EVAL_CLUSTER, comp.EVAL_LAYERS,
                    comp.COPY]
    assert comp.eval_shape(5, {1: 9, 2: 4, 4: 0}) == (2, 3, 2)


def _coefficients(rng, w):
    """(4, 2, w) canonical coefficients of a mix of gate kinds: add (C =
    0), mul (A = B = 0), all four, and A with D alone (a scaled copy)."""
    co = rng.integers(0, M, (4, 2, w), dtype=np.uint64)
    kind = rng.integers(0, 4, w)
    co[2, :, kind == 0] = 0
    co[:2, :, kind == 1] = 0
    co[1:3, :, kind == 3] = 0
    co[3, :, kind < 2] = 0
    return co


def _random_plan(widths, seed):
    """An EvalPlan of random layers: an input block of widths[0] values,
    then a layer of each further width, its left inputs in the layer
    before, its right inputs anywhere in earlier blocks, canonical
    coefficients of mixed gate kinds (the kernel's arithmetic takes any
    words)."""
    rng = np.random.default_rng(seed)
    padded = [1 << max(w - 1, 0).bit_length() for w in widths]
    off = np.concatenate([[0], np.cumsum(padded)])
    return comp.make_plan(
        [(rng.integers(0, padded[i - 1], w), rng.integers(0, off[i], w),
          _coefficients(rng, w), int(off[i - 1]), int(off[i]), padded[i])
         for i, w in enumerate(widths[1:], 1)],
        padded[0], int(off[-1]), "cpu")


def _times(c, v):
    """gate_value's c * v: (0, 0) where c is (0, 0), without the
    product."""
    zero = (c == 0).all(axis=0)
    return np.where(zero, np.uint64(0), np_ops.mul(c, v))


def emulate_evaluate(inputs, plan, fits):
    """csrc/circuit_eval.cu's vpt_gf_evaluate and gf_evaluate_kernel on
    numpy words (np_ops' arithmetic), launch by launch as
    ``compile.eval_launches`` groups the steps: in each launch, each
    cluster (row group, gate part) walks each step's gates t0 + k * step
    of its threads over its rows, a barrier between two steps.  A word a
    step reads must have been written by an earlier launch, or in this
    launch by an earlier step of the same cluster.  A product by a (0, 0)
    coefficient is (0, 0), unmade (gate_value).  The buffer starts as
    random words (torch.empty).  Returns the values and each word's
    writes."""
    T, CL = comp.EVAL_THREADS, comp.EVAL_CLUSTER
    n_in = inputs.shape[-1]
    lead = tuple(inputs.shape[1:-1])
    rows = int(np.prod(lead))
    xin = gf.to_numpy(inputs).reshape(2, rows, n_in)
    v = np.random.default_rng(0).integers(0, 2 ** 63, (2, rows, plan.total),
                                          dtype=np.int64).view(np.uint64)
    writes = np.zeros((rows, plan.total), dtype=np.int64)
    when = np.full((rows, plan.total, 3), -1)   # launch, cluster, step
    xi, yi = plan.x_idx.numpy(), plan.y_idx.numpy()
    co = gf.to_numpy(plan.co)
    launches = comp.eval_launches(plan.steps, rows, fits)
    for n, (first, count, cs, groups, per, split) in enumerate(launches):
        assert cs <= CL and fits[cs] >= 1 and (split == 1 or (
            cs == 1 and count == 1))
        assert count <= comp.EVAL_LAYERS and groups * per >= rows
        span = split * cs * T              # the kernel's `step`
        for c in range(groups * split):
            group, part = divmod(c, split)
            rs = np.arange(group * per, min(rows, group * per + per))
            lo = part * cs * T             # its threads' t0
            for l in range(count):
                g0, size, x_off, out_off, padded = (
                    int(a) for a in plan.steps[first + l])
                g = np.arange(padded)
                t = g % span
                mine = g[(t >= lo) & (t < lo + cs * T)]
                if size == comp.COPY:
                    vals = np.zeros((2, len(rs), len(mine)), dtype=np.uint64)
                    live = mine < n_in
                    vals[:, :, live] = xin[:, rs][:, :, mine[live]]
                else:
                    vals = np.zeros((2, len(rs), len(mine)), dtype=np.uint64)
                    live = mine < size
                    f = g0 + mine[live]
                    idx = [x_off + xi[f].astype(np.int64),
                           yi[f].astype(np.int64)]
                    for ix in idx:
                        w = when[rs][:, ix]
                        ok = (w[..., 0] < n) | (
                            (w[..., 0] == n) & (w[..., 1] == c)
                            & (w[..., 2] < l) & (w[..., 2] >= 0))
                        assert (w[..., 0] >= 0).all() and ok.all(), (n, c, l)
                    x, y = (v[:, rs][:, :, ix] for ix in idx)
                    A, B, C, D = (co[q][:, None, f] for q in range(4))
                    vals[:, :, live] = np_ops.add(
                        np_ops.add(_times(A, x), _times(B, y)),
                        np_ops.add(_times(C, np_ops.mul(x, y)), D))
                cols = out_off + mine
                v[:, rs[:, None], cols] = vals
                writes[rs[:, None], cols] += 1
                when[rs[:, None], cols] = (n, c, l)
    return v.reshape((2,) + lead + (plan.total,)), writes, launches


# the launch shape of the card (csrc/circuit_eval.cu) and a shrunk one:
# 4 threads a block, clusters of up to 2, 3 steps a launch, a bound of 8
# gate-rows a thread (a 128-gate layer, and most layers at many rows, a
# launch of their own); the clusters that fit at once by size, as the
# card's query gives them (NVIDIA H100 80GB HBM3: 132, 66, 30, 15 and 7
# clusters of 1, 2, 4, 8 and 16 blocks of 512 threads)
SHAPES = {"card": ({}, {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}),
          "small": (dict(EVAL_THREADS=4, EVAL_CLUSTER=2, EVAL_LAYERS=3,
                         EVAL_WORK=8, EVAL_BLOCKS=6), {1: 5, 2: 2})}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lead", [(), (3,), (2, 305)])
def test_emulated_evaluate_matches_twin(lead, shape, monkeypatch):
    consts, fits = SHAPES[shape]
    for name, value in consts.items():
        monkeypatch.setattr(comp, name, value)
    rows = int(np.prod(lead))
    if shape == "card":
        c = _unary_circuit()
        cc = compile_circuit(c)
        plan = eval_arrays(cc, "cpu")["ev"]
        xs = _witnesses(c, rows).reshape(lead + (2, -1)) if lead else None
        inputs = input_buffer(cc, xs, "cpu")
    else:
        plan = _random_plan([13, 8, 16, 5, 128, 3, 40], rows)
        inputs = _canon(np.random.default_rng(rows), 2, *lead, 13)
    got, writes, launches = emulate_evaluate(inputs, plan, fits)
    want = comp.evaluate_plain(inputs, plan)
    assert np.array_equal(got, gf.to_numpy(want))
    assert (writes == 1).all()
    if shape == "card":
        assert len(launches) == 1 and launches[0][:2] == (0, cc.depth)
    else:      # several cluster launches and the 128-gate layer alone
        assert len(launches) >= 3
        assert (4, 1, 1) in [x[:3] for x in launches]


@pytest.mark.parametrize("rows", [1, 4, 16, 64])
def test_eval_launch_rule(rows):
    """randomize(14, 13)'s 14 blocks of 2^13 words are one cluster launch
    at every batch the paths use, its cluster the size whose groups carry
    the fewest rows a block (16 blocks at 1 to 16 rows, 2 at 64 on an
    H100's fits: a cluster a row on 128 SMs); a 2^18-gate layer at one row
    is a launch of its own over the card."""
    fits = SHAPES["card"][1]
    pad = 1 << 13
    steps = np.array([(0, comp.COPY, 0, 0, pad)]
                     + [((i - 1) * pad, pad, (i - 1) * pad, i * pad, pad)
                        for i in range(1, 14)], dtype=np.int64)
    (launch,) = comp.eval_launches(steps, rows, fits)
    cs, groups, per = launch[2:5]
    assert launch[:2] == (0, 14) and launch[5] == 1
    assert cs == {1: 16, 4: 16, 16: 16, 64: 2}[rows]
    assert groups * per >= rows and groups <= fits[cs]
    wide = steps.copy()
    wide[7, 1:] = (1 << 18, 6 * pad, 7 * pad, 1 << 18)
    wide[8:, 3] += (1 << 18) - pad
    got = comp.eval_launches(wide, 1, fits)
    assert [x[:3] for x in got] == [(0, 7, 16), (7, 1, 1), (8, 6, 16)]
    assert got[1][5] * comp.EVAL_THREADS == 1 << 18


def emulate_stage_tables(phase, bg, xp, src, vu, dep0):
    """csrc/fft_gkr.cu's vpt_fg_stage_tables and fg_stage_tables_kernel on
    Python-int field elements: the grid, the grid-stride loop, an item's
    stage, slots and twiddle.  Returns (addV, am) and the count of each
    word's writes."""
    S, n = bg.shape[1], bg.shape[2]
    lg = n.bit_length() - 1
    half = n >> 1
    bg, xp, src = (gf.to_numpy(t) for t in (bg, xp, src))
    vu = None if vu is None else gf.to_numpy(vu)
    out = np.zeros((2, 2, S, n), dtype=np.uint64)
    writes = Counter()
    el = lambda a, *i: Fq2.raw(int(a[(0,) + i]), int(a[(1,) + i]))
    zero = Fq2.raw(0, 0)

    def put(table, s, slot, x):
        out[table, 0, s, slot], out[table, 1, s, slot] = x.real, x.img
        writes[(table, s, slot)] += 1

    items = S << (lg - 1)
    blocks = min(-(-items // THREADS), MAX_BLOCKS)
    for b in range(blocks):
        for t in range(THREADS):
            for i in range(b * THREADS + t, items, blocks * THREADS):
                s, j = i >> (lg - 1), i & (half - 1)
                dep = dep0 + s
                k, m = j >> dep, 1 << dep
                e = (k << (dep + 1)) + (j & (m - 1))
                o = e + m
                bgA, bgB = el(bg, s, j), el(bg, s, half + j)
                xk = el(xp, n - (n >> dep) + k)
                if phase == 1:
                    put(0, s, e, ((bgA - bgB) * xk) * el(src, s, o))
                    put(0, s, o, zero)
                    put(1, s, e, bgA + bgB)
                    put(1, s, o, zero)
                else:
                    bu = el(src, s, e)
                    gA, gB = bgA * bu, bgB * bu
                    put(1, s, e, zero)
                    put(1, s, o, (gA - gB) * xk)
                    put(0, s, e, zero)
                    put(0, s, o, (gA + gB) * el(vu, s))
    return out, writes


@pytest.mark.parametrize("lg", [1, 3, 5])
def test_emulated_stage_tables_match_twin(lg):
    bg, V, bu, vu = _stage_inputs(lg, 10 + lg)
    xp = fft_gkr.stage_powers(lg, "cpu")
    for S, dep0 in {(lg, 0), (1, lg - 1), (1, 0)}:
        sl = slice(dep0, dep0 + S)
        for phase, src in ((1, V), (2, bu)):
            args = (phase, bg[:, sl], xp, src[:, sl],
                    vu[:, sl] if phase == 2 else None, dep0)
            got, writes = emulate_stage_tables(*args)
            want = fft_gkr.stage_tables_plain(*args)
            assert all(np.array_equal(got[k], gf.to_numpy(w))
                       for k, w in enumerate(want)), (S, dep0, phase)
            assert len(writes) == 2 * S * (1 << lg)
            assert set(writes.values()) == {1}


def test_cpu_routes_to_twins_and_cuda_wrappers_refuse_cpu():
    c = _randomize(3, 3, 1)
    cc = compile_circuit(c)
    arrs = eval_arrays(cc, "cpu")
    plain, launches = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
    evaluate(cc, input_buffer(cc, None, "cpu"), arrs)
    bg, V, bu, vu = _stage_inputs(3, 1)
    xp = fft_gkr.stage_powers(3, "cpu")
    fft_gkr.stage_tables(1, bg, xp, V, None, 0)
    fft_gkr.stage_tables(2, bg, xp, bu, vu, 0)
    assert kernels.PLAIN_CALLS["gf_evaluate"] == plain["gf_evaluate"] + 1
    assert kernels.PLAIN_CALLS["fg_stage_tables"] == (
        plain["fg_stage_tables"] + 2)
    assert kernels.LAUNCHES == launches
    with pytest.raises(ValueError, match="CUDA"):
        comp.evaluate_cuda(input_buffer(cc, None, "cpu"), arrs["ev"])
    with pytest.raises(ValueError, match="CUDA"):
        fft_gkr.stage_tables_cuda(1, bg, xp, V, None, 0)
