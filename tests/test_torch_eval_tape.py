"""Circuit evaluation (``circuits/compile.py``: ``gf_eval_layer``) and the
fft_gkr tape's stage tables (``pc/fft_gkr.py``: ``fg_stage_tables``) on
the CPU against the JAX package and the per-stage formulas, and the
kernels' index arithmetic emulated on the host.

On a CUDA tensor ``evaluate`` is a zero fill, the input copy and one
``gf_eval_layer`` launch a layer, and the tape's ifft stages are one
``fg_stage_tables`` launch a phase between two K1 calls that fold every
stage at once; on a CPU tensor the launches are the plain twins
(``eval_layer_plain``, ``stage_tables_plain``).  Here:

* ``evaluate`` == JAX ``evaluate`` on randomize(4, 3), on a batch of
  witnesses (2, B, n) row by row, and on a circuit with unary gates, right
  inputs from layer 0 and a layer of 13 gates (its padding stays zero);
* ``stage_tables_plain`` == the tape's per-stage formulas (each stage's
  tables built alone and interleaved, with ``fft.powers`` twiddles) at
  lg = 1, 3 and 5, and ``stage_powers`` == ``fft.powers`` stage by stage;
* ``emulate_eval_layer`` and ``emulate_stage_tables``, host copies of
  ``csrc/circuit_eval.cu``'s and ``csrc/fft_gkr.cu``'s index arithmetic
  (grid, rows a block, slots an item) on Python-int field elements,
  == the twins, writing every output word exactly once;
* a CPU call counts ``kernels.PLAIN_CALLS`` and launches nothing; the CUDA
  wrappers refuse CPU tensors.

The whole tape against JAX ``make_fg_tape`` (lg = 1 and 3) is in
``tests/test_torch_pc.py``.  Inputs are canonical, from the circuits'
witnesses and numpy with a seed; field arithmetic is exact, so the
tolerance is 0.  The kernels run only on a card: chip_smoke.py holds them
against the twins there."""

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
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.field.ref import Fq2
from virgo_plus_tpu_torch.pc import fft, fft_gkr

M = gf.MOD
THREADS = 256                 # csrc/circuit_eval.cu, csrc/fft_gkr.cu
TARGET_BLOCKS = 132 * 2       # csrc/circuit_eval.cu
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


def emulate_eval_layer(values, x_idx, y_idx, co, x_off, out_off):
    """csrc/circuit_eval.cu's vpt_gf_eval_layer and gf_eval_layer_kernel on
    Python-int field elements: the grid and rows a block as the C entry
    picks them, a thread a gate over its block's rows.  Returns the new
    values (numpy) and the count of each word's writes."""
    v = gf.to_numpy(values).reshape(2, -1, values.shape[-1]).copy()
    rows, size = v.shape[1], x_idx.numel()
    x_idx, y_idx, co = x_idx.tolist(), y_idx.tolist(), gf.to_numpy(co)
    bx = -(-size // THREADS)
    want = -(-TARGET_BLOCKS // bx)
    split = min(want, rows)
    per = -(-rows // split)
    writes = Counter()
    el = lambda r, i: Fq2.raw(int(v[0, r, i]), int(v[1, r, i]))
    for by in range(-(-rows // per)):
        for b in range(bx):
            for t in range(THREADS):
                g = b * THREADS + t
                if g >= size:
                    continue
                A, B, C, D = (Fq2.raw(int(co[k, 0, g]), int(co[k, 1, g]))
                              for k in range(4))
                xi, yi, oi = x_off + x_idx[g], y_idx[g], out_off + g
                for r in range(by * per, min(rows, by * per + per)):
                    x, y = el(r, xi), el(r, yi)
                    out = A * x + B * y + (C * (x * y) + D)
                    v[0, r, oi], v[1, r, oi] = out.real, out.img
                    writes[(r, oi)] += 1
    return v.reshape(tuple(values.shape)), writes


@pytest.mark.parametrize("lead", [(), (3,), (2, 305)])
def test_emulated_eval_layer_matches_twin(lead):
    c = _unary_circuit()
    cc = compile_circuit(c)
    arrs = eval_arrays(cc, "cpu")
    rows = int(np.prod(lead))
    xs = _witnesses(c, rows).reshape(lead + (2, -1)) if lead else None
    inputs = input_buffer(cc, xs, "cpu")
    values = torch.zeros(inputs.shape[:-1] + (cc.total_values,),
                         dtype=torch.int64)
    values[..., :inputs.shape[-1]] = inputs
    for i in range(1, cc.depth):
        args = (arrs[f"x{i}"], arrs[f"y{i}"], arrs[f"co{i}"],
                int(cc.value_off[i - 1]), int(cc.value_off[i]))
        got, writes = emulate_eval_layer(values, *args)
        values = comp.eval_layer_plain(values.clone(), *args)
        assert np.array_equal(got, gf.to_numpy(values)), i
        size = cc.layers[i].size
        assert len(writes) == rows * size and set(writes.values()) == {1}
    assert torch.equal(values, evaluate(cc, inputs, arrs))


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
    assert kernels.PLAIN_CALLS["gf_eval_layer"] == (
        plain["gf_eval_layer"] + cc.depth - 1)
    assert kernels.PLAIN_CALLS["fg_stage_tables"] == (
        plain["fg_stage_tables"] + 2)
    assert kernels.LAUNCHES == launches
    values = torch.zeros((2, cc.total_values), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        comp.eval_layer_cuda(values, arrs["x1"], arrs["y1"], arrs["co1"],
                             0, int(cc.value_off[1]))
    with pytest.raises(ValueError, match="CUDA"):
        fft_gkr.stage_tables_cuda(1, bg, xp, V, None, 0)
