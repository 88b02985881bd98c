"""The port's evaluation, beta-table and polynomial-commitment modules ==
the JAX package's, bit for bit, at small sizes.

Every input comes from numpy with a seed (or from a ``randomize`` circuit)
and goes through both packages; field arithmetic and SHA3 are exact, so the
tolerance is zero."""

import numpy as np
import pytest
import jax

from virgo_plus_tpu import fused as jfused
from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
from virgo_plus_tpu.circuits.compile import input_buffer as jinput
from virgo_plus_tpu.circuits.layered import randomize as jrandomize
from virgo_plus_tpu.circuits.layered import subset_init as jsubset
from virgo_plus_tpu.gkr import beta as jbeta
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.pc import fft as jfft
from virgo_plus_tpu.pc import fft_gkr as jfft_gkr
from virgo_plus_tpu.pc import merkle as jmerkle
from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

from virgo_plus_tpu_torch import convert, fused
from virgo_plus_tpu_torch.circuits.compile import evaluate
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import beta
from virgo_plus_tpu_torch.pc import fft, fft_gkr, merkle, virgo_pc
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
BL = 8          # input bits: 64 slices of 4, codewords of 128 per slice


def _field(seed, *shape):
    return np.random.default_rng(seed).integers(0, M, size=(2,) + shape,
                                                dtype=np.uint64)


def _eq(t, ref):
    return np.array_equal(gf.to_numpy(t), np.asarray(ref))


def test_evaluate_matches_jax():
    c = jrandomize(3, 7, seed=21)
    jsubset(c)
    jcc = jcompile(c)
    inputs = jinput(jcc)
    want = jprotocol.make_evaluator(jcc)(inputs)
    cc = convert.compiled_circuit(jcc)
    arrs = convert.circuit_arrays(
        jprotocol.circuit_arrays(jcc, jprotocol.build_plans(jcc)), cc)
    assert _eq(evaluate(cc, convert.tensor(inputs), arrs), want)


def test_beta_tables_match_jax():
    r = _field(1, 3, 9)
    init = _field(2, 3)
    want = jax.jit(lambda r, i: jbeta.beta_tables_batched(r, 9, i))(r, init)
    got = beta.beta_tables_batched(gf.tensor(r), 9, gf.tensor(init))
    assert _eq(got, want)
    for k in range(3):
        assert _eq(beta.beta_table(gf.tensor(r[:, k]), 9,
                                   gf.tensor(init[:, k])), want[:, k])


@pytest.mark.parametrize("lg_coef,lg_order", [(3, 3), (4, 7), (6, 9)])
def test_fft_and_ifft_match_jax(lg_coef, lg_order):
    x = _field(lg_order, 1 << lg_coef)
    rou = gf.root_of_unity_int(lg_order)
    assert _eq(fft.fft(gf.tensor(x), lg_order, rou),
               jax.jit(lambda v: jfft.fft(v, lg_order, rou))(x))
    rou_c = gf.root_of_unity_int(lg_coef)
    back = fft.ifft(fft.fft(gf.tensor(x), lg_coef, rou_c), rou_c)
    assert _eq(back, x)
    batch = _field(9, 5, 1 << lg_coef)     # batched over a leading axis
    got = fft.ifft(gf.tensor(batch), rou_c)
    want = jax.jit(jax.vmap(lambda v: jfft.ifft(v, rou_c), in_axes=1,
                            out_axes=1))(batch)
    assert _eq(got, want)


def test_merkle_trees_match_jax():
    rng = np.random.default_rng(3)
    leaves = [rng.integers(0, 2 ** 64, size=(4, n), dtype=np.uint64)
              for n in (1, 8, 32)]
    got = merkle.forest(gf.tensor(np.concatenate(leaves, axis=1)),
                        [lv.shape[1] for lv in leaves])
    for lv, tree in zip(leaves, got):
        want = jax.jit(jmerkle.create_tree)(lv)
        assert _eq(tree, want)
        assert _eq(merkle.create_tree(gf.tensor(lv)), want)


def test_commit_and_folds_match_jax():
    values = _field(4, 1 << BL)
    q = _field(5, 1 << BL)
    rands = [_field(6 + k, 1)[:, 0] for k in range(BL - virgo_pc.LOG_SLICE)]

    l_or, l_coefs = virgo_pc.commit_private(gf.tensor(values), BL)
    jl_or, jl_coefs = jax.jit(lambda v: jvpc.commit_private(v, BL))(values)
    for name in ("codeword", "leaves", "tree"):
        assert _eq(getattr(l_or, name), getattr(jl_or, name)), name
    assert _eq(l_coefs, jl_coefs)

    pub = virgo_pc.commit_public(l_or.codeword, gf.tensor(q), BL)
    jpub = jax.jit(lambda l, q: jvpc.commit_public(l, q, BL))(
        jl_or.codeword, q)
    assert _eq(pub[0].tree, jpub[0].tree)
    for got, want in zip(pub[1:], jpub[1:]):
        assert _eq(got, want)

    ldt = virgo_pc.commit_phase(pub[4], BL, [gf.tensor(r) for r in rands])
    jldt = jax.jit(lambda vo, rs: jvpc.commit_phase(vo, BL, list(rs)))(
        jpub[4], tuple(rands))
    assert _eq(ldt.final_codeword, jldt.final_codeword)
    for o, jo in zip(ldt.oracles, jldt.oracles):
        assert _eq(o.codeword, jo.codeword) and _eq(o.tree, jo.tree)


@pytest.mark.parametrize("lg", [1, 3])
def test_fft_gkr_tape_matches_jax(lg):
    sched = fft_gkr.draw_schedule(lg, GlibcRandom(11))
    jsched = jfft_gkr.draw_schedule(lg, JGlibc(11))
    got = fused.fg_tape(lg, sched, "cpu")
    want = jfused.make_fg_tape(lg)(jsched)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _eq(g, w)


def test_fft_gkr_replay_accepts_recorded_tape():
    lg = 3
    fg = fft_gkr.run(lg, GlibcRandom(12), device="cpu")
    assert fg.ok and fg.proof_size == fft_gkr.fft_gkr_proof_size(lg)
    assert fft_gkr.run(lg, GlibcRandom(12), replay=fg.messages,
                       device="cpu").ok
    bad = [m.copy() for m in fg.messages]
    bad[2].flat[0] = (int(bad[2].flat[0]) + 1) % M
    assert not fft_gkr.run(lg, GlibcRandom(12), replay=bad, device="cpu").ok
