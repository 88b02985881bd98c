"""Batched proving in the port == the JAX package's batched prover, and each
instance == the port's single prove.

randomize(3, 7, seed=6) with a batch of B = 3 witnesses (the edits of
tests/test_batched_full.py), proved under the JAX package's challenges
carried across with ``convert.challenges``.  The port's
``make_batched_full_prover`` must equal the JAX ``make_batched_full_prover``
in every output array, each instance must equal the port's own
``prove_e2e`` and ``driver.prove`` on its witness, and
``make_batched_prover``'s proofs must equal ``protocol.prove`` per
instance.  The batch-generic helpers are held against a per-row loop.
Everything runs on the CPU; tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
from virgo_plus_tpu.circuits.compile import input_buffer as jinput
from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.parallel.sharded import \
    make_batched_full_prover as jmake_full
from virgo_plus_tpu.pc import fft_gkr as jfft_gkr
from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

from virgo_plus_tpu_torch import convert, driver, fused
from virgo_plus_tpu_torch.circuits.compile import (compile_circuit, evaluate,
                                                   input_buffer)
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.gkr.sumcheck import (ScatterPlan,
                                               apply_scatter_arrays,
                                               mle_fold, prefix_sum)
from virgo_plus_tpu_torch.parallel.sharded import (make_batched_full_prover,
                                                   make_batched_prover)

import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
B = 3
FIELDS = ("p1_polys", "claim_u", "p2_polys", "claims_v", "liu_polys",
          "liu_claim")


def _np(x):
    return None if x is None else (gf.to_numpy(x) if torch.is_tensor(x)
                                   else np.asarray(x))


def _eq(x, y):
    x, y = _np(x), _np(y)
    if x is None or y is None:
        return x is None and y is None
    return x.shape == y.shape and np.array_equal(x, y)


@pytest.fixture(scope="module")
def run():
    """One JAX batched run and one port batched run on the same inputs."""
    c = randomize(3, 7, seed=6)
    subset_init(c)
    jcc = jcompile(c)
    jplans = jprotocol.build_plans(jcc)
    bl0 = jcc.layers[0].bit_length
    n_folds = bl0 - jvpc.LOG_SLICE
    rng = JGlibc(3396)
    jch = jprotocol.make_challenges(jcc, rng)
    jfft_gkr.draw_schedule(n_folds, rng)
    rands = [jgf.from_u64(np.uint64(r), np.uint64(i)).reshape(2)
             for (r, i) in [rng.field_element() for _ in range(n_folds)]]
    jfinal = jch.layers[1].r_liu[:, :bl0]

    xs = np.stack([np.asarray(jinput(jcc))] * B)
    xs[1, 0, 0] = (int(xs[1, 0, 0]) + 1) % MOD
    xs[2, 0, 1] = (int(xs[2, 0, 1]) + 2) % MOD
    jout = jmake_full(jcc, jplans)(jnp.asarray(xs), jch, jfinal,
                                   tuple(rands))

    cc = compile_circuit(c)
    plans = protocol.build_plans(cc)
    ch = convert.challenges(jch)
    fold_rands = [convert.tensor(r) for r in rands]
    final_point = convert.tensor(jfinal)
    out = make_batched_full_prover(cc, plans, device="cpu")(
        xs, ch, final_point, fold_rands)
    return dict(c=c, cc=cc, plans=plans, ch=ch, fold_rands=fold_rands,
                xs=xs, jout=jout, out=out)


def test_batched_full_matches_jax(run):
    proofs, *arrays = run["out"]
    jproofs, *jarrays = run["jout"]
    for got, want in zip(arrays, jarrays):
        assert _eq(got, want)
    assert _eq(proofs.vres, jproofs.vres)
    for i in range(1, run["cc"].depth):
        for k in FIELDS:
            assert _eq(getattr(proofs.layers[i], k),
                       getattr(jproofs.layers[i], k)), (i, k)


def test_batched_instances_match_single_prove(run):
    c, cc, plans, ch = run["c"], run["cc"], run["plans"], run["ch"]
    proofs, root_l, root_h, all_sum, level_roots, final_cw = run["out"]
    cp = driver.compile_prover(c, device="cpu")
    for b in range(B):
        full, _ = driver.prove(c, cp, witness=run["xs"][b])
        assert _eq(root_l[b], full.root_l), b
        assert _eq(root_h[b], full.root_h), b
        assert _eq(all_sum[b], full.all_sum), b
        assert _eq(level_roots[b], full.level_roots), b
        assert _eq(final_cw[b], full.final_codeword), b
        assert _eq(proofs.vres[b], full.vres), b
        for i in range(1, cc.depth):
            assert _eq(proofs.layers[i].p1_polys[b],
                       full.layers[i]["p1_polys"]), (b, i)
        one, l_or, h_or, asum, _q, ldt = fused.prove_e2e(
            cc, plans, input_buffer(cc, run["xs"][b], "cpu"), ch,
            run["fold_rands"], cp.arrs)
        assert _eq(root_l[b], l_or.tree[:, 1]), b
        assert _eq(root_h[b], h_or.tree[:, 1]), b
        assert _eq(all_sum[b], asum), b
        assert _eq(level_roots[b], torch.stack([o.tree[:, 1]
                                                for o in ldt.oracles])), b
        assert _eq(final_cw[b], ldt.final_codeword), b
        assert _eq(proofs.vres[b], one.vres), b
        for i in range(1, cc.depth):
            for k in FIELDS:
                got = getattr(proofs.layers[i], k)
                want = getattr(one.layers[i], k)
                assert _eq(None if got is None else got[b], want), (b, i, k)


def test_batched_prover_matches_protocol_prove(run):
    cc, plans, ch, xs = run["cc"], run["plans"], run["ch"], run["xs"]
    arrs = protocol.circuit_arrays(cc, plans, "cpu")
    proofs = make_batched_prover(cc, plans, arrs, device="cpu")(xs, ch)
    for b in range(B):
        one = protocol.prove(cc, plans, evaluate(
            cc, input_buffer(cc, xs[b], "cpu"), arrs), ch, arrs)
        assert _eq(proofs.vres[b], one.vres), b
        for i in range(1, cc.depth):
            for k in FIELDS:
                got = getattr(proofs.layers[i], k)
                want = getattr(one.layers[i], k)
                assert _eq(None if got is None else got[b], want), (b, i, k)


def test_batched_prover_rejects_a_malformed_batch(run):
    cc, plans, ch, xs = run["cc"], run["plans"], run["ch"], run["xs"]
    fn = make_batched_prover(cc, plans, protocol.circuit_arrays(
        cc, plans, "cpu"), device="cpu")
    for bad in (xs[0], xs[:, :1], np.concatenate([xs, xs], axis=2)):
        with pytest.raises(ValueError, match="witness batch"):
            fn(bad, ch)


def test_batched_provers_refuse_a_mesh(run):
    """A mesh that is not the port's ``parallel.mesh.Mesh`` raises (the dp
    axis over a port Mesh is tests/test_torch_sharded_pc.py's)."""
    with pytest.raises(TypeError, match="Mesh"):
        make_batched_prover(run["cc"], run["plans"], {}, device="cpu",
                            mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        make_batched_full_prover(run["cc"], run["plans"], device="cpu",
                                 mesh=object())


def _rows(shape=(2, 3, 37), seed=0):
    rng = np.random.default_rng(seed)
    return gf.tensor(rng.integers(0, MOD, size=shape, dtype=np.uint64))


def test_prefix_sum_batch_matches_rows():
    x = _rows()
    got = prefix_sum(x)
    for b in range(x.shape[1]):
        assert torch.equal(got[:, b], prefix_sum(x[:, b]))


def test_apply_scatter_arrays_batch_matches_rows():
    x = _rows()
    idx = np.random.default_rng(1).integers(0, 11, size=x.shape[-1])
    arrs = ScatterPlan.build(idx, 11).arrays("cpu")
    got = apply_scatter_arrays(x, arrs)
    assert got.shape == (2, x.shape[1], 11)
    for b in range(x.shape[1]):
        assert torch.equal(got[:, b], apply_scatter_arrays(x[:, b], arrs))


def test_mle_fold_batch_matches_rows():
    x = _rows((2, 3, 32))
    rs = _rows((2, 5), seed=2)
    got = mle_fold(x, rs)
    assert got.shape == (2, 3)
    for b in range(x.shape[1]):
        assert torch.equal(got[:, b], mle_fold(x[:, b], rs))
