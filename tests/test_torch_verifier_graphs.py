"""The port's GKR verifier programs (graphs.py makers) == the JAX package's.

On ``randomize(4, 3, seed=7)`` (the circuit of tests/test_gkr.py) and a
proof under the glibc challenge stream, the port's
``protocol.make_verifier`` (staged, unstaged and ``graphed=False``) and
``protocol.verify`` equal the JAX ``make_verifier(staged=…)`` (whose
unstaged form is one jit of the JAX ``verify``) in ``ok``, the final claim
and the final point, with and without ``output_values``; every form
rejects a proof with one round-polynomial coefficient changed and a wrong
output block, through the same holder as the good proof (a graph decides
on the card, not the host).  On small1200 a graphed ``compile_prover``'s
``driver.verify`` and ``verify_fs`` accept and equal the eager verifier's
claim and point (the JAX verifier takes minutes there on the CPU).  The
JAX references run once, each in a process of its own.  Tolerance 0."""

import dataclasses
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

from virgo_plus_tpu_torch import convert, driver, graphs
from virgo_plus_tpu_torch.circuits.compile import input_buffer
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

from test_reference_parity import FIXTURE
from test_torch_fs_prove import FIELDS
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
FORMS = {"staged": (True, True), "unstaged": (False, True),
         "eager": (True, False)}
# (proof, output block) of each case
CASES = {"out": ("good", "out"), "no_out": ("good", None),
         "tampered": ("bad", "out"), "tampered_no_out": ("bad", None),
         "wrong_out": ("good", "wrong")}


def _circuit():
    c = randomize(4, 3, seed=7)
    subset_init(c)
    return c


def _jax_job(staged, proofs, blocks):
    """The JAX make_verifier of one ``staged`` on every case, in a process
    of its own: {case: (ok, final_claim, final_point)} as numpy."""
    import jax.numpy as jnp

    jcc = jcompile(_circuit())
    ch = jprotocol.make_challenges(jcc, JGlibc(3396))
    J = lambda a: None if a is None else jnp.asarray(a)
    jproofs = {k: jprotocol.Proof(vres=J(p["vres"]), layers=[None] + [
        jprotocol.LayerProof(**{f: J(v) for f, v in lp.items()})
        for lp in p["layers"][1:]]) for k, p in proofs.items()}
    verify = jprotocol.make_verifier(jcc, staged=staged)
    return {case: tuple(np.asarray(x) for x in verify(
        jproofs[p], ch, J(blocks.get(b)))) for case, (p, b) in CASES.items()}


def _bumped(proof, depth):
    """The proof with one phase-1 coefficient of the top layer changed."""
    lp = proof.layers[depth - 1]
    p1 = gf.to_numpy(lp.p1_polys).copy()
    p1[0, 0, 1] = np.uint64((int(p1[0, 0, 1]) + 1) % MOD)
    layers = list(proof.layers)
    layers[depth - 1] = dataclasses.replace(lp, p1_polys=gf.tensor(p1))
    return protocol.Proof(vres=proof.vres, layers=layers)


@pytest.fixture(scope="module")
def run():
    """The port's proof (and a tampered one), output blocks, the JAX
    verifiers on them (staged and unstaged, a process each), and
    meanwhile small1200's graphed compiled prover and proofs."""
    c = _circuit()
    cp = driver.compile_prover(c, device="cpu", graphed=False)
    cc = cp.cc
    values = cp.evaluator(input_buffer(cc, None, "cpu"))
    ch = protocol.make_challenges(cc, GlibcRandom(3396), "cpu")
    good = cp.prover(values, ch)
    proofs = {"good": good, "bad": _bumped(good, cc.depth)}
    out = values[:, int(cc.value_off[cc.depth - 1]):]
    wrong = gf.to_numpy(out).copy()
    wrong[0, 0] = np.uint64((int(wrong[0, 0]) + 1) % MOD)
    blocks = {"out": out, "wrong": gf.tensor(wrong)}
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        futures = {s: pool.submit(
            _jax_job, s, {k: convert.proof_to_numpy(p)
                          for k, p in proofs.items()},
            {k: gf.to_numpy(b) for k, b in blocks.items()})
            for s in (True, False)}
        small = driver.load_circuit(FIXTURE)
        small_cp = driver.compile_prover(small, device="cpu")
        small_full = driver.prove(small, small_cp)[0]
        small_fs = driver.prove_fs(small, small_cp)[0]
        ref = {s: f.result() for s, f in futures.items()}
    return dict(cc=cc, ch=ch, proofs=proofs, blocks=blocks, ref=ref,
                small=(small, small_cp, small_full, small_fs))


def _check(got, want):
    ok, claim, point = got
    assert bool(ok) == bool(want[0])
    assert np.array_equal(gf.to_numpy(claim), want[1])
    assert np.array_equal(gf.to_numpy(point), want[2])


def test_jax_verifier_forms_agree(run):
    for case in CASES:
        a, b = run["ref"][True][case], run["ref"][False][case]
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), case
    assert bool(run["ref"][True]["out"][0])
    assert not any(bool(run["ref"][True][c][0])
                   for c in ("tampered", "tampered_no_out", "wrong_out"))


@pytest.mark.parametrize("form", FORMS)
def test_verifier_matches_jax(run, form):
    """Each case through one verifier, in CASES order: the good proof
    builds the holders, the tampered proof and the wrong block replay
    them."""
    staged, graphed = FORMS[form]
    verify = protocol.make_verifier(run["cc"], "cpu", staged, graphed)
    for case, (p, b) in CASES.items():
        got = verify(run["proofs"][p], run["ch"], run["blocks"].get(b))
        assert isinstance(got[0], bool)
        _check(got, run["ref"][staged][case])
        fast, slow = verify.last_split
        assert fast > 0 and slow >= 0
    names = sorted(h.name for h in graphs.holders(verify))
    assert names == {"staged": ["verifier fast_all #0",
                                "verifier fast_all_out #0",
                                "verifier slow_all #0"],
                     "unstaged": ["verifier #0", "verifier #1"],
                     "eager": []}[form]
    assert all(h.replays >= 2 for h in graphs.holders(verify)
               if "slow" not in h.name)


@pytest.mark.parametrize("case", CASES)
def test_verify_matches_jax(run, case):
    """protocol.verify, the one-walk body (JAX ``verify``), as
    verify_layer layer by layer."""
    p, b = CASES[case]
    _check(protocol.verify(run["cc"], run["proofs"][p], run["ch"],
                           run["blocks"].get(b)), run["ref"][False][case])


def test_verify_layer_chains_to_verify(run):
    """verify_layer from the top layer down reaches verify's final claim,
    and each layer of the honest proof holds."""
    cc, ch, proof = run["cc"], run["ch"], run["proofs"]["good"]
    varrs = protocol.verifier_arrays(cc, "cpu")
    claim, r_cur = proof.vres, ch.r_out
    for i in range(cc.depth - 1, 0, -1):
        ok, claim = protocol.verify_layer(cc, i, proof.layers[i], r_cur,
                                          ch.layers[i], claim, proof, ch,
                                          varrs)
        assert bool(ok), i
        r_cur = ch.layers[i].r_liu[:, :cc.layers[i - 1].bit_length]
    _check((True, claim, r_cur), run["ref"][True]["out"])


def test_release_empties_the_verifier(run):
    verify = protocol.make_verifier(run["cc"], "cpu")
    good = run["proofs"]["good"]
    want = verify(good, run["ch"], None)
    assert len(graphs.holders(verify)) == 2
    graphs.release(verify)
    assert graphs.holders(verify) == []
    _check(verify(good, run["ch"], None),
           tuple(gf.to_numpy(x) if not isinstance(x, bool) else x
                 for x in want))
    assert [h.replays for h in graphs.holders(verify)] == [1, 1]


def test_small1200_graphed_driver_verify(run):
    """small1200: a graphed compile_prover's driver.verify and verify_fs
    accept through its verifier's holders, with the eager verifier's
    final claim and point, and reject a tampered proof."""
    c, cp, full, full_fs = run["small"]
    rep = driver.verify(c, full, cp)
    assert rep.ok and rep.verify_time_slow > 0
    assert driver.verify_fs(c, full_fs, cp).ok
    # FS challenges are as long as each layer needs, glibc ones as the
    # longest: two argument shapes, a holder each
    held = graphs.holders(cp.verifier)
    assert sorted(h.name for h in held) == [
        "verifier fast_all #0", "verifier fast_all #1",
        "verifier slow_all #0", "verifier slow_all #1"]
    assert all(h.replays == 1 for h in held)
    proof = protocol.Proof(
        vres=gf.tensor(full.vres), layers=[None] + [
            protocol.LayerProof(**{k: None if full.layers[i][k] is None
                                   else gf.tensor(full.layers[i][k])
                                   for k in FIELDS})
            for i in range(1, cp.cc.depth)])
    ch = protocol.make_challenges(cp.cc, GlibcRandom(3396), "cpu")
    eager = protocol.make_verifier(cp.cc, "cpu", graphed=False)
    want = eager(proof, ch)
    got = cp.verifier(proof, ch)
    assert got[0] and want[0]
    _check(got, tuple(gf.to_numpy(x) if not isinstance(x, bool) else x
                      for x in want))
    bad = _bumped(proof, cp.cc.depth)
    assert not cp.verifier(bad, ch)[0] and not eager(bad, ch)[0]
    assert len(graphs.holders(cp.verifier)) == 4
