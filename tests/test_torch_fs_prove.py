"""The port's Fiat-Shamir GKR prover and verifier == the JAX package's.

On ``randomize(4, 3, seed=3)`` (the circuit of tests/test_fs.py) the port's
``make_fs_prover``, given the JAX package's circuit values and a synthetic
commitment root through ``convert``, gives every LayerProof field, every
challenge and the final sponge state of the JAX ``make_fs_prover``;
``derive_challenges`` re-derives the same challenges as the JAX one; and
``fs_verify`` accepts both packages' proofs and rejects a tampered round
polynomial.  Everything runs on the CPU; tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest

from virgo_plus_tpu.circuits.compile import compile_circuit
from virgo_plus_tpu.gkr import fs as jfs
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu_torch import convert
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import fs, protocol

import torch_shared  # one torch thread; the session's JAX reference

MOD = (1 << 61) - 1
FIELDS = torch_shared.FS_LAYER_FIELDS
CHALLENGES = torch_shared.FS_CHALLENGE_FIELDS


def _same(port, jax_value):
    if port is None or jax_value is None:
        return port is None and jax_value is None
    x, y = gf.to_numpy(port), np.asarray(jax_value)
    return x.shape == y.shape and np.array_equal(x, y)


def _port_proof(jproof):
    """A JAX GKR Proof -> the port's, as CPU tensors."""
    T = lambda a: None if a is None else convert.tensor(a)
    return protocol.Proof(vres=T(jproof.vres), layers=[None] + [
        protocol.LayerProof(**{k: T(getattr(lp, k)) for k in FIELDS})
        for lp in jproof.layers[1:]])


def _jax_proof(proof):
    """A port GKR Proof -> the JAX package's."""
    n = convert.proof_to_numpy(proof)
    J = lambda a: None if a is None else jnp.asarray(a)
    return jprotocol.Proof(vres=J(n["vres"]), layers=[None] + [
        jprotocol.LayerProof(**{k: J(v) for k, v in lp.items()})
        for lp in n["layers"][1:]])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    c = randomize(4, 3, seed=3)
    subset_init(c)
    jcc = compile_circuit(c)
    # the JAX make_fs_prover's results, made once a session
    ref = torch_shared.jax_fs_reference(tmp_path_factory)
    J = lambda k: jnp.asarray(ref[k]) if k in ref else None
    jproof = jprotocol.Proof(vres=J("vres"), layers=[None] + [
        jprotocol.LayerProof(**{k: J(f"L{i}.{k}") for k in FIELDS})
        for i in range(1, jcc.depth)])
    jch = jprotocol.Challenges(r_out=J("r_out"), layers=[None] + [
        jprotocol.LayerChallenges(**{k: J(f"C{i}.{k}") for k in CHALLENGES})
        for i in range(1, jcc.depth)])
    values, root_l, jD = ref["values"], ref["root_l"], J("D")
    cc = convert.compiled_circuit(jcc)
    plans = protocol.build_plans(cc)
    arrs = protocol.circuit_arrays(cc, plans, "cpu")
    proof, ch, D = fs.make_fs_prover(cc, plans, arrs, "cpu")(
        convert.tensor(values), gf.tensor(root_l))
    return cc, jcc, root_l, proof, ch, D, jproof, jch, jD


def test_layer_proofs_match_jax(both):
    cc, jcc, root_l, proof, ch, D, jproof, jch, jD = both
    assert _same(proof.vres, jproof.vres)
    for i in range(1, cc.depth):
        for k in FIELDS:
            assert _same(getattr(proof.layers[i], k),
                         getattr(jproof.layers[i], k)), (i, k)
    # the circuit has phase-2 tables, so the joint phase 2 ran
    assert any(proof.layers[i].p2_polys is not None
               and proof.layers[i].p2_polys.shape[0] > 0
               for i in range(1, cc.depth))


def test_challenges_and_final_state_match_jax(both):
    cc, jcc, root_l, proof, ch, D, jproof, jch, jD = both
    assert _same(ch.r_out, jch.r_out)
    for i in range(1, cc.depth):
        for k in CHALLENGES:
            assert _same(getattr(ch.layers[i], k),
                         getattr(jch.layers[i], k)), (i, k)
    assert _same(D, jD)


def test_derive_challenges_matches_jax(both):
    cc, jcc, root_l, proof, ch, D, jproof, jch, jD = both
    got, sp = fs.derive_challenges(cc, proof, root_l, "cpu")
    want, jsp = jfs.derive_challenges(jcc, jproof, root_l)
    assert _same(got.r_out, want.r_out)
    for i in range(1, cc.depth):
        for k in CHALLENGES:
            assert _same(getattr(got.layers[i], k),
                         getattr(want.layers[i], k)), (i, k)
    # the verifier's sponge ends where the prover's device sponge did
    assert sp.state == jsp.state == gf.to_numpy(D).astype("<u8").tobytes()


def test_fs_verify_accepts_port_proof(both):
    cc, jcc, root_l, proof, *_ = both
    ok, _claim, _point = fs.fs_verify(cc, proof, root_l)
    assert ok
    assert bool(jfs.fs_verify(jcc, _jax_proof(proof), root_l)[0])


def test_fs_verify_accepts_jax_proof(both):
    cc, jcc, root_l, proof, ch, D, jproof, *_ = both
    ok, _claim, _point = fs.fs_verify(cc, _port_proof(jproof), root_l)
    assert ok


def test_fs_verify_rejects_tampered_round_poly(both):
    cc, jcc, root_l, proof, *_ = both
    bad = _port_proof(_jax_proof(proof))
    lp = bad.layers[cc.depth - 1]
    p1 = lp.p1_polys.clone()
    p1[0, 0, 1] = (int(p1[0, 0, 1]) + 1) % MOD
    lp.p1_polys = p1
    ok, _claim, _point = fs.fs_verify(cc, bad, root_l)
    assert not ok
