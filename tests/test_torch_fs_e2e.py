"""The port's Fiat-Shamir prove and verify == the JAX package's, end to end.

On ``randomize(3, 7, seed=9)`` (the circuit of tests/test_fs.py) the port's
``driver.prove_fs`` on the CPU equals the JAX ``driver.prove_fs`` in every
FullProof field and in its proof sizes; each package's ``verify_fs``
accepts the other's proof; a proof read back from its .npz still verifies;
the port's ``verify_fs`` rejects every tamper shape; and ``driver.run`` in
FS mode is ok.  Tolerance 0."""

import numpy as np
import pytest

from virgo_plus_tpu import driver as jdriver
from virgo_plus_tpu_torch import driver, proof_io
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.config import ProtocolConfig

from test_torch_prove import _bump, _equal_proofs, _saved
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1


@pytest.fixture(scope="module")
def both():
    c = randomize(3, 7, seed=9)
    subset_init(c)
    cp = driver.compile_prover(c, device="cpu")
    full, info = driver.prove_fs(c, cp)
    jcp = jdriver.compile_prover(c)
    jfull, jinfo = jdriver.prove_fs(c, jcp)
    return c, cp, full, info, jcp, jfull, jinfo


def test_fs_proof_matches_jax(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    assert full.meta["mode"] == 1
    assert _equal_proofs(full, jfull)
    assert info["gkr_proof_size"] == jinfo["gkr_proof_size"]
    assert info["pc_proof_size"] == jinfo["pc_proof_size"]
    assert set(info["phases"]) == {"eval_commit", "gkr", "pc", "queries"}


def test_jax_verify_fs_accepts_port_proof(both):
    c, cp, full, info, jcp, *_ = both
    assert jdriver.verify_fs(c, full, jcp).ok


def test_port_verify_fs_accepts_jax_proof(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    rep = driver.verify_fs(c, jfull, cp)
    assert rep.ok and rep.gkr_ok and rep.pc_ok
    assert set(rep.details["phases"]) == {"challenges", "gkr_walk",
                                          "q_prepare", "fft_replay",
                                          "queries"}


def test_fs_proof_file_roundtrip_verifies(both):
    c, cp, full, *_ = both
    assert driver.verify_fs(c, proof_io.load(_saved(full)), cp).ok


def _tamper(full, shape):
    f = proof_io.load(_saved(full))
    if shape == "round_poly":
        f.layers[1]["p1_polys"] = _bump(f.layers[1]["p1_polys"], (0, 0, 1))
    elif shape == "liu_claim":
        f.layers[1]["liu_claim"] = _bump(f.layers[1]["liu_claim"], (1,))
    elif shape == "all_sum":
        f.all_sum = _bump(f.all_sum, (0, 0))
    elif shape == "forged_final_codeword":
        f.final_codeword = np.zeros_like(f.final_codeword)
    elif shape == "query_value":
        f.queries.init_l_vals = f.queries.init_l_vals.copy()
        f.queries.init_l_vals[0, 3, 0, 0] ^= np.uint64(1)
    elif shape == "fft_gkr_message":
        m = f.fft_gkr_messages[2].copy()
        m.flat[0] = (int(m.flat[0]) + 1) % MOD
        f.fft_gkr_messages[2] = m
    elif shape == "level_root":
        f.level_roots = f.level_roots.copy()
        f.level_roots[0, 0] ^= np.uint64(1)
    return f


@pytest.mark.parametrize("shape", ["round_poly", "liu_claim", "all_sum",
                                   "forged_final_codeword", "query_value",
                                   "fft_gkr_message", "level_root"])
def test_port_verify_fs_rejects_tampered_proof(both, shape):
    c, cp, full, *_ = both
    assert not driver.verify_fs(c, _tamper(full, shape), cp).ok


def test_run_fs_mode(both):
    c, cp, *_ = both
    rep = driver.run(circuit=c, compiled=cp,
                     config=ProtocolConfig(transcript="fs"), device="cpu")
    assert rep.ok and rep.pc_proof_size > 0 and rep.prove_time > 0
