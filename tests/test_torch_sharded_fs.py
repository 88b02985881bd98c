"""The port's sharded Fiat–Shamir prover == the JAX package's.

The ranks run on the CPU over gloo, started by ``parallel.mesh.spawn``
(rank-side code: tests/torch_mesh_ranks.py).

* ``make_fs_sharded_prover`` on randomize(4, 3, seed=3) (the circuit of
  tests/test_torch_fs_prove.py), seeded by the same root, equals the JAX
  ``make_fs_prover``: every LayerProof field, every challenge and the
  final sponge state, at S = 2 and at S = 4, where the dad tables of 1 and
  2 bits stay whole.
* ``prove_fs_sharded`` of randomize(3, 7, seed=9) at S = 2 equals the
  single-device ``driver.prove_fs`` in every proof array (meta adds
  ``mesh_shards``).  The JAX FS provers cost a minute (``prove_fs``) to
  minutes (``prove_fs_sharded``, 216 s in tests/test_fs_mesh.py) on the
  CPU, so the reference is the port's ``prove_fs``, which
  tests/test_torch_fs_e2e.py holds against the JAX ``prove_fs`` on this
  circuit.  The port's and the JAX ``verify_fs`` accept the sharded proof
  and reject it with one claim changed.

Tolerance 0 throughout."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from virgo_plus_tpu import driver as jdriver
from virgo_plus_tpu.circuits.compile import compile_circuit, input_buffer
from virgo_plus_tpu.gkr import fs as jfs
from virgo_plus_tpu.gkr import protocol as jprotocol

from virgo_plus_tpu_torch import driver
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.parallel import mesh as pmesh

import torch_mesh_ranks as ranks
from test_torch_prove import _equal_proofs
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
FIELDS = ("p1_polys", "claim_u", "p2_polys", "claims_v", "liu_polys",
          "liu_claim")
CHALLENGES = ("r_u", "assert_r", "r_v", "sig", "r_liu")
TIMEOUT = 240


def _circuit(n, bits, seed):
    c = randomize(n, bits, seed=seed)
    subset_init(c)
    return c


def _tampered(full):
    """full with layer 1's claim_u changed by one."""
    layers = [None] + [dict(lp) for lp in full.layers[1:]]
    layers[1]["claim_u"] = (layers[1]["claim_u"] + np.uint64(1)) % \
        np.uint64(MOD)
    return dataclasses.replace(full, layers=layers)


def _prove_and_jax_verify(c, small, root_l):
    """The S = 2 ranks, then the JAX verify_fs of their proof and of that
    proof tampered."""
    outs = pmesh.spawn(ranks.fs, 1, 2, "cpu", timeout=TIMEOUT,
                       args=(c, small, root_l))
    jcp = jdriver.compile_prover(c)
    full = outs[0]["full"]
    return outs, (jdriver.verify_fs(c, full, jcp).ok,
                  jdriver.verify_fs(c, _tampered(full), jcp).ok)


@pytest.fixture(scope="module")
def run():
    c = _circuit(3, 7, 9)
    small = _circuit(4, 3, 3)
    root_l = np.arange(4, dtype=np.uint64) + 7
    # the ranks and the JAX verifier run while this thread computes the
    # JAX prover's reference
    with ThreadPoolExecutor(2) as pool:
        futures = {2: pool.submit(_prove_and_jax_verify, c, small, root_l),
                   4: pool.submit(pmesh.spawn, ranks.fs, 1, 4, "cpu",
                                  timeout=TIMEOUT, args=(None, small, root_l))}
        jcc = compile_circuit(small)
        values = jprotocol.make_evaluator(jcc)(input_buffer(jcc))
        jproof, jch, jD = jfs.make_fs_prover(jcc, jprotocol.build_plans(jcc))(
            values, jnp.asarray(root_l))
        cp = driver.compile_prover(c, device="cpu")
        ref, _ = driver.prove_fs(c, cp)
        out, jax_verdicts = futures[2].result()
        out = {2: out, 4: futures[4].result()}
    return dict(c=c, cp=cp, out=out, ref=ref, jproof=jproof, jch=jch, jD=jD,
                jax_verdicts=jax_verdicts)


def _same(x, y):
    if x is None or y is None:
        return x is None and y is None
    y = np.asarray(y)
    return x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("S", [2, 4])
def test_fs_sharded_gkr_matches_jax(run, S):
    got = run["out"][S][0]
    jproof, jch = run["jproof"], run["jch"]
    assert _same(got["gkr"]["vres"], jproof.vres)
    assert _same(got["r_out"], jch.r_out)
    assert _same(got["D"], run["jD"])
    for i in range(1, len(jproof.layers)):
        for k in FIELDS:
            assert _same(got["gkr"]["layers"][i][k],
                         getattr(jproof.layers[i], k)), (i, k)
        for k in CHALLENGES:
            assert _same(got["ch_layers"][i][k],
                         getattr(jch.layers[i], k)), (i, k)
    assert all(_same(o["D"], run["jD"]) for o in run["out"][S])


def test_prove_fs_sharded_matches_prove_fs(run):
    full, ref = run["out"][2][0]["full"], run["ref"]
    assert full.meta == dict(ref.meta, mesh_shards=2)
    assert _equal_proofs(dataclasses.replace(full, meta=ref.meta), ref)
    assert all(_equal_proofs(o["full"], full) for o in run["out"][2])


def test_both_verifiers_accept_and_reject_a_tamper(run):
    c, cp, full = run["c"], run["cp"], run["out"][2][0]["full"]
    assert driver.verify_fs(c, full, cp).ok
    assert not driver.verify_fs(c, _tampered(full), cp).ok
    assert run["jax_verdicts"] == (True, False)

