"""The port's sharded glibc-stream provers == the JAX package's.

The ranks run on the CPU over gloo, S processes started by
``parallel.mesh.spawn`` (rank-side code: tests/torch_mesh_ranks.py).

* ``sharded_sumcheck`` at S = 2 equals the JAX ``sharded_sumcheck`` on a
  2-device JAX mesh, on the same numpy tables.
* ``prove_sharded`` of randomize(3, 7, seed=21) at S = 2 and S = 4 equals
  the JAX single-device ``driver.prove`` in every proof array (meta adds
  ``mesh_shards``, as the JAX ``prove_sharded``'s does).  The JAX sharded
  prover costs minutes to compile on the CPU (tests/test_gkr_sharded.py
  takes 120 s at S = 8), so the reference is the single-device prove
  (made once a session with tests/test_torch_prove.py's, which holds the
  same proof), whose equality with the JAX sharded one
  tests/test_gkr_sharded.py:55 asserts.  That also checks ``make_sharded_prover``'s polys, which the
  proof carries; every rank returns the same proof; the port's verify
  and the JAX verify accept it and reject it with one coefficient
  changed.
* ``make_sharded_prover`` on randomize(4, 3, seed=3), whose dad tables
  of 1 and 2 bits stay whole at S = 4 (``_is_sharded``), equals the
  single-device ``protocol.prove`` (held against the JAX prover in
  tests/test_torch_prove.py) at S = 2 and S = 4.
* ``driver.run(config=ProtocolConfig(mesh=(1, 2)))`` proves in place
  inside an initialised group; the spawning form is in
  tests/test_torch_sharded_pc.py.

Tolerance 0 throughout."""

import dataclasses
import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JMesh

from virgo_plus_tpu import driver as jdriver
from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu.parallel.sharded import sharded_sumcheck as jsumcheck

from virgo_plus_tpu_torch import convert, driver, proof_io
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.parallel import mesh as pmesh
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_mesh_ranks as ranks
from test_torch_prove import _equal_proofs, jax_reference_proof
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
TIMEOUT = 240


def _circuit(n, bits, seed):
    c = randomize(n, bits, seed=seed)
    subset_init(c)
    return c


def _tables(bl=9, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, MOD, size=(2, 1 << bl), dtype=np.uint64)
                 for _ in range(3)) + (
        rng.integers(0, MOD, size=(2, bl), dtype=np.uint64),)


def _tampered(full):
    """full with one p1_polys coefficient of layer 1 changed by one."""
    layers = [None] + [dict(lp) for lp in full.layers[1:]]
    p = layers[1]["p1_polys"].copy()
    p[0, 0, 1] = np.uint64((int(p[0, 0, 1]) + 1) % MOD)
    layers[1]["p1_polys"] = p
    return dataclasses.replace(full, layers=layers)


def _prove_and_jax_verify(c, small):
    """The S = 4 ranks, then the JAX verify of their proof and of that
    proof tampered."""
    outs = pmesh.spawn(ranks.gkr, 1, 4, "cpu", timeout=TIMEOUT,
                       args=(c, small))
    jcp = jdriver.compile_prover(c)
    full = outs[0]["full"]
    return outs, (jdriver.verify(c, full, jcp).ok,
                  jdriver.verify(c, _tampered(full), jcp).ok)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    c = _circuit(3, 7, 21)
    small = _circuit(4, 3, 3)
    tables = _tables()
    # the ranks and the JAX verifier run while this thread computes the
    # JAX references
    with ThreadPoolExecutor(2) as pool:
        futures = {2: pool.submit(pmesh.spawn, ranks.gkr, 1, 2, "cpu",
                                  timeout=TIMEOUT,
                                  args=(c, small, tables, True)),
                   4: pool.submit(_prove_and_jax_verify, c, small)}
        jfull, _ = jax_reference_proof(tmp_path_factory)
        jmesh = JMesh(np.array(jax.devices()[:2]), ("sp",))
        v, a, m, rs = (jgf.from_u64(t[0], t[1]) for t in tables)
        jpolys, jbound = jax.jit(jsumcheck(jmesh, "sp"))(v, a, m, rs)
        cc = compile_circuit(small)
        plans = protocol.build_plans(cc)
        arrs = protocol.circuit_arrays(cc, plans, "cpu")
        ref_small = convert.proof_to_numpy(protocol.prove(
            cc, plans, ranks._values(cc, "cpu"),
            protocol.make_challenges(cc, GlibcRandom(3396), "cpu"), arrs))
        out4, jax_verdicts = futures[4].result()
        out = {2: futures[2].result(), 4: out4}
    return dict(c=c, out=out, jfull=jfull, ref_small=ref_small,
                jax_verdicts=jax_verdicts,
                jsum=(np.asarray(jpolys), [np.asarray(b) for b in jbound]))


def test_sharded_sumcheck_matches_jax(run):
    (polys, bound), (jpolys, jbound) = run["out"][2][0]["sumcheck"], \
        run["jsum"]
    assert polys.shape == jpolys.shape and np.array_equal(polys, jpolys)
    for b, jb in zip(bound, jbound):
        assert np.array_equal(b, jb)


@pytest.mark.parametrize("S", [2, 4])
def test_prove_sharded_matches_jax(run, S):
    full = run["out"][S][0]["full"]
    assert full.meta == dict(run["jfull"].meta, mesh_shards=S)
    assert _equal_proofs(dataclasses.replace(full, meta=run["jfull"].meta),
                         run["jfull"])


@pytest.mark.parametrize("S", [2, 4])
def test_every_rank_returns_the_same_proof(run, S):
    def arrays(full):
        buf = io.BytesIO()
        proof_io.save(buf, full)
        return buf.getvalue()

    outs = run["out"][S]
    assert len(outs) == S
    assert all(arrays(o["full"]) == arrays(outs[0]["full"]) for o in outs)
    assert all(o["info"]["backend"] == "gloo" for o in outs)


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_gkr_prover_with_whole_tables(run, S):
    got, want = run["out"][S][0]["gkr"], run["ref_small"]
    assert np.array_equal(got["vres"], want["vres"])
    for i in range(1, len(want["layers"])):
        for k, w in want["layers"][i].items():
            g = got["layers"][i][k]
            assert (g is None and w is None) or np.array_equal(g, w), (i, k)


def test_both_verifiers_accept_and_reject_a_tamper(run):
    c = run["c"]
    full = run["out"][4][0]["full"]
    cp = driver.compile_prover(c, device="cpu")
    assert driver.verify(c, full, cp).ok
    assert not driver.verify(c, _tampered(full), cp).ok
    assert run["jax_verdicts"] == (True, False)


def test_run_proves_in_place_inside_a_group(run):
    ok, mesh = run["out"][2][0]["run"]
    assert ok and mesh == dict(shape=(1, 2), backend="gloo")
