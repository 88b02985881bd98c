"""The port's sharded polynomial commitment and query answers == the JAX
package's; the dp axis; driver.run over a mesh from one process; a failing
rank fails the run.

The ranks run on the CPU over gloo, started by ``parallel.mesh.spawn``
(rank-side code: tests/torch_mesh_ranks.py).

* ``sharded_pc_prove`` at bl = 7 and S = 2, on numpy values, q values and
  fold randomness made from a seed, equals the JAX ``sharded_pc_prove`` on
  a 2-device JAX mesh: roots, all_sum, and every codeword in the same
  shard-major strided layout.  At S = 4 the roots and the unstrided
  codewords equal the same reference.
* ``answer_queries_sharded`` at S = 2 and 4 equals the JAX
  ``answer_queries_sharded`` on the JAX outputs, proof size included.
* A 16-position codeword at S = 4 builds as a tiny tree (2 leaves a rank,
  fewer than S): its root and query answers equal the single-device
  ``make_oracle`` and ``vpd.answer_queries`` (held against the JAX package
  in tests/test_torch_pc.py).
* ``make_batched_full_prover`` and ``make_batched_prover`` with a (2, 1)
  mesh, each dp rank proving half of a batch of 4, equal the unsharded
  batched provers (held against the JAX ones in tests/test_torch_batched.py)
  on every rank.
* ``driver.run(config=ProtocolConfig(mesh=(1, 2)))`` called from one
  process spawns the ranks, verifies, and names the backend.

Tolerance 0 throughout."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu.parallel import pc_sharded as jpc_sharded
from virgo_plus_tpu.parallel.sharded_queries import \
    answer_queries_sharded as janswer

from virgo_plus_tpu_torch import driver
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.config import ProtocolConfig
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.parallel import mesh as pmesh
from virgo_plus_tpu_torch.parallel.pc_sharded import unstride
from virgo_plus_tpu_torch.parallel.sharded import make_batched_prover
from virgo_plus_tpu_torch.pc import virgo_pc, vpd
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_mesh_ranks as ranks
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
BL = 7
TIMEOUT = 240


def _rand(rng, *shape):
    return rng.integers(0, MOD, size=(2,) + shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(5)
    values, q_values = _rand(rng, 1 << BL), _rand(rng, 1 << BL)
    rands = [_rand(rng) for _ in range(BL - virgo_pc.LOG_SLICE)]
    pows = vpd.draw_positions(GlibcRandom(77), BL)
    tiny_cw = _rand(rng, virgo_pc.SLICES + 1, 16)
    tiny_pows = [int(p) for p in rng.integers(0, 16, 9)]
    c = randomize(3, 7, seed=6)
    subset_init(c)
    xs = np.stack([np.asarray(c.input_values)] * 4)
    for b in range(1, 4):
        xs[b, 0, b] = (int(xs[b, 0, b]) + b) % MOD
    with ThreadPoolExecutor(4) as pool:
        pcs = {S: pool.submit(pmesh.spawn, ranks.pc, 1, S, "cpu",
                              timeout=TIMEOUT, args=(
                                  BL, values, q_values, rands, pows, tiny_cw,
                                  tiny_pows)) for S in (2, 4)}
        dp = pool.submit(pmesh.spawn, ranks.batched, 2, 1, "cpu",
                         timeout=TIMEOUT, args=(c, xs))
        rep = pool.submit(driver.run, circuit=c, device="cpu",
                          config=ProtocolConfig(mesh=(1, 2)))
        jmesh = JMesh(np.array(jax.devices()[:2]), ("sp",))
        J = lambda x: jgf.from_u64(x[0], x[1])
        jout = jpc_sharded.sharded_pc_prove(jmesh, "sp", BL)(
            J(values), J(q_values), [J(r).reshape(2) for r in rands])
        lg = BL + virgo_pc.RATE - virgo_pc.LOG_SLICE
        jans = janswer(pows, BL, *jpc_sharded.oracle_descs(jout, 2, lg))
        want_dp = ranks.batched_outputs(c, xs, None, "cpu")
        tiny_host = vpd.OracleHost.of(virgo_pc.make_oracle(
            gf.tensor(tiny_cw)))
        tiny_want = vpd.answer_queries(tiny_pows, BL, tiny_host, tiny_host,
                                       [])[0]
        return dict(pc={S: f.result() for S, f in pcs.items()},
                    dp=dp.result(), rep=rep.result(), want_dp=want_dp,
                    jout={k: (np.asarray(v) if not isinstance(v, list)
                              else [np.asarray(x) for x in v])
                          for k, v in jout.items()},
                    jans=jans, tiny_root=tiny_host.tree[:, 1],
                    tiny_want=tiny_want)


def _same_answers(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
        "init_l_vals", "init_l_paths", "init_h_vals", "init_h_paths")) and \
        len(a.lvl_vals) == len(b.lvl_vals) and all(
            np.array_equal(x, y) for x, y in zip(a.lvl_vals + a.lvl_paths,
                                                 b.lvl_vals + b.lvl_paths))


def test_sharded_pc_prove_matches_jax_layout(run):
    got, want = run["pc"][2][0], run["jout"]
    for k in ("root_l", "root_h", "all_sum", "l_codeword", "h_codeword"):
        assert np.array_equal(got[k], want[k]), k
    assert len(got["level_roots"]) == len(want["level_roots"])
    for g, w in zip(got["level_roots"] + got["level_codewords"],
                    want["level_roots"] + want["level_codewords"]):
        assert np.array_equal(g, w)


def test_sharded_pc_prove_at_s4_matches_jax(run):
    got, want = run["pc"][4][0], run["jout"]
    for k in ("root_l", "root_h", "all_sum"):
        assert np.array_equal(got[k], want[k]), k
    for g, w in [(got["l_codeword"], want["l_codeword"]),
                 (got["h_codeword"], want["h_codeword"])] + list(zip(
                     got["level_codewords"], want["level_codewords"])):
        assert np.array_equal(unstride(g, 4), unstride(w, 2))
    for g, w in zip(got["level_roots"], want["level_roots"]):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("S", [2, 4])
def test_answer_queries_sharded_matches_jax(run, S):
    (got, got_size), (want, want_size) = run["pc"][S][0]["answers"], \
        run["jans"]
    assert got_size == want_size
    assert _same_answers(got, want)
    assert all(_same_answers(o["answers"][0], got) for o in run["pc"][S])


def test_tiny_tree(run):
    tiny, root, answers = run["pc"][4][0]["tiny"]
    assert tiny
    assert np.array_equal(root, run["tiny_root"])
    assert _same_answers(answers, run["tiny_want"])
    assert not any(run["pc"][4][0]["tiny_levels"])


def test_batched_provers_over_dp(run):
    (arrays, full, gkr), (warrays, wfull, wgkr) = run["dp"][0], \
        run["want_dp"]
    for got, want in zip(arrays, warrays):
        assert np.array_equal(got, want)
    for got, want in ((full, wfull), (gkr, wgkr)):
        assert np.array_equal(got["vres"], want["vres"])
        for g, w in zip(got["layers"][1:], want["layers"][1:]):
            for k in w:
                assert (g[k] is None and w[k] is None) or np.array_equal(
                    g[k], w[k]), k
    assert all(np.array_equal(o[0][0], arrays[0]) for o in run["dp"])


def test_run_over_a_mesh_spawns_and_verifies(run):
    rep = run["rep"]
    assert rep.ok and rep.details["mesh"] == dict(shape=(1, 2),
                                                  backend="gloo")


def test_a_batch_must_split_over_dp():
    m = pmesh.Mesh(dp=3, sp=1, rank=0, device=torch.device("cpu"),
                   backend="gloo", groups={})
    c = randomize(2, 7, seed=1)
    subset_init(c)
    cc = compile_circuit(c)
    fn = make_batched_prover(cc, protocol.build_plans(cc), {}, mesh=m)
    with pytest.raises(ValueError, match="does not split"):
        fn(np.zeros((4, 2, 8), np.uint64), None)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2.*rank one fails"):
        pmesh.spawn(ranks.fails, 1, 2, "cpu", timeout=TIMEOUT)
