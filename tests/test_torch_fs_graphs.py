"""The port's Fiat-Shamir programs (graphs.py makers) == the JAX package's.

The port's ``fs.make_fs_prover`` and ``fs.make_fs_pc_prover`` (staged,
unstaged and ``graphed=False``) equal the JAX ``make_fs_prover`` /
``make_fs_pc_prover`` of the same ``staged``: the GKR walk on
``randomize(4, 3, seed=3)`` (phase-2 tables, and a JAX compile cheap
enough for four processes in a minute) in every LayerProof field, every
challenge and the final sponge state; the PC half on
``randomize(3, 7, seed=9)`` (bl0 = 7, one FRI level) in all eight outputs
(``q_coefs`` and ``fold_rands`` included), on the same codeword, final
point and sponge state.  A graphed ``compile_prover``'s ``driver.prove_fs`` (the
default, which ``test_torch_fs_e2e.py`` holds against the JAX
``prove_fs`` field for field) equals an eager one's, here and on small1200
(whose JAX FS prove takes minutes on the CPU), and its ``verify_fs`` and
``verify`` accept.  On the CPU a holder runs its function eagerly on its
own buffers, with the copy-in and clone-out of a replay.  The JAX
references run once, each in a process of its own.  Also here: the API
leftovers (``PolynomialCommitment``, ``merkle_path``, ``digest_to_bytes``)
against the JAX package's.  Tolerance 0."""

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
from virgo_plus_tpu.gkr import fs as jfs
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.pc import keccak as jkeccak
from virgo_plus_tpu.pc import merkle as jmerkle
from virgo_plus_tpu.pc.interface import \
    PolynomialCommitment as JPolynomialCommitment

from virgo_plus_tpu_torch import driver, graphs
from virgo_plus_tpu_torch.circuits.compile import input_buffer
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import fs
from virgo_plus_tpu_torch.pc import keccak, merkle
from virgo_plus_tpu_torch.pc.interface import PolynomialCommitment, VirgoPC

from test_reference_parity import FIXTURE
from test_torch_graphs import _arrays, _same
from test_torch_prove import _equal_proofs
import torch_shared  # noqa: F401  (one torch thread)

FORMS = {"staged": (True, True), "unstaged": (False, True),
         "eager": (True, False)}


def _circuit(gkr=False):
    """randomize(4, 3, seed=3) for the GKR half, else randomize(3, 7,
    seed=9)."""
    c = randomize(4, 3, seed=3) if gkr else randomize(3, 7, seed=9)
    subset_init(c)
    return c


def _jax_job(half, staged, args):
    """One JAX FS program ("gkr": make_fs_prover on (values, root_l);
    "pc": make_fs_pc_prover on (codeword, final_point, D)) of one
    ``staged``, in a process of its own; numpy leaves."""
    import jax
    import jax.numpy as jnp

    jcc = jcompile(_circuit(half == "gkr"))
    args = [jnp.asarray(a) for a in args]
    if half == "gkr":
        out = jfs.make_fs_prover(jcc, jprotocol.build_plans(jcc),
                                 staged=staged)(*args)
    else:
        out = jfs.make_fs_pc_prover(jcc.layers[0].bit_length,
                                    staged=staged)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def run():
    """The port's inputs (the GKR circuit's values and a root; the PC
    circuit's codeword, and the final point and state of its eager FS
    walk), the JAX programs on them (four processes), and meanwhile the
    graphed and eager small1200 FS proofs."""
    cp_gkr = driver.compile_prover(_circuit(gkr=True), device="cpu")
    c = _circuit()
    cp = driver.compile_prover(c, device="cpu")
    bl0 = cp.cc.layers[0].bit_length
    inputs = input_buffer(cp.cc, None, "cpu")
    values = cp.evaluator(inputs)
    l_oracle, _ = cp.pc.commit_private(cp.pc_fns, inputs)
    fsa = fs.fs_arrays(cp.cc, cp.plans, "cpu")
    _proof, ch, D = fs.fs_prove(cp.cc, cp.plans, values, l_oracle.tree[:, 1],
                                cp.arrs, fsa)
    args = {"gkr": (cp_gkr.evaluator(input_buffer(cp_gkr.cc, None, "cpu")),
                    gf.tensor(np.arange(4, dtype=np.uint64) + 7)),
            "pc": (l_oracle.codeword, ch.layers[1].r_liu[:, :bl0], D)}
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn")) as pool:
        futures = {(h, s): pool.submit(_jax_job, h, s,
                                       [gf.to_numpy(a) for a in args[h]])
                   for h in args for s in (True, False)}
        small = driver.load_circuit(FIXTURE)
        small_cp = driver.compile_prover(small, device="cpu")
        small_fs = driver.prove_fs(small, small_cp)[0]
        small_eager = driver.prove_fs(small, driver.compile_prover(
            small, device="cpu", graphed=False))[0]
        ref = {k: f.result() for k, f in futures.items()}
    return dict(c=c, cp=cp, cp_gkr=cp_gkr, bl0=bl0, ref=ref, args=args,
                small=(small, small_cp, small_fs, small_eager))


def _fs_prover(run, form):
    staged, graphed = FORMS[form]
    cp = run["cp_gkr"]
    return fs.make_fs_prover(cp.cc, cp.plans, cp.arrs, "cpu", staged,
                             graphed)


def test_jax_fs_forms_agree(run):
    """The JAX staged and unstaged programs give the same bits, so each
    port form below is held against both."""
    for half in ("gkr", "pc"):
        _same(run["ref"][(half, True)], run["ref"][(half, False)])


@pytest.mark.parametrize("form", FORMS)
def test_fs_prover_matches_jax(run, form):
    """Every LayerProof field, every challenge and the final state."""
    prove = _fs_prover(run, form)
    _same(prove(*run["args"]["gkr"]), run["ref"][("gkr", FORMS[form][0])])
    depth = run["cp_gkr"].cc.depth
    assert len(graphs.holders(prove)) == {"staged": depth, "unstaged": 1,
                                          "eager": 0}[form]


@pytest.mark.parametrize("form", FORMS)
def test_fs_pc_prover_matches_jax(run, form):
    """All eight outputs: h_oracle, all_sum, q_coefs, the fft_gkr
    messages, the level oracles, the final codeword, fold_rands (2,
    levels) and the final state."""
    staged, graphed = FORMS[form]
    prove = fs.make_fs_pc_prover(run["bl0"], "cpu", staged, graphed)
    got = prove(*run["args"]["pc"])
    want = run["ref"][("pc", staged)]
    assert len(got) == len(want) == 8
    _same(got, want)
    assert got[6].shape == (2, run["bl0"] - 6)
    levels = run["bl0"] - 6
    assert len(graphs.holders(prove)) == {"staged": 2 + levels,
                                          "unstaged": 1, "eager": 0}[form]


def test_fs_pc_q_coefs_are_the_pc_q_prepare(run):
    """q_coefs comes from the code VirgoPC.q_prepare runs."""
    fns = VirgoPC().compile(run["bl0"], "cpu", graphed=False)
    codeword, final_point, D = run["args"]["pc"]
    _same(VirgoPC.q_prepare(fns, final_point)[1],
          fs.fs_pc_prove(codeword, final_point, D, run["bl0"])[2])


def test_results_outlive_later_calls(run):
    """A staged prover's result stays as it was after a call on other
    values, and that call gives other bits."""
    prove = _fs_prover(run, "staged")
    values, root_l = run["args"]["gkr"]
    first = prove(values, root_l)
    kept = [None if a is None else a.copy() for a in _arrays(first)]
    second = prove(gf.add(values, gf.ones((1,), "cpu")), root_l)
    _same(first, kept)
    assert not np.array_equal(gf.to_numpy(first[2]), gf.to_numpy(second[2]))
    assert [h.replays for h in graphs.holders(prove)] == \
        [2] * run["cp_gkr"].cc.depth


def test_graphed_prove_fs_matches_eager_and_verifies(run):
    """A graphed compile_prover's prove_fs == an eager one's; its verify_fs
    and (on a glibc proof) verify accept, through the driver's FS and
    verifier programs, made in the forms the driver picks."""
    c, cp = run["c"], run["cp"]
    assert cp.graphed
    full, info = driver.prove_fs(c, cp)
    eager = driver.compile_prover(c, device="cpu", graphed=False)
    assert _equal_proofs(full, driver.prove_fs(c, eager)[0])
    assert set(info["phases"]) == {"eval_commit", "gkr", "pc", "queries"}
    assert driver.verify_fs(c, full, cp).ok
    assert driver.verify(c, driver.prove(c, cp)[0], cp).ok
    assert len(graphs.holders(cp.fs_prover)) == (
        cp.cc.depth if driver.FS_STAGED else 1)
    assert len(graphs.holders(cp.fs_pc_prover)) == (
        2 + run["bl0"] - 6 if driver.FS_STAGED else 1)
    for maker in (cp.fs_prover, cp.fs_pc_prover, cp.verifier):
        held = graphs.holders(maker)
        assert held and all(h.replays >= 1 and h.graph is None
                            for h in held)
    assert not any(graphs.holders(m) for m in (
        eager.fs_prover, eager.fs_pc_prover, eager.verifier))


def test_graphed_prove_fs_small1200(run):
    """small1200: the graphed prove_fs == the eager one field for field,
    and the graphed verify_fs accepts it."""
    c, cp, full, eager_full = run["small"]
    assert _equal_proofs(full, eager_full)
    assert driver.verify_fs(c, full, cp).ok


def test_release_empties_the_fs_makers(run):
    prove = _fs_prover(run, "staged")
    pc = fs.make_fs_pc_prover(run["bl0"], "cpu")
    want = prove(*run["args"]["gkr"])
    pc(*run["args"]["pc"])
    graphs.release(prove)
    graphs.release(pc)
    assert graphs.holders(prove) == [] and graphs.holders(pc) == []
    _same(prove(*run["args"]["gkr"]), want)
    assert [h.replays for h in graphs.holders(prove)] == \
        [1] * run["cp_gkr"].cc.depth


def test_init_state_is_the_makers_d0(run):
    """The sponge's initial state, made once per maker, is init_state's."""
    cp = run["cp"]
    assert torch.equal(fs.fs_arrays(cp.cc, cp.plans, "cpu")["D0"],
                       fs.init_state("cpu"))


def test_polynomial_commitment_seam():
    assert isinstance(VirgoPC(), PolynomialCommitment)
    with pytest.raises(TypeError):
        PolynomialCommitment()
    names = lambda cls: sorted(n for n in dir(cls)
                               if getattr(getattr(cls, n),
                                          "__isabstractmethod__", False))
    assert names(PolynomialCommitment) == names(JPolynomialCommitment)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_merkle_path_matches_jax(pos):
    rng = np.random.default_rng(pos)
    leaves = rng.integers(0, 2 ** 64, size=(4, 16), dtype=np.uint64)
    tree = gf.to_numpy(merkle.create_tree(gf.tensor(leaves)))
    want = np.asarray(jmerkle.merkle_path(np.asarray(
        jmerkle.create_tree(leaves)), pos))
    got = merkle.merkle_path(tree, pos)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(gf.to_numpy(merkle.merkle_path(
        gf.tensor(tree), pos)), want)


def test_digest_to_bytes_matches_jax():
    d = np.array([1, 2 ** 63 + 5, 0, 2 ** 64 - 1], dtype=np.uint64)
    want = jkeccak.digest_to_bytes(d)
    assert keccak.digest_to_bytes(d) == want
    assert keccak.digest_to_bytes(gf.tensor(d)) == want
