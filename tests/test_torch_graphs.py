"""The port's compiled programs (graphs.py makers) == the JAX package's jits.

On ``randomize(3, 7, seed=6)``, under the JAX package's own challenges
carried across with ``convert.challenges``, each port maker equals its JAX
counterpart in every array: ``fused.make_e2e_prover`` + ``make_fg_tape``,
``protocol.make_evaluator``, ``protocol.make_prover`` (staged and not),
``VirgoPC.compile``'s four programs, and the batched provers at B = 3
(each instance against the JAX ``make_e2e_prover`` on its witness).  On the
CPU a holder runs its function eagerly on its own static buffers, with the
same copy-in and clone-out as a replay on the card, so this holds the
plumbing: results that a later call leaves alone, one holder per shape,
the launch bookkeeping of a capture, and ``driver.prove`` through the
makers giving the small1200 pins.  The JAX references are computed once,
each in a process of its own.  Tolerance 0."""

import dataclasses
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from virgo_plus_tpu import fused as jfused
from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
from virgo_plus_tpu.circuits.compile import input_buffer as jinput
from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu.pc.interface import VirgoPC as JVirgoPC
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

from virgo_plus_tpu_torch import convert, driver, fused, graphs, kernels
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import protocol, sumcheck
from virgo_plus_tpu_torch.parallel.sharded import (make_batched_full_prover,
                                                   make_batched_prover)
from virgo_plus_tpu_torch.pc import fft_gkr
from virgo_plus_tpu_torch.pc.interface import VirgoPC

from test_reference_parity import (FIXTURE, REF_GKR_KB, REF_PC_KB,
                                   REF_ROOT_H, REF_ROOT_L,
                                   REF_TRANSCRIPT_HASH, _transcript_hash)
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1
B = 3


def _arrays(x):
    """Every array of a result in field order, as numpy (port tensors by
    their u64 bits); None where a field is None."""
    if x is None:
        return [None]
    if torch.is_tensor(x):
        return [gf.to_numpy(x)]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _arrays(v)]
    if isinstance(x, dict):
        return [a for k in x for a in _arrays(x[k])]
    if dataclasses.is_dataclass(x):
        return [a for f in dataclasses.fields(x)
                for a in _arrays(getattr(x, f.name))]
    return [np.asarray(x)]


def _same(got, want):
    """Every array of two results equal (shape and bits)."""
    a, b = _arrays(got), _arrays(want)
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, k
        else:
            assert x.shape == y.shape and np.array_equal(x, y), k


def _jax_setup():
    """The fixture's circuit, JAX challenges, fft_gkr schedule (the port's
    draw, the same stream), fold challenges and witnesses."""
    c = randomize(3, 7, seed=6)
    subset_init(c)
    jcc = jcompile(c)
    bl0 = jcc.layers[0].bit_length
    n_folds = bl0 - jvpc.LOG_SLICE
    rng = JGlibc(3396)
    jch = jprotocol.make_challenges(jcc, rng)
    sched = fft_gkr.draw_schedule(n_folds, rng)
    rands = tuple(jgf.from_u64(np.uint64(r), np.uint64(i)).reshape(2)
                  for (r, i) in [rng.field_element()
                                 for _ in range(n_folds)])
    x = np.asarray(jinput(jcc))
    xs = np.stack([x] * B)
    xs[1, 0, 0] = (int(xs[1, 0, 0]) + 1) % MOD
    xs[2, 0, 1] = (int(xs[2, 0, 1]) + 2) % MOD
    return dict(c=c, jcc=jcc, bl0=bl0, n_folds=n_folds, jch=jch,
                sched=sched, rands=rands, x=x, xs=xs)


def _jax_job(name):
    """One of the JAX package's programs on the fixture's inputs, run in a
    process of its own; results with numpy leaves."""
    import jax

    s = _jax_setup()
    jcc, jch, x, bl0 = s["jcc"], s["jch"], s["x"], s["bl0"]
    jplans = jprotocol.build_plans(jcc)
    if name == "e2e":
        e2e = jfused.make_e2e_prover(jcc, jplans)
        out = [e2e(jnp.asarray(s["xs"][b]), jch, s["rands"])
               for b in range(B)]
    elif name == "tape":
        out = jfused.make_fg_tape(s["n_folds"])(s["sched"])
    elif name == "prover":
        values = jprotocol.make_evaluator(jcc)(x)
        out = values, jprotocol.make_prover(jcc, jplans)(values, jch)
    else:
        fns = JVirgoPC().compile(bl0)
        commit = fns["commit"](x)
        q = fns["q_prepare"](jch.layers[1].r_liu[:, :bl0])
        pub = fns["commit_pub"](commit[0].codeword, q[0])
        out = dict(commit=commit, q_prepare=q, commit_pub=pub,
                   folds=fns["folds"](pub[4], s["rands"]))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def run():
    """The JAX references, each in a process of its own (their traces are
    bound to one core each), and the port's inputs."""
    jobs = ("e2e", "tape", "prover", "pc")
    with ProcessPoolExecutor(len(jobs),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {k: pool.submit(_jax_job, k) for k in jobs}
        s = _jax_setup()
        cc = compile_circuit(s["c"])
        jch, bl0 = s["jch"], s["bl0"]
        out = dict(c=s["c"], cc=cc, plans=protocol.build_plans(cc), bl0=bl0,
                   n_folds=s["n_folds"], ch=convert.challenges(jch),
                   sched=s["sched"],
                   fold_rands=[convert.tensor(r) for r in s["rands"]],
                   final_point=convert.tensor(jch.layers[1].r_liu[:, :bl0]),
                   inputs=convert.tensor(s["x"]), xs=s["xs"])
        out["ref"] = {k: f.result() for k, f in futures.items()}
    return out


def test_e2e_prover_and_fg_tape_match_jax(run):
    prove = fused.make_e2e_prover(run["cc"], run["plans"], "cpu")
    tape = fused.make_fg_tape(run["n_folds"], "cpu")
    _same(prove(run["inputs"], run["ch"], run["fold_rands"]),
          run["ref"]["e2e"][0])
    _same(tape(run["sched"]), run["ref"]["tape"])
    _same(prove(convert.tensor(run["xs"][1]), run["ch"], run["fold_rands"]),
          run["ref"]["e2e"][1])
    held = graphs.holders(prove) + graphs.holders(tape)
    assert [h.replays for h in held] == [2, 1]
    assert all(h.graph is None and h.launches == {} for h in held)


def test_evaluator_matches_jax(run):
    ev = protocol.make_evaluator(run["cc"], "cpu")
    _same(ev(run["inputs"]), run["ref"]["prover"][0])


@pytest.mark.parametrize("staged", [True, False])
def test_prover_matches_jax(run, staged):
    """Either form of the port's prover == the JAX (staged) make_prover,
    whose two forms give the same bits as protocol.prove."""
    values, want = run["ref"]["prover"]
    prove = protocol.make_prover(run["cc"], run["plans"], "cpu", staged)
    _same(prove(convert.tensor(values), run["ch"]), want)
    _same(want, run["ref"]["e2e"][0][0])
    assert len(graphs.holders(prove)) == (4 if staged else 1)


def test_pc_programs_match_jax(run):
    fns = VirgoPC().compile(run["bl0"], "cpu")
    ref = run["ref"]["pc"]
    commit = fns["commit"](run["inputs"])
    q = fns["q_prepare"](run["final_point"])
    pub = fns["commit_pub"](commit[0].codeword, q[0])
    folds = fns["folds"](pub[4], run["fold_rands"])
    for name, got in (("commit", commit), ("q_prepare", q),
                      ("commit_pub", pub), ("folds", folds)):
        _same(got, ref[name])
    assert len(graphs.holders(fns)) == 4


def test_batched_provers_match_jax(run):
    cc, plans, xs = run["cc"], run["plans"], run["xs"]
    full = make_batched_full_prover(cc, plans, device="cpu")
    proofs, root_l, root_h, all_sum, level_roots, final_cw = full(
        xs, run["ch"], run["final_point"], run["fold_rands"])
    gkr = make_batched_prover(cc, plans, protocol.circuit_arrays(
        cc, plans, "cpu"), device="cpu")(xs, run["ch"])
    for b in range(B):
        jproof, jl, jh, jsum, _q, jldt = run["ref"]["e2e"][b]
        pick = lambda p: protocol.Proof(vres=p.vres[b], layers=[None] + [
            protocol.LayerProof(**{k: None if t is None else t[b]
                                   for k, t in vars(lp).items()})
            for lp in p.layers[1:]])
        _same(pick(proofs), jproof)
        _same(pick(gkr), jproof)
        _same([root_l[b], root_h[b], all_sum[b], final_cw[b]],
              [jl.tree[:, 1], jh.tree[:, 1], jsum, jldt.final_codeword])
        _same(level_roots[b], np.stack([o.tree[:, 1]
                                        for o in jldt.oracles]))


def test_a_new_batch_size_builds_a_new_holder(run):
    cc, plans, xs = run["cc"], run["plans"], run["xs"]
    full = make_batched_full_prover(cc, plans, device="cpu")
    args = (run["ch"], run["final_point"], run["fold_rands"])
    three = full(xs, *args)
    one = full(xs[2:], *args)
    again = full(xs, *args)
    assert [h.replays for h in graphs.holders(full)] == [2, 1]
    _same(again, three)
    _same(one[1:], [t[2:] for t in three[1:]])


def test_eager_makers_and_release(run):
    """graphed=False gives the eager functions, with no holder and the same
    bits; graphs.release drops a maker's holders, and its next call builds
    a new one."""
    cc, plans, xs = run["cc"], run["plans"], run["xs"]
    args = (run["ch"], run["final_point"], run["fold_rands"])
    full = make_batched_full_prover(cc, plans, device="cpu")
    eager = make_batched_full_prover(cc, plans, device="cpu", graphed=False)
    want = full(xs, *args)
    _same(eager(xs, *args), want)
    assert graphs.holders(eager) == []
    graphs.release(full)
    assert graphs.holders(full) == []
    _same(full(xs, *args), want)
    assert [h.replays for h in graphs.holders(full)] == [1]

    values, proof = run["ref"]["prover"]
    evaluator = protocol.make_evaluator(cc, "cpu", graphed=False)
    prover = protocol.make_prover(cc, plans, "cpu", graphed=False)
    fns = VirgoPC().compile(run["bl0"], "cpu", graphed=False)
    _same(evaluator(run["inputs"]), values)
    _same(prover(convert.tensor(values), run["ch"]), proof)
    _same(fns["commit"](run["inputs"]), run["ref"]["pc"]["commit"])
    cp = driver.compile_prover(run["c"], device="cpu", graphed=False)
    assert not any(isinstance(f, graphs.Graphed) for f in (
        evaluator, prover, cp.evaluator, cp.prover, *fns.values(),
        *cp.pc_fns.values()))
    _same(driver.prove(run["c"], cp)[0],
          driver.prove(run["c"], driver.compile_prover(run["c"],
                                                       device="cpu"))[0])


def test_results_outlive_later_calls(run):
    """A result stays as it was after a call on other inputs: outputs are
    cloned out of the holder, even those that alias its buffers (the LDT's
    fold challenges)."""
    prove = fused.make_e2e_prover(run["cc"], run["plans"], "cpu")
    first = prove(run["inputs"], run["ch"], run["fold_rands"])
    kept = [None if a is None else a.copy() for a in _arrays(first)]
    other = [gf.add(r, gf.ones((), "cpu")) for r in run["fold_rands"]]
    second = prove(convert.tensor(run["xs"][2]), run["ch"], other)
    _same(first, kept)
    assert not np.array_equal(gf.to_numpy(first[1].tree[:, 1]),
                              gf.to_numpy(second[1].tree[:, 1]))
    _same(first[5].randomness, run["fold_rands"])
    _same(second[5].randomness, other)


def test_driver_prove_runs_through_the_makers_small1200():
    c = driver.load_circuit(FIXTURE)
    cp = driver.compile_prover(c, device="cpu")
    full, info = driver.prove(c, cp)
    assert _transcript_hash(cp.cc, full) == REF_TRANSCRIPT_HASH
    assert [int(x) for x in full.root_l] == REF_ROOT_L
    assert [int(x) for x in full.root_h] == REF_ROOT_H
    assert info["gkr_proof_size"] == REF_GKR_KB * 1024
    assert info["pc_proof_size"] == REF_PC_KB * 1024
    replays = {h.name: h.replays for obj in (cp.evaluator, cp.prover,
                                             cp.pc_fns)
               for h in graphs.holders(obj)}
    assert replays == {"evaluator #0": 1, "prover #0": 1, "pc commit #0": 1,
                       "pc commit_pub #0": 1, "pc folds #0": 1,
                       "pc q_prepare #0": 1}
    assert driver.verify(c, full, cp).ok


def test_capture_counts_take_launches_back_and_refuse_plain_calls():
    """A capture's launches move to the holder (a stub stands in for the
    kernel wrappers' counting); a plain twin call inside a capture
    raises."""
    before = dict(kernels.LAUNCHES)
    with graphs.capture_counts("stub") as counted:
        kernels.LAUNCHES["sumcheck_fold"] += 3
        kernels.LAUNCHES["merkle_forest"] += 1
    assert counted.launches == {"sumcheck_fold": 3, "merkle_forest": 1}
    assert kernels.LAUNCHES == before
    t = torch.zeros((2, 1, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="plain twin"):
        with graphs.capture_counts("stub"):
            sumcheck.fold_plain(t, t, t, torch.zeros((2, 1, 2),
                                                      dtype=torch.int64))


def test_pytree_copy_in_and_devices():
    """numpy uint64 leaves enter as int64 tensors of the same bits, nested
    structures come back whole, and a tensor on another device than the
    graph's raises."""
    seen = []

    def fn(d, pair):
        seen.append(d["a"].dtype)
        return dict(a=d["a"] + 0, n=d["n"]), [pair[0], None]

    g = graphs.Graphed(fn, "cpu", "stub")
    a = np.array([2 ** 63 + 5, 7], dtype=np.uint64)
    out, rest = g(dict(a=a, n=3), (torch.ones(2, dtype=torch.int64), None))
    assert seen == [torch.int64] and out["n"] == 3 and rest[1] is None
    assert np.array_equal(gf.to_numpy(out["a"]), a)
    g(dict(a=a, n=4), (torch.ones(2, dtype=torch.int64), None))
    assert len(g.holders) == 2             # a new constant: a new holder
    with pytest.raises(ValueError, match="graph on"):
        g(dict(a=a, n=3), (torch.ones(2, dtype=torch.int64,
                                      device="meta"), None))
