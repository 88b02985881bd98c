"""The port's glibc-stream prove and verify == the JAX package's.

On ``randomize(3, 7, seed=21)`` (the circuit of tests/test_mutations.py)
every field of the port's FullProof equals the JAX ``driver.prove`` output,
the GKR prover fed the JAX package's own challenges and circuit tables
(through ``convert``) gives the JAX messages, each package's verify accepts
the other's proof, and tampered proofs are rejected by the port's verify.
On small1200 the port reproduces the reference's pinned transcript hash,
roots and proof sizes.  Everything runs on the CPU; tolerance 0."""

import io

import numpy as np
import pytest

from virgo_plus_tpu import driver as jdriver
from virgo_plus_tpu import proof_io as jproof_io
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.pc.vpd import QueryAnswers as JQueryAnswers
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

from virgo_plus_tpu_torch import convert, driver, proof_io
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.gkr import protocol

from test_reference_parity import (FIXTURE, REF_GKR_KB, REF_PC_KB,
                                   REF_ROOT_H, REF_ROOT_L,
                                   REF_TRANSCRIPT_HASH, _transcript_hash)
import torch_shared

MOD = (1 << 61) - 1


def _equal_proofs(a, b):
    """Every FullProof field equal, array by array (dtype and bits)."""
    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and \
            np.array_equal(x, y)

    checks = [same(a.vres, b.vres), same(a.root_l, b.root_l),
              same(a.root_h, b.root_h), same(a.all_sum, b.all_sum),
              same(a.level_roots, b.level_roots),
              same(a.final_codeword, b.final_codeword),
              len(a.fft_gkr_messages) == len(b.fft_gkr_messages),
              len(a.layers) == len(b.layers)]
    checks += [same(x, y) for x, y in zip(a.fft_gkr_messages,
                                          b.fft_gkr_messages)]
    for la, lb in zip(a.layers[1:], b.layers[1:]):
        checks += [same(la[k], lb[k]) for k in la]
    qa, qb = a.queries, b.queries
    for k in ("init_l_vals", "init_l_paths", "init_h_vals", "init_h_paths"):
        checks.append(same(getattr(qa, k), getattr(qb, k)))
    checks += [same(x, y) for x, y in zip(qa.lvl_vals + qa.lvl_paths,
                                          qb.lvl_vals + qb.lvl_paths)]
    checks.append(a.meta == b.meta)
    return all(checks)


def _circuit():
    c = randomize(3, 7, seed=21)
    subset_init(c)
    return c


def _proof_arrays(full):
    """A JAX ``FullProof``'s fields as named numpy arrays, each as
    np.asarray gives it (dtype and bits kept); the layer keys whose value
    is None and the meta keys (ints) are listed by name."""
    d = dict(vres=full.vres, root_l=full.root_l, root_h=full.root_h,
             all_sum=full.all_sum, level_roots=full.level_roots,
             final_codeword=full.final_codeword,
             n_msgs=len(full.fft_gkr_messages), depth=len(full.layers),
             meta_keys=np.array(sorted(full.meta), dtype=str))
    for k, m in enumerate(full.fft_gkr_messages):
        d[f"msg{k}"] = m
    for i, lp in enumerate(full.layers[1:], 1):
        d[f"L{i}__keys"] = np.array(list(lp), dtype=str)
        d[f"L{i}__none"] = np.array([v is None for v in lp.values()])
        d.update({f"L{i}_{k}": v for k, v in lp.items() if v is not None})
    qa = full.queries
    for k in ("init_l_vals", "init_l_paths", "init_h_vals", "init_h_paths"):
        d[f"q_{k}"] = getattr(qa, k)
    d["n_lvls"] = len(qa.lvl_vals)
    for k, (v, p) in enumerate(zip(qa.lvl_vals, qa.lvl_paths)):
        d[f"q_lvl{k}_vals"], d[f"q_lvl{k}_paths"] = v, p
    for k, v in full.meta.items():
        assert isinstance(v, int), (k, v)
        d[f"meta_{k}"] = v
    return {k: np.asarray(v) for k, v in d.items()}


def _proof_from(d):
    """The JAX ``FullProof`` of ``_proof_arrays``' arrays."""
    layers = [None]
    for i in range(1, int(d["depth"])):
        layers.append({k: None if none else d[f"L{i}_{k}"] for k, none in
                       zip(d[f"L{i}__keys"].tolist(), d[f"L{i}__none"])})
    lvls = range(int(d["n_lvls"]))
    queries = JQueryAnswers(
        **{k: d[f"q_{k}"] for k in ("init_l_vals", "init_l_paths",
                                    "init_h_vals", "init_h_paths")},
        lvl_vals=[d[f"q_lvl{k}_vals"] for k in lvls],
        lvl_paths=[d[f"q_lvl{k}_paths"] for k in lvls])
    return jproof_io.FullProof(
        vres=d["vres"], layers=layers, root_l=d["root_l"],
        root_h=d["root_h"], all_sum=d["all_sum"],
        level_roots=d["level_roots"], final_codeword=d["final_codeword"],
        fft_gkr_messages=[d[f"msg{k}"] for k in range(int(d["n_msgs"]))],
        queries=queries,
        meta={k: int(d[f"meta_{k}"]) for k in d["meta_keys"].tolist()})


def jax_reference_proof(tmp_path_factory):
    """The JAX ``driver.prove`` of randomize(3, 7, seed=21) (glibc seed
    3396) and its proof sizes, made once per session
    (``torch_shared.shared``, its fields as numpy arrays:
    tests/test_torch_sharded_gkr.py holds its ranks against the same
    proof)."""
    def make():
        c = _circuit()
        jfull, jinfo = jdriver.prove(c, jdriver.compile_prover(c))
        return dict(_proof_arrays(jfull),
                    sizes=np.array([jinfo["gkr_proof_size"],
                                    jinfo["pc_proof_size"]]))
    d = torch_shared.shared(tmp_path_factory, "jax-driver-prove-randomize"
                            "-3-7-21-glibc-3396", make)
    gkr_size, pc_size = (int(n) for n in d["sizes"])
    return (_proof_from(d),
            dict(gkr_proof_size=gkr_size, pc_proof_size=pc_size))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    c = _circuit()
    cp = driver.compile_prover(c, device="cpu")
    full, info = driver.prove(c, cp)
    jcp = jdriver.compile_prover(c)
    jfull, jinfo = jax_reference_proof(tmp_path_factory)
    return c, cp, full, info, jcp, jfull, jinfo


def test_full_proof_matches_jax(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    assert _equal_proofs(full, jfull)
    assert info["gkr_proof_size"] == jinfo["gkr_proof_size"]
    assert info["pc_proof_size"] == jinfo["pc_proof_size"]


def test_gkr_prover_on_jax_tables_matches_jax(both):
    """Feed the JAX package's challenges, circuit tables and circuit values
    to the port's GKR prover (through convert)."""
    c, cp, full, info, jcp, jfull, jinfo = both
    jcc = jcp.cc
    jch = jprotocol.make_challenges(jcc, JGlibc(3396))
    values = jcp.evaluator(jdriver.input_buffer(jcc))
    want = jcp.prover(values, jch)
    cc = convert.compiled_circuit(jcc)
    arrs = convert.circuit_arrays(
        jprotocol.circuit_arrays(jcc, jcp.plans), cc)
    got = convert.proof_to_numpy(protocol.prove(
        cc, protocol.build_plans(cc), convert.tensor(values),
        convert.challenges(jch), arrs))
    assert np.array_equal(got["vres"], np.asarray(want.vres))
    for i in range(1, jcc.depth):
        for k, v in got["layers"][i].items():
            w = getattr(want.layers[i], k)
            assert (v is None and w is None) or np.array_equal(
                v, np.asarray(w)), (i, k)


def test_jax_verify_accepts_port_proof(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    assert jdriver.verify(c, full, jcp).ok


def test_port_verify_accepts_jax_proof(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    rep = driver.verify(c, jfull, cp)
    assert rep.ok and rep.gkr_ok and rep.pc_ok
    assert rep.verify_time_slow > 0.0


def test_proof_file_roundtrip_verifies(both):
    c, cp, full, info, jcp, jfull, jinfo = both
    assert driver.verify(c, proof_io.load(_saved(full)), cp).ok


def _bump(a, idx):
    a = a.copy()
    a[idx] = np.uint64((int(a[idx]) + 1) % MOD)
    return a


def _tamper(full, shape):
    f = proof_io.load(_saved(full))
    if shape == "round_poly":
        f.layers[1]["p1_polys"] = _bump(f.layers[1]["p1_polys"], (0, 0, 1))
    elif shape == "liu_claim":
        f.layers[1]["liu_claim"] = _bump(f.layers[1]["liu_claim"], (1,))
    elif shape == "forged_final_codeword":
        f.final_codeword = np.zeros_like(f.final_codeword)
    elif shape == "query_value":
        f.queries.init_l_vals = f.queries.init_l_vals.copy()
        f.queries.init_l_vals[0, 3, 0, 0] ^= np.uint64(1)
    elif shape == "fft_gkr_message":
        m = f.fft_gkr_messages[2].copy()
        m.flat[0] = (int(m.flat[0]) + 1) % MOD
        f.fft_gkr_messages[2] = m
    return f


def _saved(full):
    buf = io.BytesIO()
    proof_io.save(buf, full)
    buf.seek(0)
    return buf


@pytest.mark.parametrize("shape", ["round_poly", "liu_claim",
                                   "forged_final_codeword", "query_value",
                                   "fft_gkr_message"])
def test_port_verify_rejects_tampered_proof(both, shape):
    c, cp, full, *_ = both
    assert not driver.verify(c, _tamper(full, shape), cp).ok


def test_small1200_matches_reference_pins():
    c = driver.load_circuit(FIXTURE)
    cp = driver.compile_prover(c, device="cpu")
    full, info = driver.prove(c, cp)
    assert driver.verify(c, full, cp).ok
    assert _transcript_hash(cp.cc, full) == REF_TRANSCRIPT_HASH
    assert [int(x) for x in full.root_l] == REF_ROOT_L
    assert [int(x) for x in full.root_h] == REF_ROOT_H
    assert info["gkr_proof_size"] == int(REF_GKR_KB * 1024)
    assert info["pc_proof_size"] == int(REF_PC_KB * 1024)
