"""The port's kernel modules == the JAX package's, bit for bit.

K1 (sumcheck fold): the plain twin against the JAX masked-scan fold and,
for small tables, the bit-reversed fold (the Pallas kernel in interpret
mode is in test_torch_fold_pallas.py).  K2 (SHA3-256 of 64-byte blocks):
the plain twin against the JAX XLA keccak and hashlib; the fused leaf
chain's twin against the JAX leaf_chain_hash and the Merkle forest's twin
against the JAX create_tree.  Inputs come from numpy with a seed; tolerance 0.

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against the plain twins there, at every shape the main path gives them."""

import hashlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from virgo_plus_tpu.gkr.sumcheck import (scan_sumcheck_batched,
                                         scan_sumcheck_batched_br)
from virgo_plus_tpu.pc import merkle as jmerkle
from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu.pc.keccak import sha3_256_x64_xla
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import sumcheck
from virgo_plus_tpu_torch.pc import keccak, merkle, virgo_pc

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD


def _tables(seed, bl, k):
    rng = np.random.default_rng(seed)
    n = 1 << bl
    v, a, m = (rng.integers(0, M, size=(2, k, n), dtype=np.uint64)
               for _ in range(3))
    rs = rng.integers(0, M, size=(2, k, bl), dtype=np.uint64)
    return v, a, m, rs


def _port_fold(v, a, m, rs):
    polys, bound = sumcheck.scan_sumcheck_batched(
        *(gf.tensor(x) for x in (v, a, m, rs)))
    return [gf.to_numpy(polys)] + [gf.to_numpy(b) for b in bound]


def _jax_out(polys, bound):
    return [np.asarray(polys)] + [np.asarray(b) for b in bound]


def _same(xs, ys):
    return len(xs) == len(ys) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.parametrize("bl,k", [(7, 3), (9, 2), (12, 4)])
def test_fold_matches_jax_scan(bl, k):
    v, a, m, rs = _tables(7 + bl, bl, k)
    jv = [jnp.asarray(x) for x in (v, a, m, rs)]
    assert _same(_port_fold(v, a, m, rs),
                 _jax_out(*scan_sumcheck_batched(*jv)))


@pytest.mark.parametrize("bl,k", [(1, 1), (2, 3), (4, 5), (6, 2)])
def test_small_fold_matches_jax_br(bl, k):
    v, a, m, rs = _tables(bl, bl, k)
    jv = [jnp.asarray(x) for x in (v, a, m, rs)]
    assert _same(_port_fold(v, a, m, rs),
                 _jax_out(*scan_sumcheck_batched_br(*jv)))


def test_fold_of_empty_table_is_its_value():
    v, a, m, rs = _tables(3, 0, 2)
    polys, (vb, ab, mb) = sumcheck.scan_sumcheck_batched(
        *(gf.tensor(x) for x in (v, a, m, rs)))
    assert polys.shape == (0, 2, 2, 3)
    assert np.array_equal(gf.to_numpy(vb), v[:, :, 0])


def test_plain_fold_counts_its_calls():
    v, a, m, rs = _tables(4, 3, 1)
    before = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
    _port_fold(v, a, m, rs)
    assert kernels.PLAIN_CALLS["sumcheck_fold"] == before[0]["sumcheck_fold"] + 1
    assert kernels.LAUNCHES == before[1]


@pytest.mark.parametrize("n", [1, 5, 1024])
def test_sha3_matches_jax_xla_and_hashlib(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 64, size=(8, n), dtype=np.uint64)
    words[:, 0] = 0
    got = gf.to_numpy(keccak.sha3_256_x64(gf.tensor(words)))
    assert np.array_equal(got, np.asarray(sha3_256_x64_xla(
        jnp.asarray(words))))
    for i in range(n):
        want = hashlib.sha3_256(np.ascontiguousarray(words[:, i]).tobytes())
        assert np.ascontiguousarray(got[:, i]).tobytes() == want.digest()


@pytest.mark.parametrize("bl,launches", [(0, 0), (1, 1), (7, 1), (12, 1),
                                         (13, 1), (17, 1)])
def test_fold_launches(bl, launches):
    assert sumcheck.fold_launches(bl) == launches


@pytest.mark.parametrize("bl,k,c", [
    (1, 1, 1), (7, 1, 7), (10, 63, 9), (11, 22, 9), (12, 5, 8), (13, 1, 7),
    (13, 26, 11), (17, 2, 11), (17, 26, 12), (24, 1, 12)])
def test_fold_chunk_log(bl, k, c):
    """The main path's K1 shapes on 132 SMs: one block per chunk of 2^c
    entries, at most one wave of blocks, chunks and their results within
    one block's shared memory."""
    assert sumcheck.fold_chunk_log(bl, k, 132) == c
    assert c <= sumcheck.FOLD_MAX_LOG and bl - c <= sumcheck.FOLD_MAX_LOG


def test_chain_matches_jax_leaf_chain_hash():
    rng = np.random.default_rng(65)
    cw = rng.integers(0, M, size=(2, 65, 64), dtype=np.uint64)
    want = np.asarray(jax.jit(jvpc.leaf_chain_hash)(cw))
    before = dict(kernels.PLAIN_CALLS)
    got = virgo_pc.leaf_chain_hash(gf.tensor(cw))
    assert np.array_equal(gf.to_numpy(got), want)
    assert (kernels.PLAIN_CALLS["sha3_chain_x64"]
            == before["sha3_chain_x64"] + 1)
    xs = virgo_pc._chain_inputs(gf.tensor(cw))
    assert np.array_equal(gf.to_numpy(keccak.sha3_chain_x64_plain(xs)), want)


def test_forest_matches_jax_create_tree():
    rng = np.random.default_rng(11)
    sizes = [4096, 1, 16, 2]          # one tree above 2048 leaves
    leaves = [rng.integers(0, 2 ** 64, size=(4, n), dtype=np.uint64)
              for n in sizes]
    before = dict(kernels.PLAIN_CALLS)
    got = merkle.forest(gf.tensor(np.concatenate(leaves, axis=1)), sizes)
    assert (kernels.PLAIN_CALLS["merkle_forest"]
            == before["merkle_forest"] + 1)
    assert len(got) == len(sizes)
    for lv, tree in zip(leaves, got):
        want = np.asarray(jax.jit(jmerkle.create_tree)(lv))
        assert np.array_equal(gf.to_numpy(tree), want)


@pytest.mark.parametrize("call", [
    lambda t: keccak.sha3_256_x64(t[:8]),
    lambda t: keccak.sha3_chain_x64(t.reshape(2, 4, 4)),
    lambda t: merkle.forest(t[:4], [4]),
    lambda t: sumcheck.scan_sumcheck_batched(t[:2, None], t[2:4, None],
                                             t[4:6, None], t[6:8, None, :2]),
], ids=["sha3_256_x64", "sha3_chain_x64", "merkle_forest", "sumcheck_fold"])
def test_unknown_device_raises(call):
    t = torch.zeros((8, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        call(t)


def test_build_never_leaves_a_partial_library(monkeypatch, tmp_path):
    """Ranks that start together may build one source at once: each writes
    its own temporary file and os.replace()s it into place, so the target
    is absent or whole, and a failed build raises and leaves no target."""
    fake = tmp_path / "fake_nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "[ -n \"$FAIL\" ] && { printf partial > \"$out\"; exit 1; }\n"
        "printf whole > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD", tmp_path / "build")
    monkeypatch.setenv("FAIL", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build(["keccak"])
    assert not any((tmp_path / "build").iterdir())
    monkeypatch.delenv("FAIL")
    assert kernels.build(["keccak"])["keccak"] == ""
    assert kernels._target("keccak").read_text() == "whole"
    assert kernels.build(["keccak"])["keccak"] == "(cached)"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        kernels._target("keccak").name]
