"""The port's kernel modules == the JAX package's, bit for bit.

K1 (sumcheck fold): the plain twin against the JAX masked-scan fold and,
for small tables, the bit-reversed fold (the Pallas kernel in interpret
mode is in test_torch_fold_pallas.py).  K2 (SHA3-256 of 64-byte blocks):
the plain twin against the JAX XLA keccak and hashlib.  Inputs come from numpy with a seed; tolerance 0.

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against the plain twins there, at every shape the main path gives them."""

import hashlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from virgo_plus_tpu.gkr.sumcheck import (scan_sumcheck_batched,
                                         scan_sumcheck_batched_br)
from virgo_plus_tpu.pc.keccak import sha3_256_x64_xla
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import sumcheck
from virgo_plus_tpu_torch.pc import keccak

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


def test_unknown_device_raises():
    t = torch.zeros((8, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        keccak.sha3_256_x64(t)
