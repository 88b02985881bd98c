"""The port's Fiat-Shamir sponge == the JAX package's, bit for bit.

``init_state``, ``absorb_pair``, ``absorb_elems``, ``squeeze``,
``squeeze_vec`` and ``fs_scan_sumcheck`` of ``virgo_plus_tpu_torch.gkr.fs``
against ``virgo_plus_tpu.gkr.fs`` on the CPU (the port's SHA3 runs its plain
twin there), and the host sponge's hand-over of the device state.  Inputs
come from numpy with a seed; tolerance 0."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

from virgo_plus_tpu.gkr import fs as jfs
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import fs

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD


def _state(seed):
    """A sponge state of random u64 words (the top bit set in some)."""
    return np.random.default_rng(seed).integers(0, 2 ** 64, size=4,
                                                dtype=np.uint64)


def _elems(seed, k):
    return np.random.default_rng(seed).integers(0, M, size=(2, k),
                                                dtype=np.uint64)


def _same(port, jax_value):
    x, y = gf.to_numpy(port), np.asarray(jax_value)
    return x.shape == y.shape and np.array_equal(x, y)


def test_init_state_matches_jax():
    assert _same(fs.init_state("cpu"), jfs.init_state())


def test_absorb_pair_matches_jax():
    D, e = _state(1), _elems(2, 2)
    got = fs.absorb_pair(gf.tensor(D), gf.tensor(e[:, 0]), gf.tensor(e[:, 1]))
    want = jfs.absorb_pair(jnp.asarray(D), jnp.asarray(e[:, 0]),
                           jnp.asarray(e[:, 1]))
    assert _same(got, want)


@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 30])
def test_absorb_elems_matches_jax(k):
    D, e = _state(10 + k), _elems(20 + k, k)
    got = fs.absorb_elems(gf.tensor(D), gf.tensor(e))
    want = jfs.absorb_elems(jnp.asarray(D), jnp.asarray(e))
    assert _same(got, want)


def _digest_words(state_words, tag):
    """The squeeze digest H = SHA3-256(D || tag pad block) as u64 words."""
    blk = state_words.astype("<u8").tobytes() + bytes([tag]) + b"\x00" * 31
    return np.frombuffer(hashlib.sha3_256(blk).digest(), dtype="<u8")


@pytest.mark.parametrize("n", [1, 4, 5, 64])
def test_squeeze_vec_matches_jax(n):
    D = _state(30 + n)
    got, gD = fs.squeeze_vec(gf.tensor(D), n)
    want, wD = jfs.squeeze_vec(jnp.asarray(D), n)
    assert _same(got, want) and _same(gD, wD)
    # the challenge words were reduced from u64 digest words, and at least
    # one of them had its top bit set (the case a signed mod gets wrong)
    top = False
    d = D
    for _ in range(n):
        h = _digest_words(d, 1)
        top |= bool((h[:2] >> np.uint64(63)).any())
        d = _digest_words(d, 2)
    assert top


def test_squeeze_matches_jax():
    D = _state(3)
    el, D2 = fs.squeeze(gf.tensor(D))
    jel, jD2 = jfs.squeeze(jnp.asarray(D))
    assert _same(el, jel) and _same(D2, jD2)
    assert (gf.to_numpy(el) < np.uint64(M)).all()


@pytest.mark.parametrize("bl", [0, 1, 3, 6])
def test_fs_scan_sumcheck_matches_jax(bl):
    rng = np.random.default_rng(40 + bl)
    v, a, m = (rng.integers(0, M, size=(2, 1 << bl), dtype=np.uint64)
               for _ in range(3))
    D = _state(50 + bl)
    polys, rs, bound, gD = fs.fs_scan_sumcheck(
        gf.tensor(v), gf.tensor(a), gf.tensor(m), bl, gf.tensor(D))
    jpolys, jrs, jbound, jD = jfs.fs_scan_sumcheck(
        jnp.asarray(v), jnp.asarray(a), jnp.asarray(m), bl, jnp.asarray(D))
    assert _same(polys, jpolys) and _same(rs, jrs) and _same(gD, jD)
    assert all(_same(x, y) for x, y in zip(bound, jbound))


def test_host_sponge_from_device_state_matches_jax():
    D = _state(4)
    sp = fs.HostSponge.from_device_state(gf.tensor(D))
    jsp = jfs.HostSponge.from_device_state(jnp.asarray(D))
    assert sp.state == jsp.state
    assert sp.squeeze_vec(3) == jsp.squeeze_vec(3)
    assert sp.rand() == jsp.rand()
