"""The port's GF((2^61-1)^2) layer == the JAX package's, bit for bit.

Inputs are made with numpy from a seed and fed to both packages; field
arithmetic is exact, so the tolerance is zero.  Edge values: 0, 1, p-1,
p-2, values near 2^60 and 2^61, and unreduced lazy sums near 2^62 and 2^64
(int64 wraparound and the sign bit)."""

import numpy as np
import pytest
import jax.numpy as jnp

from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu.field.ref import Fq2
from virgo_plus_tpu_torch.field import gf

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
EDGE = np.array([0, 1, 2, M - 1, M - 2, M // 2, 1 << 60, (1 << 61) - 3,
                 (1 << 32) - 1, 1 << 32, 0xFFFFFFFF00000000 % M],
                dtype=np.uint64)


def _pair(seed, n=4000):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, M, size=(2, n), dtype=np.uint64)
    y = rng.integers(0, M, size=(2, n), dtype=np.uint64)
    e = len(EDGE)
    # every edge value against every edge value, in both planes
    x[0, :e * e] = np.repeat(EDGE, e)
    y[0, :e * e] = np.tile(EDGE, e)
    x[1, e * e:2 * e * e] = np.repeat(EDGE, e)
    y[1, e * e:2 * e * e] = np.tile(EDGE, e)
    x[:, 2 * e * e:3 * e * e] = np.repeat(EDGE, e)
    y[:, 2 * e * e:3 * e * e] = np.tile(EDGE, e)
    return x, y


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    x, y = _pair(1)
    want = np.asarray(getattr(jgf, op)(jnp.asarray(x), jnp.asarray(y)))
    got = gf.to_numpy(getattr(gf, op)(gf.tensor(x), gf.tensor(y)))
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)


def test_mul_matches_reference_oracle():
    x, y = _pair(2, n=600)
    got = gf.to_numpy(gf.mul(gf.tensor(x), gf.tensor(y)))
    for k in range(x.shape[1]):
        ref = Fq2.raw(int(x[0, k]), int(x[1, k])) * \
            Fq2.raw(int(y[0, k]), int(y[1, k]))
        assert (int(got[0, k]), int(got[1, k])) == (ref.real, ref.img), k


def test_neg_and_inv_match_jax():
    x, _ = _pair(3, n=400)
    tx = gf.tensor(x)
    assert np.array_equal(gf.to_numpy(gf.neg(tx)),
                          np.asarray(jgf.neg(jnp.asarray(x))))
    nz = x[:, (x != 0).any(axis=0)][:, :64]
    inv = gf.inv(gf.tensor(nz))
    assert np.array_equal(gf.to_numpy(inv), np.asarray(jgf.inv(jnp.asarray(nz))))
    one = gf.to_numpy(gf.mul(inv, gf.tensor(nz)))
    assert (one[0] == 1).all() and (one[1] == 0).all()


def test_pow_static_matches_jax():
    x, _ = _pair(4, n=400)
    for e in (0, 1, 2, 3, 17, M - 2, (1 << 62) + 5):
        assert np.array_equal(
            gf.to_numpy(gf.pow_static(gf.tensor(x), e)),
            np.asarray(jgf.pow_static(jnp.asarray(x), e))), e


def test_mymult_wraps_like_u64():
    """The partial-product multiply near p and near 2^62: the Karatsuba
    all_prod input reaches 2p < 2^62 and its result reads negative in
    int64; the bit pattern must equal the u64 computation."""
    rng = np.random.default_rng(5)
    top = (1 << 62) - 1
    vals = np.concatenate([
        rng.integers(top - (1 << 20), top, size=500, dtype=np.uint64),
        rng.integers(2 * M - (1 << 20), 2 * M, size=500, dtype=np.uint64),
        rng.integers(M - (1 << 20), M, size=500, dtype=np.uint64),
        EDGE])
    a = vals.copy()
    b = np.roll(vals, 7)
    got = gf.to_numpy(gf._mymult(gf.tensor(a), gf.tensor(b)))
    want = np.asarray(jgf._mymult(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    assert (got >= np.uint64(1 << 63)).any()   # the sign bit really is used
    for k in range(0, len(a), 37):
        prod = int(a[k]) * int(b[k])
        assert int(got[k]) == (prod >> 61) + (prod & M)


def test_reduce_lazy_of_eight_term_sums():
    """Sums of up to 8 canonical elements reach 2^64 - 8 (negative as
    int64); reduce_lazy must use logical shifts."""
    rng = np.random.default_rng(6)
    terms = rng.integers(0, M, size=(8, 2, 1000), dtype=np.uint64)
    terms[:, :, :10] = M - 1
    s = terms.sum(axis=0, dtype=np.uint64)
    got = gf.to_numpy(gf.reduce_lazy(gf.tensor(s)))
    assert np.array_equal(got, np.asarray(jgf.reduce_lazy(jnp.asarray(s))))
    exact = terms.astype(object).sum(axis=0) % M
    assert np.array_equal(got.astype(object), exact)


def test_roots_of_unity_match_jax():
    for lg in (0, 1, 5, 13, 30, 61):
        assert gf.root_of_unity_int(lg) == jgf.root_of_unity_int(lg)
        assert np.array_equal(gf.to_numpy(gf.root_of_unity(lg)),
                              np.asarray(jgf.root_of_unity(lg)))
    r = gf.root_of_unity_int(12)
    assert gf.inv_int(r) == jgf.inv_int(r)
    assert gf.pow_int(r, 4096) == (1, 0)


def test_conversion_keeps_bits():
    x, _ = _pair(7, n=400)
    x[:, :3] = [[0, np.uint64(1 << 63), np.uint64((1 << 64) - 1)]] * 2
    t = gf.tensor(x)
    assert t.dtype.is_signed and t.element_size() == 8
    assert np.array_equal(gf.to_numpy(t), x)
