"""Pure-numpy GF((2^61-1)^2) batched arithmetic — host-side verifier math.

Same algorithms as field/gf.py (which targets device tensors); the succinct
verifier's query walks run on host where per-op device dispatch would
dominate, so the hot batched pieces (q-polynomial evaluation over 33 repetitions x 64
slices) use these exact numpy u64 kernels instead of python-int Fq2.
Elements are (2, ...) u64 arrays [real, imag], canonical in [0, p).
"""

from __future__ import annotations

import numpy as np

MOD = (1 << 61) - 1
_P = np.uint64(MOD)
_LO32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_S61 = np.uint64(61)


def _cond_sub_p(x):
    return np.where(x >= _P, x - _P, x)


def _mymult(x, y):
    with np.errstate(over="ignore"):
        xl = x & _LO32
        xh = x >> _S32
        yl = y & _LO32
        yh = y >> _S32
        bd = xl * yl
        ac = xh * yh
        ad_bc = xh * yl + xl * yh
        hi = ac + ((ad_bc + (bd >> _S32)) >> _S32)
        lo = bd + (ad_bc << _S32)
        return ((hi << np.uint64(3)) | (lo >> _S61)) + (lo & _P)


def add(x, y):
    return _cond_sub_p(x + y)


def sub(x, y):
    return _cond_sub_p(x + (y ^ _P))


def mul(x, y):
    with np.errstate(over="ignore"):
        a, b = x[0], x[1]
        c, d = y[0], y[1]
        all_prod = _mymult(a + b, c + d)
        ac = _mymult(a, c)
        bd = _mymult(b, d)
        nac = _cond_sub_p(ac) ^ _P
        nbd = _cond_sub_p(bd) ^ _P
        t_img = all_prod + nac + nbd
        t_img = (t_img >> _S61) + (t_img & _P)
        t_img = _cond_sub_p(t_img)
        t_real = _cond_sub_p(_cond_sub_p(ac + nbd))
        return np.stack([t_real, t_img])


def zeros(shape=()):
    return np.zeros((2,) + tuple(shape), dtype=np.uint64)


def ones(shape=()):
    o = zeros(shape)
    o[0] = 1
    return o


def neg(x):
    return np.stack([_cond_sub_p((x[0] ^ _P)), _cond_sub_p((x[1] ^ _P))])


def base_mul(x, y):
    """Canonical base-field product (full 61-bit Mersenne fold)."""
    with np.errstate(over="ignore"):
        t = _mymult(x, y)
        return _cond_sub_p((t >> _S61) + (t & _P))


def base_inv(x):
    """Base-field inverse by Fermat: x^(p-2), x: (...) u64 canonical."""
    e = MOD - 2
    r = np.ones_like(x)
    b = x
    while e:
        if e & 1:
            r = base_mul(r, b)
        b = base_mul(b, b)
        e >>= 1
    return r


def inv(x):
    """GF(p^2) inverse via conjugate/norm: (a - bi) / (a^2 + b^2).
    p = 2^61-1 == 3 (mod 4), so the norm of a nonzero element is nonzero."""
    a, b = x[0], x[1]
    n = add(base_mul(a, a), base_mul(b, b))
    ninv = base_inv(n)
    return np.stack([base_mul(a, ninv),
                     base_mul(_cond_sub_p(b ^ _P), ninv)])


def pow_int(base_int, exps, shape=None):
    """(base_real, base_img) python ints raised to per-lane exponents.
    exps: int array; returns (2,) + exps.shape."""
    exps = np.asarray(exps, dtype=np.int64)
    r = ones(exps.shape)
    b = np.array([[base_int[0]], [base_int[1]]],
                 dtype=np.uint64).reshape(2, *([1] * exps.ndim))
    b = np.broadcast_to(b, (2,) + exps.shape).copy()
    e = exps.copy()
    while (e > 0).any():
        bit = (e & 1).astype(bool)
        r = np.where(bit[None], mul(r, b), r)
        b = mul(b, b)
        e >>= 1
    return r


def horner(coefs, x):
    """coefs: (2, S, K) per-slice coefficients (ascending powers); x:
    (2, B) evaluation points.  Returns (2, B, S): sum_k c[s,k] x^k."""
    b = x.shape[1]
    s = coefs.shape[1]
    k = coefs.shape[2]
    acc = np.broadcast_to(coefs[:, None, :, k - 1], (2, b, s)).copy()
    xb = x[:, :, None]                      # (2, B, 1)
    for kk in range(k - 2, -1, -1):
        acc = add(mul(acc, xb), coefs[:, None, :, kk])
    return acc
