"""Radix-2 FFT / IFFT over GF((2^61-1)^2) on int64 planes.

Counterpart of ``virgo_plus_tpu/pc/fft.py`` (reference
lib/virgo/src/RS_polynomial.cpp:26-220).  Each butterfly stage is a reshape,
one vectorized multiply and an add/sub pair; roots of unity are python-int
pairs computed on the host.  Transforms act on the last axis and batch over
any leading axes after the component axis: x is (2, ..., n).
"""

from __future__ import annotations

import torch

from ..field import chains, gf


def powers(base_int, n: int, device):
    """base: python-int pair -> (2, n) [1, base, base^2, ...], one
    ``chains.table`` call (the base goes by value)."""
    return chains.table(chains.POWER, base_int, None, n, device)


def fft(coeffs, log_order: int, rou_int):
    """coeffs: (2, ..., coef_len), coef_len = 2^lg_coef <= 2^log_order;
    rou_int: root of unity of order 2^log_order.  Returns (2, ...,
    2^log_order) evaluations (fast_fourier_transform in the reference)."""
    coef_len = coeffs.shape[-1]
    lg_coef = coef_len.bit_length() - 1
    assert coef_len == 1 << lg_coef
    order = 1 << log_order
    assert lg_coef <= log_order
    lead = tuple(coeffs.shape[1:-1])
    ones_lead = (1,) * len(lead)

    rot_mul = []
    rot = rou_int
    for _ in range(max(lg_coef, 1)):
        rot_mul.append(rot)
        rot = gf._py_mul(rot, rot)

    # block-replicate coefficients (RS_polynomial.cpp:54-60)
    dst = coeffs.repeat((1,) * (coeffs.dim() - 1) + (order // coef_len,))

    for dep in range(lg_coef - 1, -1, -1):
        m = 1 << dep
        half_blk = order >> (dep + 1)
        w = powers(rot_mul[dep], half_blk, coeffs.device)
        w = w.reshape((2,) + ones_lead + (half_blk, 1))
        pre = dst.reshape((2,) + lead + (half_blk, 2, m))
        e = pre[..., 0, :]
        o = pre[..., 1, :]
        t = gf.mul(w, o)
        dst = torch.cat([gf.add(e, t), gf.sub(e, t)], dim=-2)\
                   .reshape((2,) + lead + (order,))
    return dst


def ifft(evals, rou_int):
    """Inverse FFT with coef_len == order (RS_polynomial.cpp:159-220)."""
    n = evals.shape[-1]
    lg = n.bit_length() - 1
    assert n == 1 << lg
    inv_rou = gf.pow_int(rou_int, (1 << lg) - 1)
    out = fft(evals, lg, inv_rou)
    inv_n = gf.pow_int((n % gf.MOD, 0), gf.MOD - 2)
    return gf.mul(out, gf.full((1,), inv_n[0], inv_n[1], evals.device))
