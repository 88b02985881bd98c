"""Dense low-degree polynomials over GF((2^61-1)^2), batched.

Counterpart of ``virgo_plus_tpu/gkr/polynomial.py`` (the reference's
src/polynomial.{h,cpp}).  A degree-d batch is a (2, d+1, ...) coefficient
tensor, coefficients high to low.
"""

from __future__ import annotations

import torch

from ..field import gf


def poly(coeffs):
    """Stack (2,)-shaped field scalars (high coeff first) into (2, d+1)."""
    return torch.stack(coeffs, dim=1)


def degree(p) -> int:
    return p.shape[1] - 1


def eval_at(p, x):
    """Horner: p (2, d+1, ...), x (2, ...) -> (2, ...)."""
    acc = p[:, 0]
    for k in range(1, p.shape[1]):
        acc = gf.add(gf.mul(acc, x), p[:, k])
    return acc


def _pad_front(p, d: int):
    z = torch.zeros((2, d - p.shape[1]) + tuple(p.shape[2:]),
                    dtype=p.dtype, device=p.device)
    return torch.cat([z, p], dim=1)


def add(p, q):
    """Pad to common degree and add coefficient-wise."""
    d = max(p.shape[1], q.shape[1])
    return gf.add(_pad_front(p, d), _pad_front(q, d))


def mul(p, q):
    """Full convolution product (polynomial.cpp's operator*)."""
    dp, dq = p.shape[1], q.shape[1]
    out = None
    for i in range(dp):
        for j in range(dq):
            term = gf.mul(p[:, i], q[:, j])
            padded = torch.zeros((2, dp + dq - 1) + tuple(term.shape[1:]),
                                 dtype=term.dtype, device=term.device)
            padded[:, i + j] = term
            out = padded if out is None else gf.add(out, padded)
    return out
