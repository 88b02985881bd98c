"""Equality ("beta") tables: beta[i] = init * eq(r, bits(i)).

Counterpart of ``virgo_plus_tpu/gkr/beta.py`` (the reference's
initBetaTable, src/utils.cpp:8-45), built by doubling: log(len) steps of one
multiply and one subtract each.
"""

from __future__ import annotations

import torch

from ..field import gf


def beta_table(r, bit_length: int, init):
    """r: (2, >=bit_length) challenges; init: (2,) scalar element.
    Returns (2, 2^bit_length) with entry i = init * prod_j (r_j if bit j of
    i else 1-r_j).  bit_length == 0 returns [[init]]."""
    out = init.reshape(2, 1)
    for j in range(bit_length):
        hi = gf.mul(out, r[:, j:j + 1])
        lo = gf.sub(out, hi)
        out = torch.cat([lo, hi], dim=1)
    return out


def beta_tables_batched(rs, bit_length: int, inits):
    """K same-size tables in one doubling loop.  rs: (2, K, >=bit_length);
    inits: (2, K) -> (2, K, 2^bit_length), bit-identical to beta_table."""
    out = inits[:, :, None]
    for j in range(bit_length):
        hi = gf.mul(out, rs[:, :, j:j + 1])
        lo = gf.sub(out, hi)
        out = torch.cat([lo, hi], dim=2)
    return out
