"""Equality ("beta") tables: beta[i] = init * eq(r, bits(i)).

Counterpart of ``virgo_plus_tpu/gkr/beta.py`` (the reference's
initBetaTable, src/utils.cpp:8-45).  Each call is one ``chains.table``: on
the card one ``gf_table`` launch, on the CPU the doubling loop (log(len)
steps of one multiply and one subtract each).
"""

from __future__ import annotations

from ..field import chains


def beta_table(r, bit_length: int, init):
    """r: (2, >=bit_length) challenges; init: (2,) scalar element.
    Returns (2, 2^bit_length) with entry i = init * prod_j (r_j if bit j of
    i else 1-r_j).  bit_length == 0 returns [[init]]."""
    return chains.table(chains.BETA, init, r[:, :bit_length],
                        1 << bit_length, init.device)


def beta_table_plain(r, bit_length: int, init):
    """beta_table by the plain twin (``chains.table_plain``) on any
    device: the verifier entries' twins."""
    return chains.table_plain(chains.BETA, init, r[:, :bit_length],
                              1 << bit_length, init.device)


def beta_tables_batched(rs, bit_length: int, inits):
    """K same-size tables in one call.  rs: (2, K, >=bit_length);
    inits: (2, K) -> (2, K, 2^bit_length), bit-identical to beta_table."""
    return chains.table(chains.BETA, inits, rs[:, :, :bit_length],
                        1 << bit_length, inits.device)
