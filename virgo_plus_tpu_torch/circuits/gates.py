"""Gate types and their uniform (A, B, C, D) coefficient form.

The reference dispatches on 12 gate types with a switch in every hot loop
(evaluate: reference src/prover.cpp:49-87, phase-1 scatter:
prover.cpp:229-272, phase-2 scatter: prover.cpp:319-360).  This
design removes all branching by expressing every gate as

    out = A * V_u  +  B * V_v  +  C * V_u * V_v  +  D

with per-gate field coefficients.  The same four coefficients drive

  * forward evaluation      (gather x, y; fused multiply-add),
  * the phase-1 init        add[u]  += beta_g * (B*y + D)
                            mult[u] += beta_g * (A + C*y),
  * the phase-2 init        addV[l][lv]  += beta_g*beta_u[u] * (A*V_u + D)
                            mult[l][lv]  += beta_g*beta_u[u] * (B + C*V_u),
  * the verifier predicate  sum beta_g*beta_u[u]*beta_v[lv] *
                            (A*claim_u + B*claim_v + C*claim_u*claim_v + D)

which are verified term-by-term against the reference's per-type switches.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

MOD = (1 << 61) - 1


class GateType(IntEnum):
    # Same ordinals as the reference enum (src/inputCircuit.hpp:14-16)
    Mul = 0
    Add = 1
    Sub = 2
    AntiSub = 3
    Naab = 4
    AntiNaab = 5
    Input = 6
    Mulc = 7
    Addc = 8
    Xor = 9
    Not = 10
    Copy = 11


BINARY_TYPES = frozenset({
    GateType.Mul, GateType.Add, GateType.Sub, GateType.AntiSub,
    GateType.Naab, GateType.AntiNaab, GateType.Xor,
})

UNARY_TYPES = frozenset({
    GateType.Mulc, GateType.Addc, GateType.Not, GateType.Copy,
})

_NEG1 = MOD - 1
_NEG2 = MOD - 2

# type -> (A, B, C, D) with 'c' placeholders resolved per gate.
# Semantics cite prover.cpp:49-87.
_COEFF = {
    GateType.Mul:      (0, 0, 1, 0),        # x*y
    GateType.Add:      (1, 1, 0, 0),        # x+y
    GateType.Sub:      (1, _NEG1, 0, 0),    # x-y
    GateType.AntiSub:  (_NEG1, 1, 0, 0),    # y-x
    GateType.Naab:     (0, 1, _NEG1, 0),    # y - x*y
    GateType.AntiNaab: (1, 0, _NEG1, 0),    # x - x*y
    GateType.Mulc:     ("c", 0, 0, 0),      # x*c
    GateType.Addc:     (1, 0, 0, "c"),      # x+c
    GateType.Xor:      (1, 1, _NEG2, 0),    # x+y-2xy
    GateType.Not:      (_NEG1, 0, 0, 1),    # 1-x
    GateType.Copy:     (1, 0, 0, 0),        # x
}


def coeff_tables(types, c_real, c_img):
    """Build per-gate (A, B, C, D) coefficient arrays.

    types : int array [n]
    c_real, c_img : uint64 arrays [n], the per-gate constant (Addc/Mulc)

    Returns four pairs of uint64 arrays ((A_r, A_i), (B_r, B_i), ...).
    """
    n = len(types)
    out = []
    for slot in range(4):
        real = np.zeros(n, dtype=np.uint64)
        img = np.zeros(n, dtype=np.uint64)
        for ty, coeffs in _COEFF.items():
            mask = types == int(ty)
            if not mask.any():
                continue
            cv = coeffs[slot]
            if cv == "c":
                real[mask] = c_real[mask]
                img[mask] = c_img[mask]
            else:
                real[mask] = cv
        out.append((real, img))
    return out
