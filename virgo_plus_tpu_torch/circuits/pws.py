"""``.pws`` circuit-description parser.

Grammar: eight line forms matched by regex, mirroring
reference src/main.cpp:161-207:

    P V<t> = V<a> + V<b> E        Add
    P V<t> = V<a> * V<b> E        Mul
    P V<t> = V<a> XOR V<b> E      Xor
    P V<t> = V<a> minus V<b> E    Sub
    P V<t> = V<a> NAAB V<b> E     Naab
    P V<t> = V<a> NOT V<b> E      Not   (second operand ignored, constant 0)
    P V<t> = I<k> E               Input
    P O<t> = V<a> E               output declaration (parsed, discarded —
                                  main.cpp:189-190 does the same)

Input gate values: the reference assigns ``random() % p`` from the
*default-seeded* glibc stream at parse time (main.cpp:188; srand(3396) only
happens later in F::init) — i.e. witness values are raw 31-bit glibc draws.
We support that mode for transcript parity plus explicit user witnesses,
which the reference does not offer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .gates import GateType
from ..utils.glibc_rand import GlibcRandom

MOD = (1 << 61) - 1

_PATTERNS = [
    (re.compile(r"P V(\d+) = V(\d+) \+ V(\d+) E$"), GateType.Add),
    (re.compile(r"P V(\d+) = V(\d+) \* V(\d+) E$"), GateType.Mul),
    (re.compile(r"P V(\d+) = I(\d+) E$"), GateType.Input),
    (re.compile(r"P O(\d+) = V(\d+) E$"), None),  # output decl
    (re.compile(r"P V(\d+) = V(\d+) XOR V(\d+) E$"), GateType.Xor),
    (re.compile(r"P V(\d+) = V(\d+) minus V(\d+) E$"), GateType.Sub),
    (re.compile(r"P V(\d+) = V(\d+) NAAB V(\d+) E$"), GateType.Naab),
    (re.compile(r"P V(\d+) = V(\d+) NOT V(\d+) E$"), GateType.Not),
]


@dataclass
class DAGGate:
    ty: GateType
    # (kind, value): kind 'V' = wire id, 'S' = scalar constant, 'N' = none
    input0: tuple
    input1: tuple
    is_assert: bool = False


@dataclass
class DAG:
    gates: list = field(default_factory=list)  # indexed by wire id
    outputs: list = field(default_factory=list)  # declared output wires

    def set_gate(self, tgt: int, g: DAGGate):
        if tgt >= len(self.gates):
            self.gates.extend([None] * (tgt + 1 - len(self.gates)))
        self.gates[tgt] = g


def parse_pws(path_or_text: str, witness: Optional[dict] = None,
              rng: Optional[GlibcRandom] = None) -> DAG:
    """Parse a .pws file (path or raw text).

    witness: optional {input_index_order -> value}; when None, input values
    are drawn from `rng` (default: fresh glibc stream seeded 1, matching the
    reference's parse-time behaviour).
    """
    if "\n" in path_or_text or path_or_text.strip().startswith("P "):
        lines = path_or_text.splitlines()
    else:
        with open(path_or_text) as f:
            lines = f.read().splitlines()

    if rng is None:
        rng = GlibcRandom(1)

    dag = DAG()
    n_inputs = 0
    for line in lines:
        if not line.strip():
            continue
        for pat, ty in _PATTERNS:
            m = pat.match(line)
            if not m:
                continue
            nums = [int(x) for x in m.groups()]
            if ty is None:  # output declaration: parsed and discarded
                dag.outputs.append((nums[0], nums[1]))
            elif ty == GateType.Input:
                tgt = nums[0]
                if witness is not None:
                    val = int(witness[n_inputs]) % MOD
                else:
                    val = rng.random() % MOD
                n_inputs += 1
                dag.set_gate(tgt, DAGGate(GateType.Input, ('S', val), ('N', 0)))
            elif ty == GateType.Not:
                # main.cpp:202: buildGate(Not, tgt, src0, 0, has_constant=True)
                dag.set_gate(nums[0], DAGGate(ty, ('V', nums[1]), ('S', 0)))
            else:
                dag.set_gate(nums[0], DAGGate(ty, ('V', nums[1]), ('V', nums[2])))
            break
        else:
            raise ValueError(f"unrecognized .pws line: {line!r}")
    return dag
