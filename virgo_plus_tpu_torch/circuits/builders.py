"""Programmatic circuit construction (no .pws file needed).

Counterpart of ``virgo_plus_tpu/circuits/builders.py``, copied with its
imports pointing into the port.  The reference's only frontend is the .pws
text format with random witness values (src/main.cpp:176-236).  This builder API constructs DAGs directly —
with real witness values — and lowers them through the same
dag_to_layered/subset_init pipeline, so anything provable from a .pws file
is provable from Python, plus circuits the text format cannot express
(explicit constants via Addc/Mulc, Copy gates, programmatic generators).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from .gates import GateType
from .pws import DAG, DAGGate
from .layered import dag_to_layered, subset_init, LayeredCircuit

MOD = (1 << 61) - 1


@dataclass
class Wire:
    idx: int


class CircuitBuilder:
    """Build a DAG gate by gate; `build()` lowers it to a LayeredCircuit."""

    def __init__(self):
        self._gates: List[DAGGate] = []
        self._n_inputs = 0

    def _push(self, g: DAGGate) -> Wire:
        self._gates.append(g)
        return Wire(len(self._gates) - 1)

    def input(self, value: int) -> Wire:
        self._n_inputs += 1
        return self._push(DAGGate(GateType.Input, ('S', value % MOD),
                                  ('N', 0)))

    def _bin(self, ty: GateType, a: Wire, b: Wire) -> Wire:
        return self._push(DAGGate(ty, ('V', a.idx), ('V', b.idx)))

    def add(self, a, b):
        return self._bin(GateType.Add, a, b)

    def mul(self, a, b):
        return self._bin(GateType.Mul, a, b)

    def sub(self, a, b):
        return self._bin(GateType.Sub, a, b)

    def xor(self, a, b):
        """Boolean XOR for 0/1 wires: x + y - 2xy."""
        return self._bin(GateType.Xor, a, b)

    def naab(self, a, b):
        """(1-a)*b."""
        return self._bin(GateType.Naab, a, b)

    def not_(self, a):
        return self._push(DAGGate(GateType.Not, ('V', a.idx), ('S', 0)))

    def addc(self, a, c: int):
        return self._push(DAGGate(GateType.Addc, ('V', a.idx),
                                  ('S', c % MOD)))

    def mulc(self, a, c: int):
        return self._push(DAGGate(GateType.Mulc, ('V', a.idx),
                                  ('S', c % MOD)))

    def copy(self, a):
        return self._push(DAGGate(GateType.Copy, ('V', a.idx), ('S', 0)))

    def sum(self, wires: List[Wire]) -> Wire:
        """Balanced addition tree (log depth)."""
        layer = list(wires)
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                nxt.append(self.add(layer[i], layer[i + 1]))
            if len(layer) % 2:
                # keep the odd wire level-aligned via a Copy gate
                nxt.append(self.copy(layer[-1]))
            layer = nxt
        return layer[0]

    def assert_zero(self, a) -> None:
        """Mark a wire as an assert gate: the prover must refuse to prove
        unless it evaluates to zero (reference setAssertion/prover ctor,
        src/main.cpp:233-236, src/prover.cpp:14-25; machinery is dead code
        in the reference CLI but live protocol support exists via
        assert_random binding, verifier.cpp:202,50-54)."""
        self._gates[a.idx].is_assert = True

    def build(self, bug_compat: bool = False) -> LayeredCircuit:
        dag = DAG(gates=list(self._gates))
        c = dag_to_layered(dag, bug_compat=bug_compat)
        subset_init(c)
        return c


def matmul_circuit(k: int, a: np.ndarray = None, b: np.ndarray = None,
                   seed: int = 0) -> LayeredCircuit:
    """A k x k matrix product as an arithmetic circuit: k^2 multiply gates
    per output entry + a log-depth addition tree — the framework's 'matmul
    model' (exercises deep cross-layer wiring)."""
    rng = np.random.default_rng(seed)
    if a is None:
        a = rng.integers(0, 1 << 31, (k, k))
    if b is None:
        b = rng.integers(0, 1 << 31, (k, k))
    cb = CircuitBuilder()
    aw = [[cb.input(int(a[i, j])) for j in range(k)] for i in range(k)]
    bw = [[cb.input(int(b[i, j])) for j in range(k)] for i in range(k)]
    for i in range(k):
        for j in range(k):
            prods = [cb.mul(aw[i][t], bw[t][j]) for t in range(k)]
            cb.sum(prods)
    return cb.build()


def sha256_circuit_path() -> str:
    """The reference's SHA-256 benchmark circuit (64 message blocks), where
    the checkout keeps it: ``tests/data/SHA256_64.pws``.  The file is not
    committed yet (ROADMAP F0), so the path may not exist."""
    return str(Path(__file__).resolve().parents[2] / "tests" / "data"
               / "SHA256_64.pws")
