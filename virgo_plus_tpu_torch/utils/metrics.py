"""Observability: analytic field-op accounting and phase timers.

The reference counts field operations with global counters incremented
inside operator+/operator* (fieldElement.cpp:34-53, gated by isCounting and
toggled around the sumcheck sections) and accumulating wall-clock timers
(timer.hpp, prover.h:64, verifier.h:45-46).  This module keeps the two
concerns apart:

* ``protocol_op_counts``: the *analytic* operation count of the protocol —
  derived from circuit shape, it reproduces what the reference's counters
  measure (its loops execute exactly the formula's number of ops) without
  perturbing the hot path;
* ``device_op_counts``: the ops the vectorized kernels actually perform,
  including power-of-two padding and masked lanes;
* ``PhaseTimer``: host-side accumulating wall timers around device calls
  (same role as the reference's prove/verify/slow timers).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class OpCounts:
    mult: int = 0
    add: int = 0

    def __add__(self, o):
        return OpCounts(self.mult + o.mult, self.add + o.add)


def protocol_op_counts(cc) -> OpCounts:
    """Analytic sumcheck op counts for the reference's algorithm on this
    circuit (the quantity behind `mult counter` in main.cpp:157).

    Per fold pair: 6 evals + 4 product muls (reference interpolate/eval,
    prover.cpp:470-487); scatter contributions: ~2 muls per gate per phase;
    beta tables: one mul per entry."""
    c = OpCounts()
    for i in range(cc.depth - 1, 0, -1):
        L = cc.layers[i]
        bl_prev = cc.layers[i - 1].bit_length
        n_prev = 1 << bl_prev
        # phase-1 init: beta_g build (2^bl_i) + 2 muls/gate scatter
        c.mult += (1 << L.bit_length) + 2 * L.size
        # phase-1 rounds: sum over rounds of 10 muls per pair
        c.mult += 10 * (n_prev - 1)
        c.add += 12 * (n_prev - 1)
        if L.max_dad_bit_length >= 0:
            # phase-2 init: beta_u + beta_g*beta_u per gate + 2 muls/gate
            c.mult += n_prev + 3 * L.size
            tot = sum((1 << bl) for bl, ds in
                      zip(L.dad_bls, L.dad_sizes) if ds > 0)
            c.mult += 10 * max(tot - 1, 0)
            c.add += 12 * max(tot - 1, 0)
        # Liu init: beta tables of r_u and consumers
        c.mult += n_prev
        c.mult += 10 * (n_prev - 1)
        c.add += 12 * (n_prev - 1)
    return c


def device_op_counts(cc) -> OpCounts:
    """Ops the vectorized kernels actually execute (padded lanes included):
    scan folds run bl rounds over a fixed half-size buffer."""
    c = OpCounts()
    for i in range(cc.depth - 1, 0, -1):
        L = cc.layers[i]
        bl_prev = cc.layers[i - 1].bit_length
        half = (1 << bl_prev) // 2
        c.mult += 13 * half * bl_prev * 2        # phase1 + liu scans
        c.add += 15 * half * bl_prev * 2
        c.mult += (1 << L.bit_length) + 4 * L.size
        if L.max_dad_bit_length >= 0:
            tot = sum((1 << bl) for bl, ds in
                      zip(L.dad_bls, L.dad_sizes) if ds > 0)
            c.mult += 13 * (tot // 2) * L.max_dad_bit_length
            c.mult += (1 << bl_prev) + 4 * L.size
    return c


class PhaseTimer:
    """Accumulating wall-clock timers per named phase (timer.hpp analogue)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self._t0 = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()

    def stop(self, name: str):
        self.acc[name] += time.perf_counter() - self._t0.pop(name)

    @contextmanager
    def span(self, name: str, sync=None):
        """Time a block; ``sync`` (e.g. torch.cuda.synchronize) runs at both
        ends so device work is charged to the phase that queued it."""
        if sync is not None:
            sync()
        self.start(name)
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.stop(name)

    def report(self) -> dict:
        return dict(self.acc)
