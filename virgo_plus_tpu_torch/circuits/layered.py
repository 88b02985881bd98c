"""DAG -> layered circuit transform and subset ("dad") table construction.

Semantics match reference src/main.cpp:15-137 (Kahn toposort, per-layer
re-indexing, left-input-in-previous-layer normalisation with Sub->AntiSub /
Naab->AntiNaab operand flips) and reference src/circuit.cpp:43-80
(reverse-sweep subset tables), re-expressed as host-side numpy "AOT
compilation" that emits static index arrays for the device kernels.

``bug_compat=True`` reproduces the reference's missing-``break`` fallthrough
(main.cpp:104-110): Not/Copy gates keep the *raw DAG id* as their left input
and drop the constant.  The reference's prover and verifier read the same
table so its protocol stays self-consistent; we replicate the table (not the
C++ out-of-bounds heap reads it may cause during evaluation — see
dag_to_layered for the containment check).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .gates import GateType, BINARY_TYPES
from .pws import DAG

MOD = (1 << 61) - 1

_SENTINEL_EMPTY = -(1 << 31)  # reference: (int)log2(0) == INT_MIN


def _bit_length(size: int) -> int:
    """ceil(log2(size)) for size >= 1 (main.cpp:133-136)."""
    return max(0, int(size - 1).bit_length())


@dataclass
class Layer:
    # per-gate arrays, length = size
    ty: np.ndarray          # int32
    u: np.ndarray           # int64: left input id in layer i-1 (or input value row)
    v: np.ndarray           # int64: right input id within source layer l
    l: np.ndarray           # int32: source layer of right input, -1 for unary
    lv: np.ndarray          # int64: right input id within subset table (set by subset_init)
    c_real: np.ndarray      # uint64 constant
    c_img: np.ndarray       # uint64
    is_assert: np.ndarray   # bool
    size: int = 0
    bit_length: int = 0
    # subset tables (filled by subset_init)
    dad_id: List[np.ndarray] = field(default_factory=list)   # per source layer
    dad_size: List[int] = field(default_factory=list)
    dad_bit_length: List[int] = field(default_factory=list)  # _SENTINEL_EMPTY for empty
    max_dad_size: int = 0
    max_dad_bit_length: int = -1


@dataclass
class LayeredCircuit:
    layers: List[Layer]
    input_values: np.ndarray = None  # (2, size0) uint64 [real, img] witness

    @property
    def size(self) -> int:
        return len(self.layers)


def dag_to_layered(dag: DAG, bug_compat: bool = True) -> LayeredCircuit:
    n = len(dag.gates)
    gates = dag.gates
    lyr_id = np.zeros(n, dtype=np.int64)
    in_deg = np.zeros(n, dtype=np.int64)
    edges: List[List[int]] = [[] for _ in range(n)]

    from collections import deque
    q = deque()
    for i, g in enumerate(gates):
        if g is None:
            raise ValueError(f"wire {i} never defined")
        if g.input0[0] == 'V':
            in_deg[i] += 1
            edges[g.input0[1]].append(i)
        if g.input1[0] == 'V':
            in_deg[i] += 1
            edges[g.input1[1]].append(i)
        if g.ty == GateType.Input:
            lyr_id[i] = 0
            q.append(i)

    max_lyr = 0
    while q:
        u = q.popleft()
        max_lyr = max(max_lyr, int(lyr_id[u]))
        for v in edges[u]:
            in_deg[v] -= 1
            lyr_id[v] = max(lyr_id[v], lyr_id[u] + 1)
            if in_deg[v] == 0:
                q.append(v)

    n_layers = max_lyr + 1
    layer_sizes = np.zeros(n_layers, dtype=np.int64)
    id_in_lyr = np.zeros(n, dtype=np.int64)
    for i in range(n):
        lg = int(lyr_id[i])
        id_in_lyr[i] = layer_sizes[lg]
        layer_sizes[lg] += 1

    # allocate per-layer arrays
    def _mk(sz):
        return Layer(
            ty=np.zeros(sz, np.int32), u=np.zeros(sz, np.int64),
            v=np.zeros(sz, np.int64), l=np.full(sz, -1, np.int32),
            lv=np.zeros(sz, np.int64),
            c_real=np.zeros(sz, np.uint64), c_img=np.zeros(sz, np.uint64),
            is_assert=np.zeros(sz, bool), size=int(sz),
            bit_length=_bit_length(int(sz)))

    layers = [_mk(s) for s in layer_sizes]
    input_vals = np.zeros((2, int(layer_sizes[0])), dtype=np.uint64)

    for i in range(n):
        g = gates[i]
        lg = int(lyr_id[i])
        gid = int(id_in_lyr[i])
        L = layers[lg]
        ty = g.ty
        in0 = g.input0[1]
        in1 = g.input1[1]
        L.is_assert[gid] = g.is_assert

        if ty in (GateType.Mul, GateType.Add, GateType.Xor,
                  GateType.Sub, GateType.Naab):
            u, v = int(id_in_lyr[in0]), int(id_in_lyr[in1])
            nty = ty
            if lyr_id[in0] < lg - 1:
                u, v = v, u
                in0, in1 = in1, in0
                if ty == GateType.Sub:
                    nty = GateType.AntiSub
                elif ty == GateType.Naab:
                    nty = GateType.AntiNaab
            L.ty[gid] = int(nty)
            L.l[gid] = int(lyr_id[in1])
            L.u[gid] = u
            L.v[gid] = v
        elif ty in (GateType.Mulc, GateType.Addc):
            L.ty[gid] = int(ty)
            L.u[gid] = int(id_in_lyr[in0])
            L.c_real[gid] = in1 % MOD
        elif ty in (GateType.Not, GateType.Copy):
            L.ty[gid] = int(ty)
            if bug_compat:
                # main.cpp:104-110 fallthrough into the Input case:
                # u <- raw DAG id, constant dropped.
                L.u[gid] = in0
            else:
                L.u[gid] = int(id_in_lyr[in0])
                L.c_real[gid] = in1 % MOD
        elif ty == GateType.Input:
            L.ty[gid] = int(ty)
            L.u[gid] = gid  # value row; actual value in input_vals
            input_vals[0, gid] = in0 % MOD
        else:
            raise ValueError(f"unsupported gate type {ty}")

    return LayeredCircuit(layers=layers, input_values=input_vals)


def repeat_layers(c: LayeredCircuit, repeat: int) -> LayeredCircuit:
    """Replicate every non-input layer's gates `repeat` times
    (main.cpp:8,114-131 — dead in the reference: const repeat = 1, and its
    loop body both aliases a vector reference across push_back (UB) and
    offsets wire ids by the *consuming* layer's size).  This implements the
    evident intent with correct offsets: replica j of a gate reads replica
    j of its source layers — u += j * size(i-1) for i > 1, v += j * size(l)
    for l >= 1; the input layer is shared by all replicas (as in the
    reference, which replicates "except the input")."""
    if repeat <= 1:
        return c
    sizes = [L.size for L in c.layers]
    out = [c.layers[0]]
    for i in range(1, c.size):
        L = c.layers[i]
        reps = []
        for j in range(repeat):
            u = L.u.copy()
            if i > 1:
                u += j * sizes[i - 1]
            src_sizes = np.array(sizes, np.int64)[np.maximum(L.l, 0)]
            v = L.v + np.where(L.l >= 1, j * src_sizes, 0)
            reps.append((L.ty, u, v, L.l, L.c_real, L.c_img, L.is_assert))
        new_size = L.size * repeat
        out.append(Layer(
            ty=np.concatenate([r[0] for r in reps]),
            u=np.concatenate([r[1] for r in reps]),
            v=np.concatenate([r[2] for r in reps]),
            l=np.concatenate([r[3] for r in reps]),
            lv=np.zeros(new_size, np.int64),
            c_real=np.concatenate([r[4] for r in reps]),
            c_img=np.concatenate([r[5] for r in reps]),
            is_assert=np.concatenate([r[6] for r in reps]),
            size=new_size, bit_length=_bit_length(new_size)))
    return LayeredCircuit(layers=out, input_values=c.input_values)


def check_bug_compat_contained(c: LayeredCircuit) -> bool:
    """True iff every bug-compat Not/Copy left-input raw id is still within
    the previous layer's value table (2^bit_length entries) — i.e. the
    reference would NOT be reading out of bounds and bit parity is feasible."""
    ok = True
    for i in range(1, c.size):
        L = c.layers[i]
        mask = (L.ty == int(GateType.Not)) | (L.ty == int(GateType.Copy))
        if mask.any():
            limit = c.layers[i - 1].size
            if int(L.u[mask].max()) >= limit:
                ok = False
    return ok


def subset_init(c: LayeredCircuit) -> None:
    """Build dad (subset) tables: for each layer i and source layer l < i,
    the ordered set of layer-l gates referenced by layer i's right inputs.
    Order matches the reference's reverse gate sweep (circuit.cpp:58-69):
    first-visited while scanning gates from high index to low."""
    size = c.size
    for i in range(size):
        L = c.layers[i]
        L.dad_id = [np.zeros(0, np.int64) for _ in range(i)]
        L.dad_size = [0] * i
        L.dad_bit_length = [_SENTINEL_EMPTY] * i
        L.max_dad_size = 0
        L.max_dad_bit_length = -1

    for i in range(size - 1, 0, -1):
        L = c.layers[i]
        has_l = L.l >= 0
        # scan order: gate index descending
        order = np.arange(L.size - 1, -1, -1)
        ls = L.l[order]
        vs = L.v[order]
        sel = has_l[order]
        for l in range(i):
            m = sel & (ls == l)
            if not m.any():
                L.dad_size[l] = 0
                L.dad_bit_length[l] = _SENTINEL_EMPTY
                continue
            vseq = vs[m]  # right-input ids in descending-gate order
            # first occurrence order within vseq
            _, first_idx = np.unique(vseq, return_index=True)
            order_first = np.sort(first_idx)
            dad = vseq[order_first]           # subset members, visit order
            sub_idx = {int(v): k for k, v in enumerate(dad)}
            L.dad_id[l] = dad.astype(np.int64)
            L.dad_size[l] = len(dad)
            L.dad_bit_length[l] = _bit_length(len(dad))
            # write back lv for the gates
            gmask = has_l & (L.l == l)
            L.lv[gmask] = np.array([sub_idx[int(v)] for v in L.v[gmask]],
                                   dtype=np.int64)
        for l in range(i):
            if L.dad_size[l] > 0:
                L.max_dad_size = max(L.max_dad_size, L.dad_size[l])
                L.max_dad_bit_length = max(L.max_dad_bit_length,
                                           L.dad_bit_length[l])


def randomize(n_layers: int, each_layer_bits: int,
              rng=None, seed: int = 0) -> LayeredCircuit:
    """Synthetic random Add/Mul circuit generator, analogous to
    layeredCircuit::randomize (circuit.cpp:17-41): layer 0 is random inputs,
    each later layer draws gate type Add/Mul, a random earlier source layer
    for the right input, and random wire ids."""
    if rng is None:
        rng = np.random.default_rng(seed)
    gate_size = 1 << each_layer_bits

    layers = []
    L0 = Layer(
        ty=np.full(gate_size, int(GateType.Input), np.int32),
        u=np.arange(gate_size, dtype=np.int64),
        v=np.zeros(gate_size, np.int64), l=np.full(gate_size, -1, np.int32),
        lv=np.zeros(gate_size, np.int64),
        c_real=np.zeros(gate_size, np.uint64), c_img=np.zeros(gate_size, np.uint64),
        is_assert=np.zeros(gate_size, bool), size=gate_size,
        bit_length=each_layer_bits)
    layers.append(L0)
    input_vals = np.zeros((2, gate_size), dtype=np.uint64)
    input_vals[0] = rng.integers(0, 1 << 31, gate_size, dtype=np.uint64)

    for i in range(1, n_layers):
        ty = np.where(rng.integers(0, 2, gate_size) == 0,
                      int(GateType.Add), int(GateType.Mul)).astype(np.int32)
        l = rng.integers(0, i, gate_size).astype(np.int32)
        u = rng.integers(0, gate_size, gate_size, dtype=np.int64)
        v = rng.integers(0, gate_size, gate_size, dtype=np.int64)
        layers.append(Layer(
            ty=ty, u=u, v=v, l=l, lv=np.zeros(gate_size, np.int64),
            c_real=np.zeros(gate_size, np.uint64),
            c_img=np.zeros(gate_size, np.uint64),
            is_assert=np.zeros(gate_size, bool), size=gate_size,
            bit_length=each_layer_bits))

    return LayeredCircuit(layers=layers, input_values=input_vals)
