"""Compilation of a layered circuit into static index arrays, and evaluation.

Counterpart of ``virgo_plus_tpu/circuits/compile.py``.  ``compile_circuit``
is host numpy and a copy of the JAX package's; ``evaluate`` runs on the
device.  The compiled form:

  * one concatenated value buffer with per-layer power-of-two blocks
    (layer i occupies value_off[i] : value_off[i] + 2^bit_length),
  * per-layer gather indices x_idx (left input, in layer i-1's block) and
    y_idx (right input, global index into the value buffer),
  * per-gate (A, B, C, D) coefficient planes (gates.py),
  * phase-2 scatter coordinates flattened to one index into a concatenated
    dad-table buffer, and dad gather indices for the phase-2 V tables.

Forward evaluation (prover.cpp:27-91 analogue) is, per layer:
    x = values[x_idx]; y = values[y_idx]
    out = A*x + B*y + C*(x*y) + D
On a CUDA tensor the whole evaluation is one launch of ``gf_evaluate``
(``csrc/circuit_eval.cu``) over a flat plan (``eval_plan``), on a CPU
tensor its plain twin, the layer loop.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from ..field import gf
from .gates import coeff_tables
from .layered import LayeredCircuit


@dataclass
class CompiledLayer:
    size: int
    bit_length: int
    padded: int
    x_idx: np.ndarray             # int32, into previous layer's padded block
    y_idx: np.ndarray             # int32, global into value buffer
    coeff: np.ndarray             # uint64 (4 coeffs, 2 comps, size)
    is_assert: Optional[np.ndarray]
    has_assert: bool
    # phase-2 scatter: per gate, flat index into concat dad buffer (unary
    # gates scatter to the synthetic (i-1, 0) slot per prover.cpp:314)
    dad_sizes: List[int]          # per source layer l in [0, i)
    dad_bls: List[int]            # -inf sentinel for empty
    dad_offsets: List[int]        # offsets into the concat dad buffer
    dad_padded_total: int
    p2_flat_idx: Optional[np.ndarray]     # int32 per gate
    dad_gather_idx: Optional[np.ndarray]  # int32 global value index, -1 pad
    max_dad_bit_length: int


@dataclass
class CompiledCircuit:
    layers: List[CompiledLayer]
    value_off: np.ndarray         # int64 per layer
    total_values: int
    max_bl: int
    n_inputs: int
    input_bl: int
    source: LayeredCircuit

    @property
    def depth(self) -> int:
        return len(self.layers)


def _coeff_planes(L) -> np.ndarray:
    (Ar, Ai), (Br, Bi), (Cr, Ci), (Dr, Di) = coeff_tables(L.ty, L.c_real, L.c_img)
    out = np.zeros((4, 2, L.size), dtype=np.uint64)
    for k, (r, i) in enumerate(((Ar, Ai), (Br, Bi), (Cr, Ci), (Dr, Di))):
        out[k, 0] = r
        out[k, 1] = i
    return out


def compile_circuit(c: LayeredCircuit) -> CompiledCircuit:
    n_layers = c.size
    padded = [1 << L.bit_length for L in c.layers]
    value_off = np.zeros(n_layers, dtype=np.int64)
    for i in range(1, n_layers):
        value_off[i] = value_off[i - 1] + padded[i - 1]
    total_values = int(value_off[-1] + padded[-1])

    layers: List[CompiledLayer] = []
    max_bl = max(L.bit_length for L in c.layers)

    for i, L in enumerate(c.layers):
        if i == 0:
            layers.append(CompiledLayer(
                size=L.size, bit_length=L.bit_length, padded=padded[0],
                x_idx=None, y_idx=None, coeff=None,
                is_assert=None, has_assert=False,
                dad_sizes=[], dad_bls=[], dad_offsets=[],
                dad_padded_total=0, p2_flat_idx=None, dad_gather_idx=None,
                max_dad_bit_length=-1))
            continue

        x_idx = L.u.astype(np.int32)
        unary = L.l < 0
        src_l = np.where(unary, i - 1, L.l).astype(np.int64)
        y_idx = (value_off[src_l] + np.where(unary, 0, L.v)).astype(np.int32)

        # phase-2 concat dad buffer: per source layer l in [0, i) a padded
        # block of 2^dad_bl (empty layers get the reference's synthetic
        # 1-entry zero table)
        dad_sizes, dad_bls, dad_offsets = [], [], []
        off = 0
        for l in range(i):
            ds = L.dad_size[l]
            bl = L.dad_bit_length[l]
            dad_sizes.append(int(ds))
            dad_bls.append(int(bl))
            dad_offsets.append(off)
            off += (1 << bl) if ds > 0 else 1
        dad_padded_total = off

        p2_flat = None
        dad_gather = None
        if L.max_dad_bit_length >= 0:
            offs = np.array(dad_offsets + [0], dtype=np.int64)  # dummy tail
            tgt_l = np.where(unary, i - 1, L.l).astype(np.int64)
            tgt_lv = np.where(unary, 0, L.lv)
            p2_flat = (offs[tgt_l] + tgt_lv).astype(np.int32)
            # dad gather: for each slot in the concat dad buffer, the global
            # value index it reads (prover.cpp:303), -1 for padding slots
            dg = np.full(dad_padded_total, -1, dtype=np.int64)
            for l in range(i):
                ds = L.dad_size[l]
                if ds > 0:
                    dg[dad_offsets[l]:dad_offsets[l] + ds] = (
                        value_off[l] + L.dad_id[l])
            dad_gather = dg.astype(np.int32)

        layers.append(CompiledLayer(
            size=L.size, bit_length=L.bit_length, padded=padded[i],
            x_idx=x_idx, y_idx=y_idx,
            coeff=_coeff_planes(L),
            is_assert=L.is_assert if L.is_assert.any() else None,
            has_assert=bool(L.is_assert.any()),
            dad_sizes=dad_sizes, dad_bls=dad_bls, dad_offsets=dad_offsets,
            dad_padded_total=dad_padded_total,
            p2_flat_idx=p2_flat,
            dad_gather_idx=dad_gather,
            max_dad_bit_length=L.max_dad_bit_length))

    return CompiledCircuit(
        layers=layers, value_off=value_off, total_values=total_values,
        max_bl=max_bl, n_inputs=c.layers[0].size,
        input_bl=c.layers[0].bit_length, source=c)


def input_buffer(cc: CompiledCircuit, witness: Optional[np.ndarray],
                 device):
    """(2, 2^input_bl) int64 padded input-layer values on the device.  A
    (B, 2, n) witness batch gives (2, B, 2^input_bl)."""
    if witness is None:
        witness = cc.source.input_values
    witness = np.asarray(witness)
    vals = np.zeros((2,) + witness.shape[:-2] + (cc.layers[0].padded,),
                    dtype=np.uint64)
    vals[..., :witness.shape[-1]] = np.moveaxis(witness, -2, 0)
    return gf.tensor(vals, device)


def index(a, device):
    """Host index array -> int64 tensor on the device."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


# csrc/circuit_eval.cu's launch shape and grouping rule (eval_launches)
EVAL_THREADS = 512     # THREADS
EVAL_CLUSTER = 16      # CLUSTER: most blocks a cluster (sizes 1, 2, 4, ...)
EVAL_LAYERS = 32       # MAX_LAYERS: steps a launch
EVAL_WORK = 16         # most gate-rows a thread of a cluster launch, a step
EVAL_BLOCKS = 132 * 2  # blocks a launch of one wide step aims for
COPY = -1              # a step's size: the input copy
# the plan's step table columns
G0, SIZE, X_OFF, OUT_OFF, PADDED = range(5)


@dataclass
class EvalPlan:
    """A circuit's evaluation as one flat plan, made once per circuit:
    x_idx, y_idx (int32) and the coefficient planes co (4, 2, gates) of
    every layer after the first, side by side, and the host step table
    (depth, 5) int64: the input copy (size COPY), then each layer's first
    gate, size, x_off, out_off and padded."""
    x_idx: torch.Tensor
    y_idx: torch.Tensor
    co: torch.Tensor
    steps: np.ndarray
    total: int


def make_plan(layers, input_padded: int, total: int, device) -> EvalPlan:
    """The EvalPlan of an input block of `input_padded` values and
    `layers`, each (x_idx, y_idx, coeff (4, 2, size), x_off, out_off,
    padded), in a buffer of `total` values a row."""
    steps, g0 = [(0, COPY, 0, 0, input_padded)], 0
    for x_idx, _, _, x_off, out_off, padded in layers:
        steps.append((g0, len(x_idx), x_off, out_off, padded))
        g0 += len(x_idx)
    idx = lambda k: torch.from_numpy(np.concatenate(
        [np.asarray(L[k]) for L in layers] or [np.zeros(0)]).astype(
            np.int32)).to(device)
    co = (np.concatenate([L[2] for L in layers], -1) if layers
          else np.zeros((4, 2, 0), dtype=np.uint64))
    return EvalPlan(x_idx=idx(0), y_idx=idx(1), co=gf.tensor(co, device),
                    steps=np.array(steps, dtype=np.int64), total=total)


def eval_plan(cc: CompiledCircuit, device) -> EvalPlan:
    return make_plan([(L.x_idx, L.y_idx, L.coeff, int(cc.value_off[i - 1]),
                       int(cc.value_off[i]), L.padded)
                      for i, L in enumerate(cc.layers[1:], 1)],
                     cc.layers[0].padded, cc.total_values, device)


def eval_arrays(cc: CompiledCircuit, device) -> dict:
    """The evaluation plan on the device ("ev"), made once per circuit."""
    return {"ev": eval_plan(cc, device)}


def coeffs(co, n_lead: int):
    """A layer's (4, 2, size) coefficient planes as A, B, C, D, each shaped
    (2, 1, ..., size) to broadcast over `n_lead` batch axes."""
    return co.reshape((4, 2) + (1,) * n_lead + (-1,))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def eval_shape(rows: int, fits: dict) -> tuple:
    """(blocks a cluster, row groups, rows a group) of gf_evaluate's
    cluster launches for `rows` rows, when fits[k] clusters of k blocks fit
    on the card at once: the size whose groups carry the fewest rows a
    block (the larger size on a tie), its groups as many as fit."""
    best = None
    for k in sorted(fits, reverse=True):
        if fits[k] < 1:
            continue
        per = _cdiv(rows, min(rows, fits[k]))
        if best is None or per * best[0] < best[2] * k:
            best = (k, _cdiv(rows, per), per)
    return best


def eval_launches(steps: np.ndarray, rows: int, fits: dict) -> list:
    """gf_evaluate's launches for `rows` rows of the plan's steps (fits as
    eval_shape takes it): (first step, steps, blocks a cluster, row
    groups, rows a group, gate blocks) each.  A cluster launch
    (eval_shape's) takes consecutive steps while each step's gate-rows a
    thread stay at most EVAL_WORK (and at most EVAL_LAYERS steps); a step
    above the bound gets a launch of its own, its gates over blocks
    (clusters of one) and its rows split so that the grid holds about
    EVAL_BLOCKS blocks.  None for no rows."""
    if rows <= 0:
        return []
    cs, groups, per = eval_shape(rows, fits)
    work = lambda i: _cdiv(int(steps[i, PADDED]) * per, cs * EVAL_THREADS)
    out, first, depth = [], 0, len(steps)
    while first < depth:
        if work(first) > EVAL_WORK:
            split = _cdiv(int(steps[first, PADDED]), EVAL_THREADS)
            wide = _cdiv(rows, min(rows, _cdiv(EVAL_BLOCKS, split)))
            out.append((first, 1, 1, _cdiv(rows, wide), wide, split))
            first += 1
            continue
        last = first + 1
        while (last < depth and last - first < EVAL_LAYERS
               and work(last) <= EVAL_WORK):
            last += 1
        out.append((first, last - first, cs, groups, per, 1))
        first = last
    return out


_FITS: dict = {}   # device index -> {blocks a cluster: clusters at once}


def _fits(device) -> dict:
    """The clusters of each size up to EVAL_CLUSTER that fit on the card
    at once (vpt_gf_evaluate_clusters, queried once a device, before its
    first launch: the query of 16-block clusters also allows them).  The
    launch entry trusts the shape it is given; eval_shape takes only sizes
    that fit."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _FITS:
        query = kernels.helper("circuit_eval", "vpt_gf_evaluate_clusters",
                               [ctypes.c_int, ctypes.c_void_p])
        fits = {}
        for k in (1 << j for j in range(EVAL_CLUSTER.bit_length())):
            n = ctypes.c_int(0)
            with torch.cuda.device(idx):
                err = query(k, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"gf_evaluate: the cluster query failed: "
                                   f"cudaError_t {err}")
            fits[k] = n.value
        if fits[1] < 1:
            raise RuntimeError("gf_evaluate: no block of the kernel fits on "
                               "the card")
        _FITS[idx] = fits
    return _FITS[idx]


def eval_layer_plain(values, x_idx, y_idx, co, x_off: int, out_off: int):
    """One layer of ``evaluate_plain``, in place: for each row of values
    (2, ..., T) and gate g < size = x_idx.numel(), values[..., out_off + g]
    = A*x + B*y + C*(x*y) + D with x = values[..., x_off + x_idx[g]], y =
    values[..., y_idx[g]] and A-D the gate's planes of co (4, 2, size):
    two gathers, gf's plain products and sums in the JAX package's order,
    and a slice copy.  Returns values."""
    add, mul = gf.add_plain, gf.mul_plain
    x = values[..., x_off + x_idx]
    y = values[..., y_idx]
    A, B, C, D = coeffs(co, values.dim() - 2)
    out = add(add(mul(A, x), mul(B, y)), add(mul(C, mul(x, y)), D))
    values[..., out_off:out_off + x_idx.numel()] = out
    return values


def evaluate_plain(inputs, plan: EvalPlan):
    """Plain twin of gf_evaluate: a zero fill, the input copy and the layer
    loop over ``eval_layer_plain``."""
    kernels.PLAIN_CALLS["gf_evaluate"] += 1
    values = torch.zeros(inputs.shape[:-1] + (plan.total,),
                         dtype=torch.int64, device=inputs.device)
    values[..., :inputs.shape[-1]] = inputs
    for g0, size, x_off, out_off, _ in plan.steps[1:].tolist():
        sl = slice(g0, g0 + size)
        eval_layer_plain(values, plan.x_idx[sl].long(),
                         plan.y_idx[sl].long(), plan.co[..., sl], x_off,
                         out_off)
    return values


def evaluate_cuda(inputs, plan: EvalPlan):
    """gf_evaluate on the card: ``eval_launches`` launches (one for
    randomize(14, 13) at any batch up to 64 rows), none for no rows; same
    arguments, result and bits as evaluate_plain."""
    if inputs.dim() < 2 or inputs.shape[0] != 2:
        raise ValueError(f"gf_evaluate: inputs {tuple(inputs.shape)}, "
                         f"(2, ..., n) taken")
    lead, n_in = tuple(inputs.shape[1:-1]), inputs.shape[-1]
    rows = math.prod(lead)
    gates = plan.x_idx.numel()
    kernels.check_cuda("gf_evaluate", (plan.x_idx, plan.y_idx, plan.co),
                       ((gates,), (gates,), (4, 2, gates)),
                       dtypes=(torch.int32, torch.int32, torch.int64))
    if inputs.device != plan.co.device or inputs.dtype != torch.int64:
        raise ValueError("gf_evaluate: int64 inputs on the plan's CUDA "
                         "device taken")
    if n_in > plan.steps[0, PADDED]:
        raise ValueError(f"gf_evaluate: {n_in} inputs, at most "
                         f"{plan.steps[0, PADDED]} taken")
    values = torch.empty((2,) + lead + (plan.total,), dtype=torch.int64,
                         device=inputs.device)
    x = inputs.reshape(2, rows, n_in)
    if rows and n_in and x.stride(-1) != 1:
        x = x.contiguous()
    kernels.check_int("gf_evaluate", rows=rows)
    for first, count, cs, groups, per, split in eval_launches(
            plan.steps, rows, _fits(inputs.device)):
        kernels.launch("gf_evaluate", 1, values.data_ptr(), x.data_ptr(),
                       x.stride(0), x.stride(1), n_in, rows, plan.total,
                       plan.x_idx.data_ptr(), plan.y_idx.data_ptr(),
                       plan.co.data_ptr(), gates,
                       plan.steps[first:].ctypes.data, count, cs, groups,
                       per, split, kernels.stream_ptr())
    return values


def evaluate(cc: CompiledCircuit, inputs, arrs):
    """Forward pass: inputs (2, ..., n) -> the concatenated (2, ...,
    total_values) buffer of every layer's padded block; the middle axes (a
    batch of witnesses) share the circuit.  A CUDA tensor goes to
    ``gf_evaluate`` (one launch a whole evaluation of the paths' circuits),
    a CPU tensor to ``evaluate_plain``; arrs["ev"] is the circuit's plan
    (``eval_arrays``)."""
    fn = evaluate_cuda if gf._on_cuda(inputs) else evaluate_plain
    return fn(inputs, arrs["ev"])
