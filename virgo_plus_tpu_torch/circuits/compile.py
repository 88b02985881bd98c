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
On a CUDA tensor each layer is one launch of ``gf_eval_layer``
(``csrc/circuit_eval.cu``), on a CPU tensor its plain twin.
"""

from __future__ import annotations

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


def eval_arrays(cc: CompiledCircuit, device) -> dict:
    """Gather/coefficient arrays on the device, made once per circuit."""
    arrs = {}
    for i in range(1, cc.depth):
        L = cc.layers[i]
        arrs[f"x{i}"] = index(L.x_idx, device)
        arrs[f"y{i}"] = index(L.y_idx, device)
        arrs[f"co{i}"] = gf.tensor(L.coeff, device)
    return arrs


def coeffs(co, n_lead: int):
    """A layer's (4, 2, size) coefficient planes as A, B, C, D, each shaped
    (2, 1, ..., size) to broadcast over `n_lead` batch axes."""
    return co.reshape((4, 2) + (1,) * n_lead + (-1,))


def eval_layer(values, x_idx, y_idx, co, x_off: int, out_off: int):
    """One layer of ``evaluate``, in place: for each row of values (2, ...,
    T) and gate g < size = x_idx.numel(), values[..., out_off + g] =
    A*x + B*y + C*(x*y) + D with x = values[..., x_off + x_idx[g]], y =
    values[..., y_idx[g]] and A-D the gate's planes of co (4, 2, size).
    Returns values.  A CUDA tensor goes to ``gf_eval_layer`` (one launch),
    a CPU tensor to ``eval_layer_plain``."""
    fn = eval_layer_cuda if gf._on_cuda(values) else eval_layer_plain
    return fn(values, x_idx, y_idx, co, x_off, out_off)


def eval_layer_plain(values, x_idx, y_idx, co, x_off: int, out_off: int):
    """Plain twin of gf_eval_layer: two gathers, gf's plain products and
    sums in the JAX package's order, and a slice copy."""
    kernels.PLAIN_CALLS["gf_eval_layer"] += 1
    add, mul = gf.add_plain, gf.mul_plain
    x = values[..., x_off + x_idx]
    y = values[..., y_idx]
    A, B, C, D = coeffs(co, values.dim() - 2)
    out = add(add(mul(A, x), mul(B, y)), add(mul(C, mul(x, y)), D))
    values[..., out_off:out_off + x_idx.numel()] = out
    return values


def eval_layer_cuda(values, x_idx, y_idx, co, x_off: int, out_off: int):
    """gf_eval_layer on the card, one launch (none for an empty layer):
    same arguments, result and bits as eval_layer_plain."""
    if values.dim() < 2 or values.shape[0] != 2:
        raise ValueError(f"gf_eval_layer: values {tuple(values.shape)}, "
                         f"(2, ..., T) taken")
    size = x_idx.numel()
    total = values.shape[-1]
    rows = values.numel() // (2 * total) if total else 0
    kernels.check_cuda("gf_eval_layer", (values, x_idx, y_idx, co),
                       (tuple(values.shape), (size,), (size,), (4, 2, size)))
    if not (0 <= x_off <= total and 0 <= out_off <= total - size):
        raise ValueError(f"gf_eval_layer: offsets {x_off}, {out_off} and "
                         f"{size} gates outside a row of {total} values")
    if size and rows:
        kernels.check_int("gf_eval_layer", rows=rows, gates=size)
        kernels.launch("gf_eval_layer", 1, values.data_ptr(), rows, total,
                       x_idx.data_ptr(), y_idx.data_ptr(), co.data_ptr(),
                       size, x_off, out_off, kernels.stream_ptr())
    return values


def evaluate(cc: CompiledCircuit, inputs, arrs):
    """Forward pass: inputs (2, ..., n) -> the concatenated (2, ...,
    total_values) buffer, written layer by layer in place (``eval_layer``,
    one kernel launch a layer on the card); the middle axes (a batch of
    witnesses) share the circuit."""
    values = torch.zeros(inputs.shape[:-1] + (cc.total_values,),
                         dtype=torch.int64, device=inputs.device)
    values[..., :inputs.shape[-1]] = inputs
    for i in range(1, cc.depth):
        eval_layer(values, arrs[f"x{i}"], arrs[f"y{i}"], arrs[f"co{i}"],
                   int(cc.value_off[i - 1]), int(cc.value_off[i]))
    return values
