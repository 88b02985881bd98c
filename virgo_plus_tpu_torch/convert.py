"""Carry the JAX package's numpy-level objects into the port, and back.

The port imports nothing of the JAX package, so this module works on
duck-typed objects: anything with the attributes of the JAX package's
``Challenges``, ``CompiledCircuit`` or ``circuit_arrays`` dict, holding
numpy or array-protocol arrays of uint64 field planes.  Tests use it to feed
the exact same challenges, circuit tables and witness to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .circuits.compile import CompiledCircuit, CompiledLayer, eval_arrays
from .driver import _layer_proof_arrays
from .field import gf
from .gkr import protocol


def tensor(x, device="cpu"):
    """Field planes (uint64 bit patterns, any array type) -> int64 tensor."""
    return gf.tensor(np.asarray(x), device)


def to_numpy(t) -> np.ndarray:
    """Port tensor -> numpy uint64 with the same bits."""
    return gf.to_numpy(t)


def challenges(ch, device="cpu") -> protocol.Challenges:
    """A JAX ``Challenges`` -> the port's, on ``device``."""
    T = lambda a: None if a is None else tensor(a, device)
    layers = [None if lc is None else protocol.LayerChallenges(
        r_u=T(lc.r_u), assert_r=T(lc.assert_r), r_v=T(lc.r_v),
        sig=T(lc.sig), r_liu=T(lc.r_liu)) for lc in ch.layers]
    return protocol.Challenges(r_out=T(ch.r_out), layers=layers)


def compiled_circuit(cc) -> CompiledCircuit:
    """A JAX ``CompiledCircuit`` -> the port's (host numpy tables)."""
    n = lambda a: None if a is None else np.asarray(a)
    layers = [CompiledLayer(
        size=L.size, bit_length=L.bit_length, padded=L.padded,
        x_idx=n(L.x_idx), y_idx=n(L.y_idx), coeff=n(L.coeff),
        is_assert=n(L.is_assert), has_assert=L.has_assert,
        dad_sizes=list(L.dad_sizes), dad_bls=list(L.dad_bls),
        dad_offsets=list(L.dad_offsets),
        dad_padded_total=L.dad_padded_total, p2_flat_idx=n(L.p2_flat_idx),
        dad_gather_idx=n(L.dad_gather_idx),
        max_dad_bit_length=L.max_dad_bit_length) for L in cc.layers]
    return CompiledCircuit(
        layers=layers, value_off=np.asarray(cc.value_off),
        total_values=cc.total_values, max_bl=cc.max_bl,
        n_inputs=cc.n_inputs, input_bl=cc.input_bl, source=cc.source)


def circuit_arrays(arrs: dict, cc, device="cpu") -> dict:
    """The JAX ``protocol.circuit_arrays`` dict -> the port's prover tables.
    Bit-reversal permutations (perm*) have no counterpart: the port's fold
    reads natural pairs.  The fused init scatters (initsP, p2P) have none
    either: the port's init stages run over plans that
    ``protocol.init_plans`` makes from the (port) compiled circuit, and
    its evaluation over the plan ``compile.eval_arrays`` makes."""
    idx = lambda a: torch.from_numpy(
        np.asarray(a).astype(np.int64).reshape(-1)).to(device)
    out = {}
    for key, val in arrs.items():
        if key.startswith("perm") or key in ("initsP", "p2P"):
            continue
        if key.startswith("co"):
            out[key] = tensor(val, device)
        elif key.startswith("dgm"):
            out[key] = torch.from_numpy(
                np.asarray(val).reshape(-1).astype(bool)).to(device)
        else:
            out[key] = idx(val)
    for i in range(1, cc.depth):
        if cc.layers[i].has_assert:
            out[f"ia{i}"] = protocol._assert_mask(cc.layers[i], device)
    out.update(eval_arrays(cc, device))
    out.update(protocol.init_plans(cc, protocol.build_plans(cc), device))
    return out


def proof_to_numpy(proof: protocol.Proof) -> dict:
    """A port GKR ``Proof`` -> {"vres": ..., "layers": [None, {...}, ...]}
    of numpy uint64, the layout of ``FullProof``'s GKR fields."""
    return dict(vres=gf.to_numpy(proof.vres),
                layers=[None] + [_layer_proof_arrays(lp)
                                 for lp in proof.layers[1:]])
