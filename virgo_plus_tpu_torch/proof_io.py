"""Proof serialization: a complete standalone Virgo++ proof artifact.

The reference defines (but never uses) a length-prefixed binary proof
container (reference src/GKRProof.hpp:10-186).  This module makes the
proof a real artifact with the same field inventory: the GKR round
polynomials and claims, the PC roots, all_sum, the LDT level roots, the
final codeword, the FFT-GKR message tape, and the FRI query answers
(value pairs + Merkle paths).  Serialized as an .npz (named numpy arrays,
no pickling), so proofs are portable and diffable.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .pc.vpd import QueryAnswers


@dataclass
class FullProof:
    # GKR
    vres: np.ndarray                       # (2,)
    layers: list                           # per layer dict of arrays or None
    # PC
    root_l: np.ndarray                     # (4,) digest words
    root_h: np.ndarray                     # (4,)
    all_sum: np.ndarray                    # (2, 65)
    level_roots: np.ndarray                # (L, 4)
    final_codeword: np.ndarray             # (2, 65, 2^RATE)
    fft_gkr_messages: list                 # numpy arrays
    queries: Optional[QueryAnswers]
    meta: dict


def _pack_queries(qa: QueryAnswers):
    """Query answers are already uniform arrays (pc/vpd.py QueryAnswers):
    vals (reps, 65, 2, 2) u64, paths (reps, depth+1, 4)."""
    out = {
        "init_l_vals": np.asarray(qa.init_l_vals),
        "init_l_paths": np.asarray(qa.init_l_paths),
        "init_h_vals": np.asarray(qa.init_h_vals),
        "init_h_paths": np.asarray(qa.init_h_paths),
    }
    for lvl, (v, p) in enumerate(zip(qa.lvl_vals, qa.lvl_paths)):
        out[f"lvl{lvl}_vals"] = np.asarray(v)
        out[f"lvl{lvl}_paths"] = np.asarray(p)
    out["n_levels"] = np.array([len(qa.lvl_vals)])
    return out


def _unpack_queries(d) -> QueryAnswers:
    n_levels = int(d["n_levels"][0])
    return QueryAnswers(
        init_l_vals=d["init_l_vals"], init_l_paths=d["init_l_paths"],
        init_h_vals=d["init_h_vals"], init_h_paths=d["init_h_paths"],
        lvl_vals=[d[f"lvl{lvl}_vals"] for lvl in range(n_levels)],
        lvl_paths=[d[f"lvl{lvl}_paths"] for lvl in range(n_levels)])


def save(path_or_buf, proof: FullProof):
    arrays = {
        "vres": np.asarray(proof.vres),
        "root_l": np.asarray(proof.root_l),
        "root_h": np.asarray(proof.root_h),
        "all_sum": np.asarray(proof.all_sum),
        "level_roots": np.asarray(proof.level_roots),
        "final_codeword": np.asarray(proof.final_codeword),
        "n_fft_msgs": np.array([len(proof.fft_gkr_messages)]),
        "depth": np.array([len(proof.layers)]),
    }
    for k, m in enumerate(proof.fft_gkr_messages):
        arrays[f"fftmsg{k}"] = np.asarray(m)
    for i, lp in enumerate(proof.layers):
        if lp is None:
            continue
        for key, v in lp.items():
            if v is not None:
                arrays[f"L{i}_{key}"] = np.asarray(v)
    if proof.queries is not None:
        arrays.update(_pack_queries(proof.queries))
    for k, v in proof.meta.items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path_or_buf, **arrays)


def load(path_or_buf) -> FullProof:
    d = dict(np.load(path_or_buf))
    depth = int(d["depth"][0])
    layers = [None] * depth
    for i in range(1, depth):
        lp = {}
        for key in ("p1_polys", "claim_u", "p2_polys", "claims_v",
                    "liu_polys", "liu_claim"):
            lp[key] = d.get(f"L{i}_{key}")
        layers[i] = lp
    msgs = [d[f"fftmsg{k}"] for k in range(int(d["n_fft_msgs"][0]))]
    queries = _unpack_queries(d) if "init_l_vals" in d else None
    meta = {k[5:]: d[k] for k in d if k.startswith("meta_")}
    return FullProof(
        vres=d["vres"], layers=layers, root_l=d["root_l"],
        root_h=d["root_h"], all_sum=d["all_sum"],
        level_roots=d["level_roots"], final_codeword=d["final_codeword"],
        fft_gkr_messages=msgs, queries=queries, meta=meta)
