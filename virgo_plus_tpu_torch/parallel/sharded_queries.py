"""Query answers from sharded oracles: no rank ever holds a whole codeword.

Counterpart of ``virgo_plus_tpu/parallel/sharded_queries.py``.  The
single-device prover answers the FRI queries from host copies of whole
codewords and trees (``pc/vpd.answer_queries``).  Here each rank holds only
its shard of every oracle (``ShardedOracle``), so each rank draws the same
positions, writes the value pairs and path digests it owns into buffers of
the answers' fixed shapes (zero elsewhere), and one sum over the sp ranks,
in which every entry has exactly one writer, gives every rank the answers.
They equal ``vpd.answer_queries``'s bit for bit, and the proof size is the
reference's deduplicated count (``vpd.dedup_proof_size``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..circuits.compile import index
from ..field import gf
from ..pc import vpd
from ..pc.virgo_pc import LOG_SLICE, RATE, SLICES
from .mesh import Mesh


@dataclass
class ShardedOracle:
    """Rank q's part of an oracle of n positions a slice, sharded over S
    ranks.

    The codeword is strided: global position p = t·S + q is local position
    t of rank p mod S.  The Merkle tree over its n/2 leaves (leaf j hashes
    the pairs (j, j + n/2), both on one rank) is stored in the port's heap
    layout (``pc/merkle._heap``: root at 1, the 2^k nodes of a level at
    [2^k, 2^(k+1))):

    * ``sub``: the heap of the subtree over the contiguous leaves
      [q·half, (q+1)·half), half = n/2 / S, this rank's own;
    * ``top``: the heap over the S subtree roots, the same on every rank;
    * a tiny tree (half < S) has no ``sub``, and ``top`` is the heap of the
      whole tree, the same on every rank."""
    cw: torch.Tensor                # (2, 65, n / S) local positions
    sub: Optional[torch.Tensor]     # (4, 2·half), or None when tiny
    top: torch.Tensor               # (4, 2·S), or (4, n) when tiny
    n: int
    S: int
    q: int

    @property
    def tiny(self) -> bool:
        return self.sub is None

    @property
    def root(self):
        return self.top[:, 1]


def _vals_owned(o: ShardedOracle, pos: np.ndarray):
    """The value pairs (pos, pos + n/2) of every slice this rank holds,
    (2, 65, 2R), zero where another rank holds the position."""
    both = np.concatenate([pos, pos + o.n // 2])
    own = both % o.S == o.q
    loc = np.where(own, both // o.S, 0)
    v = o.cw[:, :, index(loc, o.cw.device)]
    return torch.where(torch.from_numpy(own).to(o.cw.device), v, 0)


def _paths_owned(o: ShardedOracle, pos: np.ndarray):
    """The path digests of leaves pos (siblings bottom-up, then the leaf)
    that this rank writes, (4, R·(depth + 1)), zero elsewhere.  Nodes of
    the replicated top (or tiny) heap are written by rank 0."""
    n_leaf = o.n // 2
    depth = n_leaf.bit_length() - 1
    d = np.arange(depth + 1)
    # node m at level d of each slot: siblings, then the leaf itself
    m = np.where(d < depth, (pos[:, None] >> np.minimum(d, depth - 1)) ^ 1,
                 pos[:, None])
    d = np.where(d < depth, d, 0)[None, :].repeat(len(pos), 0)
    dev = o.top.device
    out = torch.zeros((4, m.size), dtype=torch.int64, device=dev)
    if o.tiny:
        if o.q == 0:
            out = o.top[:, index(((n_leaf >> d) + m).ravel(), dev)]
        return out
    half = n_leaf // o.S
    sub_depth = half.bit_length() - 1
    in_sub = (d <= sub_depth).ravel()
    owner = (m >> np.maximum(sub_depth - d, 0)).ravel()
    mine = in_sub & (owner == o.q)
    hd = (half >> np.minimum(d, sub_depth)).ravel()
    sub_idx = hd + m.ravel() - owner * hd
    if mine.any():
        sel = torch.from_numpy(mine).to(dev)
        out[:, sel] = o.sub[:, index(sub_idx[mine], dev)]
    if o.q == 0 and not in_sub.all():
        dt = (d.ravel() - sub_depth)[~in_sub]
        sel = torch.from_numpy(~in_sub).to(dev)
        out[:, sel] = o.top[:, index((o.S >> dt) + m.ravel()[~in_sub], dev)]
    return out


def answer_queries_sharded(pows: List[int], bl: int, l_desc: ShardedOracle,
                           h_desc: ShardedOracle,
                           level_descs: List[ShardedOracle], mesh: Mesh):
    """The sharded vpd.answer_queries: every rank returns the same
    (QueryAnswers, deduplicated proof size), one sp collective in all."""
    lg0 = bl + RATE - LOG_SLICE
    pows_np = np.asarray(pows, dtype=np.int64)
    p0s = pows_np // 2
    asks = [(l_desc, p0s), (h_desc, p0s)]
    pw = pows_np.copy()
    for lvl, o in enumerate(level_descs):
        if lvl > 0:
            pw = pw % (1 << (lg0 - lvl))
        asks.append((o, (pw // 2) % (o.n // 2)))
    parts = []
    for o, pos in asks:
        parts += [_vals_owned(o, pos).reshape(-1),
                  _paths_owned(o, pos).reshape(-1)]
    flat = gf.to_numpy(mesh.all_sum(torch.cat(parts)))
    R = len(pows)
    vals, paths, off = [], [], 0
    for o, _pos in asks:
        k = 2 * (SLICES + 1) * 2 * R
        v = flat[off:off + k].reshape(2, -1, 2, R)       # (2, 65, a|b, R)
        vals.append(np.ascontiguousarray(v.transpose(3, 1, 2, 0)))
        off += k
        depth = (o.n // 2).bit_length() - 1
        k = 4 * R * (depth + 1)
        paths.append(np.ascontiguousarray(
            flat[off:off + k].reshape(4, R, depth + 1).transpose(1, 2, 0)))
        off += k
    proof_size = vpd.dedup_proof_size(pows, bl, len(level_descs))
    return vpd.QueryAnswers(
        init_l_vals=vals[0], init_l_paths=paths[0],
        init_h_vals=vals[1], init_h_paths=paths[1],
        lvl_vals=vals[2:], lvl_paths=paths[2:]), proof_size
