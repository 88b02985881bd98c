"""Merkle trees over SHA3-256 digests (K2's forest kernel).

Counterpart of ``virgo_plus_tpu/pc/merkle.py`` (reference
lib/virgo/src/merkle_tree.cpp:7-51): heap layout in a 2N array (root at
index 1, leaves at [N, 2N)), parent = SHA3-256 of the two 32-byte children.
Digests are (4, N) int64 word tensors.  ``forest`` builds every level of
every tree of a forest: CUDA tensors in one launch of the forest kernel
(``csrc/keccak.cu``), CPU tensors through the plain twin, one SHA3 call
per level over every tree still active.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .keccak import on_cuda, sha3_256_x64_plain

# a block of the forest kernel builds 2^7-leaf subtrees: its 64 lane pairs
# hash a subtree's first level in one pass
FOREST_SUB_LOG = 7


def _heap(levels):
    """levels bottom-up [(4, N), (4, N/2), ..., (4, 1)] -> (4, 2N) heap."""
    z = torch.zeros((4, 1), dtype=torch.int64, device=levels[0].device)
    return torch.cat([z] + levels[::-1], dim=1)


def _split(leaves, sizes):
    out, off = [], 0
    for n in sizes:
        out.append(leaves[:, off:off + n])
        off += n
    return out


def forest_plain(leaves, sizes):
    """Plain twin of the forest kernel.  leaves: (4, sum(sizes)) leaf
    digests of the trees side by side, each size a power of two ->
    [(4, 2N)] heaps.  Every step hashes the current level of every
    still-active tree in one sha3_256_x64_plain call."""
    kernels.PLAIN_CALLS["merkle_forest"] += 1
    cur = _split(leaves, sizes)
    levels = [[lv] for lv in cur]
    while True:
        active = [t for t in range(len(cur)) if cur[t].shape[1] > 1]
        if not active:
            break
        parts = [torch.cat([cur[t][:, 0::2], cur[t][:, 1::2]], dim=0)
                 for t in active]
        h = sha3_256_x64_plain(torch.cat(parts, dim=1))
        off = 0
        for t, p in zip(active, parts):
            cur[t] = h[:, off:off + p.shape[1]]
            levels[t].append(cur[t])
            off += p.shape[1]
    return [_heap(lv) for lv in levels]


_TABLES = {}   # (device, stream, tree sizes) -> the forest kernel's tree table


def _tree_table(dev, sizes):
    """The forest kernel's (trees, 5) table for these tree sizes on the
    current stream: leaf offset, log2 leaves, heap offset, first block and
    ticket of each tree, and the grid's block count.  The table holds no
    address and the kernel leaves its tickets at zero, so it is made once
    and stays resident: a captured graph replays it (graphs.py), and no
    host copy runs inside a capture."""
    key = (dev, kernels.stream_ptr(), tuple(sizes))
    if key not in _TABLES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"merkle_forest: no tree table for sizes "
                               f"{list(sizes)} on the capturing stream; an "
                               f"eager call on that stream makes it first")
        rows, off, blocks = [], 0, 0
        for n in sizes:
            lg = n.bit_length() - 1
            rows.append([off, lg, 8 * off, blocks, 0])
            off += n
            blocks += n >> min(lg, FOREST_SUB_LOG)
        kernels.check_int("merkle_forest", trees=len(sizes), blocks=blocks)
        _TABLES[key] = (torch.tensor(rows, dtype=torch.int64).to(dev), blocks)
    return _TABLES[key]


def forest_cuda(leaves, sizes):
    """The forest kernel on the card, one launch: same arguments and bits
    as forest_plain.  A block builds a subtree of up to 2^FOREST_SUB_LOG
    leaves; the last block of a tree to finish builds the levels above.
    The heaps are views of one buffer, heap t at 8 * (the leaves before
    tree t) words."""
    total = leaves.shape[1]
    kernels.check_cuda("merkle_forest", (leaves,), [(4, total)])
    if sum(sizes) != total or any(n < 1 or n & (n - 1) for n in sizes):
        raise ValueError(f"merkle_forest: tree sizes {sizes} are not powers "
                         f"of two summing to {total}")
    dev = leaves.device
    flat = torch.empty((8 * total,), dtype=torch.int64, device=dev)
    heaps, off = [], 0
    for n in sizes:
        heaps.append(flat[8 * off:8 * (off + n)].view(4, 2 * n))
        off += n
    if total:
        trees, blocks = _tree_table(dev, sizes)
        kernels.launch("merkle_forest", 1, leaves.data_ptr(), total,
                       trees.data_ptr(), flat.data_ptr(), len(sizes), blocks,
                       FOREST_SUB_LOG, kernels.stream_ptr())
    return heaps


def forest(leaves, sizes):
    """Merkle trees of many leaf sets at once: leaves (4, sum(sizes)) side
    by side -> [(4, 2N)] heaps; root = tree[:, 1], tree[:, 0] = 0."""
    if on_cuda(leaves, "Merkle forest kernel"):
        return forest_cuda(leaves.contiguous(), sizes)
    return forest_plain(leaves, sizes)


def create_tree(leaves):
    """leaves: (4, N) digests, N a power of two -> (4, 2N) heap tree;
    root = tree[:, 1], tree[:, 0] = 0."""
    return forest(leaves, [leaves.shape[1]])[0]


def root_of(tree):
    return tree[:, 1]


def merkle_path(tree, pos: int):
    """Sibling digests from leaf `pos` (heap index N + pos) up to below the
    root: a host-side helper for proof serialisation.  tree: (4, 2N) host
    numpy (or a tensor); returns (4, depth) of the same kind."""
    n = tree.shape[1] // 2
    idx = []
    p = n + pos
    while p > 1:
        idx.append(p ^ 1)
        p //= 2
    return tree[:, np.array(idx, dtype=np.int64)]
