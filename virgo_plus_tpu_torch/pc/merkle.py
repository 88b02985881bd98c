"""Merkle trees over SHA3-256 digests (every level one K2 call).

Counterpart of ``virgo_plus_tpu/pc/merkle.py`` (reference
lib/virgo/src/merkle_tree.cpp:7-51): heap layout in a 2N array (root at
index 1, leaves at [N, 2N)), parent = SHA3-256 of the two 32-byte children.
Digests are (4, N) int64 word tensors.
"""

from __future__ import annotations

import torch

from .keccak import sha3_256_x64


def _heap(levels):
    """levels bottom-up [(4, N), (4, N/2), ..., (4, 1)] -> (4, 2N) heap."""
    z = torch.zeros((4, 1), dtype=torch.int64, device=levels[0].device)
    return torch.cat([z] + levels[::-1], dim=1)


def create_tree(leaves):
    """leaves: (4, N) digests, N a power of two -> (4, 2N) heap tree;
    root = tree[:, 1], tree[:, 0] = 0."""
    n = leaves.shape[1]
    assert n & (n - 1) == 0
    levels = [leaves]
    cur = leaves
    while cur.shape[1] > 1:
        cur = sha3_256_x64(torch.cat([cur[:, 0::2], cur[:, 1::2]], dim=0))
        levels.append(cur)
    return _heap(levels)


def create_trees_batched(leaves_list):
    """Build many trees together: every step hashes the current level of
    every still-active tree in ONE K2 call, so a forest costs max-depth
    launches.  Bit-identical to create_tree per tree."""
    levels = [[lv] for lv in leaves_list]
    cur = list(leaves_list)
    while True:
        active = [t for t in range(len(cur)) if cur[t].shape[1] > 1]
        if not active:
            break
        parts = [torch.cat([cur[t][:, 0::2], cur[t][:, 1::2]], dim=0)
                 for t in active]
        h = sha3_256_x64(torch.cat(parts, dim=1))
        off = 0
        for t, p in zip(active, parts):
            cur[t] = h[:, off:off + p.shape[1]]
            levels[t].append(cur[t])
            off += p.shape[1]
    return [_heap(lv) for lv in levels]


def root_of(tree):
    return tree[:, 1]
