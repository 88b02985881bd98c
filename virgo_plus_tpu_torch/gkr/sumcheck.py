"""Sumcheck folds (kernel K1), exact field reductions and gate scatters.

Counterpart of ``virgo_plus_tpu/gkr/sumcheck.py``.  Every fold of every
table size goes through ``scan_sumcheck_batched``: on a CUDA tensor it
launches the hand-written kernel K1 (``csrc/sumcheck_fold.cu``), on a CPU
tensor it runs the plain PyTorch twin ``fold_plain``.  The two compute the
same canonical field elements, so either is bit-identical to the JAX
package's masked-scan, bit-reversed and Pallas folds.

Gate scatters are a sort permutation plus one field segment sum
(``chains.segsum``): an integer ``scatter_add`` or ``cumsum`` would leave
int64 after a few terms.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..field import chains, gf
from .. import kernels
from .beta import beta_table


# ---------------------------------------------------------------------------
# Field reductions
# ---------------------------------------------------------------------------

def tree_sum(x):
    """Field sum along the last axis: (..., N) -> (...), one
    ``chains.segsum`` call (the twin's route: an exact log tree)."""
    return chains.segsum(x)[..., 0]


def prefix_sum(x):
    """Inclusive field prefix sum along the last axis (Hillis-Steele,
    exact): x (2, ..., n), each row of the middle axes on its own.  The
    sharded provers' scatter; the others sum segments with ``segsum``."""
    return chains.prefix_sum(x, gf.add)


# ---------------------------------------------------------------------------
# Exact segment-sum scatter (precompiled)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScatterPlan:
    perm: np.ndarray    # int32 (N,) sort-by-destination permutation
    starts: np.ndarray  # int32 (out_size,) into the 0-prepended prefix array
    ends: np.ndarray    # int32 (out_size,) (starts==ends -> empty -> zero)
    out_size: int

    @staticmethod
    def build(idx: np.ndarray, out_size: int) -> "ScatterPlan":
        idx = np.asarray(idx, dtype=np.int64)
        perm = np.argsort(idx, kind="stable").astype(np.int32)
        counts = np.bincount(idx, minlength=out_size).astype(np.int64)
        ends = np.cumsum(counts)
        starts = ends - counts
        return ScatterPlan(perm=perm, starts=starts.astype(np.int32),
                           ends=ends.astype(np.int32), out_size=out_size)

    def arrays(self, device):
        return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                     for a in (self.perm, self.starts, self.ends))


def apply_scatter_arrays(values, arrs):
    """Segment-sum scatter from (perm, starts, ends) index tensors:
    values (2, ..., N) contributions -> (2, ..., out_size) exact field sums
    along the last axis, one ``chains.segsum`` call."""
    return chains.segsum(values, arrs)


def concat_scatter_plans(plans, in_sizes):
    """Fuse many ScatterPlans into ONE (a single segment-sum pass): each
    plan's permutation and term ranges shift past the earlier plans'."""
    perms, starts, ends = [], [], []
    in_off = 0
    perm_off = 0
    for pl, n_in in zip(plans, in_sizes):
        perms.append(pl.perm.astype(np.int64) + in_off)
        starts.append(pl.starts.astype(np.int64) + perm_off)
        ends.append(pl.ends.astype(np.int64) + perm_off)
        in_off += n_in
        perm_off += len(pl.perm)
    return ScatterPlan(
        perm=np.concatenate(perms).astype(np.int32),
        starts=np.concatenate(starts).astype(np.int32),
        ends=np.concatenate(ends).astype(np.int32),
        out_size=sum(pl.out_size for pl in plans))


# ---------------------------------------------------------------------------
# K1: the batched sumcheck fold, kernel and plain twin
# ---------------------------------------------------------------------------

FOLD_MAX_LOG = 12       # largest table (log2) one block of K1 holds (MAX_LOG)
FOLD_MIN_CHUNK_LOG = 7  # K1 splits no table into chunks smaller than this


def fold_chunk_log(bl: int, k: int, sms: int) -> int:
    """log2 of the entries one block of K1 folds on 2^bl-entry tables, K of
    them, on a card of `sms` SMs: the smallest chunk, down to
    2^FOLD_MIN_CHUNK_LOG entries, that keeps the grid (K * 2^(bl - c)
    blocks, one a SM) within one wave, and at most 2^FOLD_MAX_LOG entries
    of the chunk or of the chunk results' own table."""
    c = min(bl, FOLD_MIN_CHUNK_LOG)
    while c < min(bl, FOLD_MAX_LOG) and k << (bl - c) > sms:
        c += 1
    return max(c, bl - FOLD_MAX_LOG)


def fold_launches(bl: int) -> int:
    """Device launches of one K1 call on 2^bl-entry tables: one, whatever
    bl; none for bl = 0."""
    return 1 if bl else 0


def fold_plain(v, a, m, rs):
    """Plain PyTorch twin of K1.  v, a, m: (2, K, 2^bl); rs: (2, K, bl).
    Returns (polys (bl, K, 2, 3), bound (v, a, m) each (2, K)).  Natural
    pair layout (2i, 2i+1); every round halves the tables.  Its field ops
    are the plain versions, so on the card it launches no kernel of its
    own and stays independent of gf_mul / gf_lin."""
    kernels.PLAIN_CALLS["sumcheck_fold"] += 1
    add, sub, mul = gf.add_plain, gf.sub_plain, gf.mul_plain
    bl = rs.shape[2]
    cv, ca, cm = v, a, m
    polys = []
    for j in range(bl):
        v0, v1 = cv[..., 0::2], cv[..., 1::2]
        a0, a1 = ca[..., 0::2], ca[..., 1::2]
        m0, m1 = cm[..., 0::2], cm[..., 1::2]
        dv = sub(v1, v0)
        da = sub(a1, a0)
        dm = sub(m1, m0)
        pa = mul(dm, dv)
        pb = add(add(mul(dm, v0), mul(m0, dv)), da)
        pc = add(mul(m0, v0), a0)
        polys.append(torch.stack([chains.tree_sum_plain(p)
                                  for p in (pa, pb, pc)], dim=2))  # (2, K, 3)
        r = rs[:, :, j:j + 1]
        cv = add(v0, mul(dv, r))
        ca = add(a0, mul(da, r))
        cm = add(m0, mul(dm, r))
    out = torch.stack(polys, 0).permute(0, 2, 1, 3).contiguous()
    return out, (cv[:, :, 0], ca[:, :, 0], cm[:, :, 0])


def fold_cuda(v, a, m, rs):
    """K1 on the card, one launch: same signature and bits as fold_plain."""
    bl = rs.shape[2]
    k = v.shape[1]
    n = 1 << bl
    kernels.check_cuda("sumcheck_fold", (v, a, m, rs),
                       [(2, k, n)] * 3 + [(2, k, bl)])
    if bl > 2 * FOLD_MAX_LOG:
        raise ValueError(f"sumcheck_fold: tables of 2^{bl} entries exceed "
                         f"2^{2 * FOLD_MAX_LOG}")
    dev = v.device
    c = fold_chunk_log(bl, k, _sm_count(dev))
    chunks = 1 << (bl - c)
    kernels.check_int("sumcheck_fold", blocks=k * chunks)
    polys = torch.empty((bl, k, 2, 3), dtype=torch.int64, device=dev)
    bound = torch.empty((3, 2, k), dtype=torch.int64, device=dev)
    work = work_ptr = tickets = None
    if chunks > 1:
        # partial rows (K, B, c, 6), then chunk results (K, B, 6)
        work = torch.empty((k * chunks * (c + 1) * 6,), dtype=torch.int64,
                           device=dev)
        work_ptr = work.data_ptr()
        tickets = _tickets(dev, k)
    kernels.launch("sumcheck_fold", fold_launches(bl),
                   v.data_ptr(), a.data_ptr(), m.data_ptr(), rs.data_ptr(),
                   polys.data_ptr(), bound.data_ptr(), work_ptr, tickets, k,
                   bl, c, kernels.stream_ptr())
    return polys, (bound[0], bound[1], bound[2])


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_TICKETS = {}   # (device, stream) -> K1's ticket words
_RETIRED = []   # outgrown ticket words: a captured graph may still use them


def _tickets(dev, k: int) -> int:
    """Address of K1's `k` ticket words on the current stream: zeroed once
    here, and left zero by every call, since the last block of each table
    wraps its ticket back to 0.  None is made inside a capture: the eager
    call on the capturing stream before it makes them (graphs.py)."""
    key = (dev, kernels.stream_ptr())
    t = _TICKETS.get(key)
    if t is None or t.numel() < k:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("sumcheck_fold: no ticket words for this "
                               "shape on the capturing stream; an eager "
                               "call on that stream makes them first")
        if t is not None:
            _RETIRED.append(t)
        t = torch.zeros((max(k, 64),), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t.data_ptr()


def scan_sumcheck_batched(v, a, m, rs):
    """K same-size sumchecks at once.  v, a, m: (2, K, 2^bl); rs: (2, K, bl).
    Returns (polys (bl, K, 2, 3), bound (v, a, m) each (2, K)).  CUDA
    tensors go through K1, CPU tensors through the plain twin."""
    bl = rs.shape[2]
    k = v.shape[1]
    assert v.shape[2] == 1 << bl, (v.shape, bl)
    if bl == 0:
        return (torch.zeros((0, k, 2, 3), dtype=torch.int64, device=v.device),
                (v[:, :, 0], a[:, :, 0], m[:, :, 0]))
    if v.device.type == "cuda":
        return fold_cuda(v.contiguous(), a.contiguous(), m.contiguous(),
                         rs.contiguous())
    if v.device.type == "cpu":
        return fold_plain(v, a, m, rs)
    raise ValueError(f"no sumcheck fold for device {v.device}")


def scan_sumcheck(v, a, m, rs):
    """One table: v, a, m (2, 2^bl), rs (2, bl) -> (polys (bl, 2, 3),
    bound scalars (v, a, m) each (2,)).  Round polynomial matches
    prover.cpp:470-487."""
    polys, (vb, ab, mb) = scan_sumcheck_batched(
        v[:, None], a[:, None], m[:, None], rs[:, None])
    return polys[:, 0], (vb[:, 0], ab[:, 0], mb[:, 0])


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def eval_quad(poly, x):
    """poly (2,3) [a,b,c]; x (2,) -> ((a*x)+b)*x + c."""
    from .polynomial import eval_at
    return eval_at(poly, x)


def quad_at_0_plus_1(poly):
    """p(0) + p(1) = a + b + 2c."""
    return gf.add(gf.add(poly[:, 0], poly[:, 1]),
                  gf.add(poly[:, 2], poly[:, 2]))


def mle_fold(values, rs):
    """Fold (2, ..., 2^k) tables along the last axis at the point rs (2, k):
    returns (2, ...).  Matches prover::Vres (prover.cpp:99-129) on
    zero-padded tables.  Computed as the sum of the first 2^k entries
    against the beta table of rs (one table, one product, one sum): field
    arithmetic is exact, so it gives the round-by-round fold's bits."""
    k = rs.shape[1]
    beta = beta_table(rs, k, gf.ones((), values.device))
    return tree_sum(gf.mul(values[..., :1 << k], beta))
