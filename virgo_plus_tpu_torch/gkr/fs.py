"""Fiat-Shamir (non-interactive) mode: device sponge, prover and verifier.

Counterpart of ``virgo_plus_tpu/gkr/fs.py``.  The reference ships only the
interactive protocol driven by srand(3396) randomness; this mode draws every
challenge from a SHA3 sponge instead, so a proof can be handed to a third
party.  The prover keeps the sponge on the device, in two hand-written
kernels of ``csrc/fs_rounds.cu`` (the JAX package's scans): ``fs_sponge``
absorbs a stream of elements and squeezes a stream of challenges in one
launch, and ``fs_sumcheck`` runs every round of one FS sumcheck (its round
polynomials, absorbs, squeezes and binds; one table, or every table of the
joint phase 2) in one launch.  CPU tensors take their plain twins
(``fs_sponge_plain``, ``fs_sumcheck_plain``), which hash with K2's plain
twin.  Nothing in the GKR walk or the PC half goes back to the host until
query drawing.

Sponge spec (the JAX package's; the reference defines none):
  state D: 32 bytes as (4,) u64 words (int64 bit patterns here),
           initialized from the domain tag.
  absorb(e0, e1): D <- SHA3-256(e0.real||e0.img||e1.real||e1.img||D);
                  element streams are absorbed pairwise, zero-padded.
  squeeze():      H = SHA3-256(D || 0x01 pad block); D <- SHA3-256(D || 0x02)
                  challenge = (H[0] mod p, H[1] mod p), unsigned.

Each sumcheck round absorbs its round polynomial before its challenge is
squeezed (batch FS would be unsound for sumcheck).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import weakref
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from .. import graphs, kernels
from ..field import chains, gf
from ..pc import fft_gkr, virgo_pc
from ..pc.keccak import on_cuda, sha3_256_x64_plain
from . import protocol
from .beta import beta_table
from .sumcheck import apply_scatter_arrays, concat_scatter_plans, mle_fold, \
    tree_sum

DOMAIN_TAG = b"virgo_plus_tpu.fs.v1\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00"

# csrc/fs_rounds.cu: fs_sumcheck's block (THREADS), its most blocks a
# cluster (MAX_CLUSTER) and tables a call (MAX_TABLES), and a block's shared
# memory (SMEM_MAX bytes)
SUMCHECK_THREADS = 256
SUMCHECK_CLUSTER = 16
SUMCHECK_TABLES = 128
SUMCHECK_SMEM = 232448


# ---------------------------------------------------------------------------
# Device sponge
# ---------------------------------------------------------------------------

def init_state(device):
    """The domain-tag state on `device`.  It is a host-to-device copy, which
    a capture refuses: the FS makers make it once, outside any capture, as
    ``fs_arrays``' "D0"."""
    h = hashlib.sha3_256(DOMAIN_TAG).digest()
    return torch.from_numpy(np.frombuffer(h, dtype=np.int64).copy()).to(device)


def _sha3_one(words8):
    """words8: (8,) words -> (4,) digest words (one SHA3-256 block, K2's
    plain twin)."""
    return sha3_256_x64_plain(words8[:, None])[:, 0]


def _pad_block(D, tag: int):
    """D || tag || 0 as 8 words, from a copy and a fill."""
    blk = torch.zeros(8, dtype=torch.int64, device=D.device)
    blk[:4] = D
    blk[4].fill_(tag)
    return blk


def _absorb_plain(D, elems):
    """elems: (2, k) or None — absorbed pairwise in order, zero-padded."""
    k = 0 if elems is None else elems.shape[1]
    if k % 2:
        elems = torch.cat([elems, torch.zeros_like(elems[:, :1])], dim=1)
    if k:
        blocks = elems.t().reshape(-1, 4)   # pair p: e_2p.re/im, e_2p+1.re/im
        for p in range(blocks.shape[0]):
            D = _sha3_one(torch.cat([blocks[p], D]))
    return D


def _squeeze_plain(D):
    """-> ((2,) challenge element, new state).  The digest words are u64:
    reduce_lazy's Mersenne fold with a logical shift is the unsigned
    ``h mod p`` (int64 ``%`` would be signed)."""
    h = _sha3_one(_pad_block(D, 1))
    d2 = _sha3_one(_pad_block(D, 2))
    return gf.reduce_lazy_plain(h[:2]), d2


def _empty(dev):
    return torch.zeros((2, 0), dtype=torch.int64, device=dev)


def fs_sponge_plain(D, elems, n: int):
    """Plain twin of fs_sponge: absorb elems (2, k) (or None) pairwise,
    zero-padded, then squeeze n challenges -> ((2, n), D')."""
    kernels.PLAIN_CALLS["fs_sponge"] += 1
    D = _absorb_plain(D, elems)
    out = []
    for _ in range(n):
        el, D = _squeeze_plain(D)
        out.append(el)
    return (torch.stack(out, dim=1) if out else _empty(D.device)), D


def fs_sponge_cuda(D, elems, n: int):
    """fs_sponge on the card, one launch (none when k = n = 0): same
    signature and bits as fs_sponge_plain.  elems may have any strides."""
    k = 0 if elems is None else elems.shape[1]
    kernels.check_cuda("fs_sponge", (D,), [(4,)])
    if k:
        if elems.device != D.device or elems.dtype != torch.int64 \
                or elems.dim() != 2 or elems.shape[0] != 2:
            raise ValueError(f"fs_sponge: elements {tuple(elems.shape)} "
                             f"{elems.dtype} on {elems.device}, expected "
                             f"(2, k) int64 on {D.device}")
    kernels.check_int("fs_sponge", elements=k, challenges=n)
    if k == 0 and n == 0:
        return _empty(D.device), D
    out = torch.empty(2 * n + 4, dtype=torch.int64, device=D.device)
    kernels.launch("fs_sponge", 1, D.data_ptr(),
                   elems.data_ptr() if k else None,
                   elems.stride(0) if k else 0, elems.stride(1) if k else 0,
                   k, n, out.data_ptr(), kernels.stream_ptr())
    return out[:2 * n].view(2, n), out[2 * n:]


def fs_sponge(D, elems, n: int):
    """Absorb elems (2, k) (or None) pairwise, zero-padded, then squeeze n
    challenges: ((2, n) challenges, D').  A CUDA state runs fs_sponge (one
    launch), a CPU state its plain twin."""
    if on_cuda(D, "FS sponge kernel"):
        return fs_sponge_cuda(D.contiguous(), elems, n)
    return fs_sponge_plain(D, elems, n)


def absorb_pair(D, e0, e1):
    return fs_sponge(D, torch.stack([e0, e1], dim=1), 0)[1]


def absorb_digest(D, words4):
    """Absorb a (4,) digest as the elements (w0, w1), (w2, w3) (a view)."""
    return fs_sponge(D, words4.view(2, 2).t(), 0)[1]


def absorb_elems(D, elems):
    """elems: (2, k) — absorbed pairwise in order, zero-padded."""
    return fs_sponge(D, elems, 0)[1]


def squeeze(D):
    """-> ((2,) challenge element, new state)."""
    ch, D = fs_sponge(D, None, 1)
    return ch[:, 0], D


def squeeze_vec(D, n: int):
    """n chained squeezes -> ((2, n) challenges, new state)."""
    return fs_sponge(D, None, n)


def absorb_squeeze(D, elems, n: int):
    """absorb_elems then squeeze_vec, in one fs_sponge call."""
    return fs_sponge(D, elems, n)


# ---------------------------------------------------------------------------
# Sumcheck rounds with sponge challenges
# ---------------------------------------------------------------------------

# the rounds' field ops: the dispatching ones (a kernel a call on the card:
# the sharded provers' rank-split rounds) and the plain ones (the twins)
_OPS = (gf.mul, gf.add, gf.sub, gf.neg, tree_sum)
_PLAIN_OPS = (gf.mul_plain, gf.add_plain, gf.sub_plain, gf.neg_plain,
              chains.tree_sum_plain)


def _round(T, ops=_OPS):
    """One sumcheck round over stacked tables T (2, 3, ..., 2h), axis 1 =
    (v, a, m): the round polynomial of m·v + a summed over every table and
    pair -> ((2, 3) poly, low halves (2, 3, ..., h), differences)."""
    mul, add, sub, _neg, tsum = ops
    T0, T1 = T[..., 0::2], T[..., 1::2]
    d = sub(T1, T0)
    v0, a0, m0 = T0[:, 0], T0[:, 1], T0[:, 2]
    dv, da, dm = d[:, 0], d[:, 1], d[:, 2]
    prods = mul(torch.stack([dm, dm, m0, m0], 1),
                torch.stack([dv, v0, dv, v0], 1))
    pa = prods[:, 0]
    pb = add(add(prods[:, 1], prods[:, 2]), da)
    pc = add(prods[:, 3], a0)
    poly = tsum(torch.stack([pa, pb, pc], 1).reshape(2, 3, -1))
    return poly, T0, d


def _bind(T0, d, r, ops=_OPS):
    """Fix the round's variable at r: T0 + r·(T1 - T0)."""
    mul, add = ops[:2]
    return add(T0, mul(d, r.reshape((2,) + (1,) * (d.dim() - 1))))


def fs_scan_sumcheck_plain(v, a, m, bl: int, D):
    """Plain twin of fs_sumcheck for one table of bl rounds: the sumcheck
    of m·v + a with a per-round absorb + squeeze.  v, a, m: (2, 2^bl).
    Returns (polys (bl, 2, 3), rs (2, bl), bound scalars (2, 3) (v, a, m),
    D').  Each round halves the tables; the JAX version masks a full-size
    table instead, with the same sums."""
    assert v.shape[1] == 1 << bl, (v.shape, bl)
    T = torch.stack([v, a, m], dim=1)
    polys, rs = [], []
    for _ in range(bl):
        poly, T0, d = _round(T, _PLAIN_OPS)
        # absorb the round polynomial (two pairs), then squeeze its r
        r, D = _squeeze_plain(_absorb_plain(D, poly))
        T = _bind(T0, d, r, _PLAIN_OPS)
        polys.append(poly)
        rs.append(r)
    dev = v.device
    polys = (torch.stack(polys) if polys
             else torch.zeros((0, 2, 3), dtype=torch.int64, device=dev))
    rs = torch.stack(rs, dim=1) if rs else _empty(dev)
    return polys, rs, T[:, :, 0], D


def _phase2_plain(groups, mdb: int, D):
    """Plain twin of fs_sumcheck for the joint phase-2 sumcheck of one
    layer: every dad table shares each round's challenge.  groups: {bl:
    (keys, T (2, 3, K, 2^bl))}, the layer's tables stacked per bit length.
    A table exhausted at round j == bl adds v·m + a to the a_term chain,
    which contributes (0, -a_term, a_term) to every later poly.  Returns
    (polys (mdb, 2, 3), r_v (2, mdb), {key: bound (v, a, m) (2, 3)}, D')."""
    mul, add, sub, neg, tsum = _PLAIN_OPS
    dev = D.device
    zero = gf.zeros((), dev)
    one = gf.ones((), dev)
    a_term = zero
    polys, rs, bounds = [], [], {}
    for j in range(mdb):
        if j > 0:
            a_term = mul(a_term, sub(one, rs[-1]))
        pj = gf.zeros((3,), dev)
        live = {}
        for bl, (keys, T) in groups.items():
            if j < bl:
                poly, T0, d = _round(T, _PLAIN_OPS)
                pj = add(pj, poly)
                live[bl] = (T0, d)
            elif j == bl:
                v, a, m = T[:, 0, :, 0], T[:, 1, :, 0], T[:, 2, :, 0]
                a_term = add(a_term, tsum(add(mul(v, m), a)))
                bounds.update((key, T[:, :, k, 0]) for k, key in
                              enumerate(keys))
        pj = add(pj, torch.stack([zero, neg(a_term), a_term], 1))
        r, D = _squeeze_plain(_absorb_plain(D, pj))
        for bl, (T0, d) in live.items():
            groups[bl] = (groups[bl][0], _bind(T0, d, r, _PLAIN_OPS))
        polys.append(pj)
        rs.append(r)
    for bl, (keys, T) in groups.items():
        if bl == mdb:
            bounds.update((key, T[:, :, k, 0]) for k, key in enumerate(keys))
    polys = (torch.stack(polys) if polys
             else torch.zeros((0, 2, 3), dtype=torch.int64, device=dev))
    r_v = torch.stack(rs, dim=1) if rs else _empty(dev)
    return polys, r_v, bounds, D


def fs_sumcheck_plain(tables, mdb: int, D, absorb: bool = False):
    """Plain twin of fs_sumcheck: one table of mdb rounds is
    fs_scan_sumcheck_plain, any other set the joint phase 2
    (_phase2_plain); absorb: then absorb table 0's bound v."""
    kernels.PLAIN_CALLS["fs_sumcheck"] += 1
    tabs = [(v, torch.zeros_like(m) if a is None else a, m, bl)
            for v, a, m, bl in tables]
    if len(tabs) == 1 and tabs[0][3] == mdb:
        polys, rs, bound, D = fs_scan_sumcheck_plain(*tabs[0][:3], mdb, D)
        bounds = bound[None]
    else:
        groups = {}
        for k, (v, a, m, bl) in enumerate(tabs):
            keys, ts = groups.setdefault(bl, ([], []))
            keys.append(k)
            ts.append(torch.stack([v, a, m], dim=1))
        polys, rs, got, D = _phase2_plain(
            {bl: (keys, torch.stack(ts, 2)) for bl, (keys, ts)
             in groups.items()}, mdb, D)
        bounds = torch.stack([got[k] for k in range(len(tabs))])
    if absorb:
        D = _absorb_plain(D, bounds[0, :, :1])
    return polys, rs, bounds, D


def sumcheck_cluster(tables) -> int:
    """fs_sumcheck's blocks a cluster: the first round's pairs over the
    block's threads, as a power of two from 1 to SUMCHECK_CLUSTER."""
    pairs = sum((1 << bl) // 2 for *_, bl in tables)
    c = 1
    while c < SUMCHECK_CLUSTER and 2 * c * SUMCHECK_THREADS <= pairs:
        c *= 2
    return c


class SumcheckPlan(NamedTuple):
    """fs_sumcheck's plan of one call, as the C entry makes it: rounds 0 ..
    J - 2 on the whole cluster, the rest in block 0; a block's store words
    (the global route's scratch a block); a block's shared memory bytes on
    the shared-memory route (the store in it) and on the global route."""
    J: int
    store_words: int
    smem: int
    smem_global: int


@functools.lru_cache(maxsize=None)
def sumcheck_plan(bls: tuple, mdb: int, cluster: int) -> SumcheckPlan:
    """fs_sumcheck's plan for tables of bit lengths `bls`, mdb rounds and a
    cluster of `cluster` blocks: the C entry's own (vpt_fs_sumcheck_plan,
    a query that launches nothing), so the scratch the wrapper sizes is
    the one the kernel writes."""
    query = kernels.helper("fs_rounds", "vpt_fs_sumcheck_plan",
                           [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_longlong * (6 + len(bls)))()
    if query((ctypes.c_int * len(bls))(*bls), len(bls), mdb, cluster, out):
        raise ValueError(f"fs_sumcheck: no plan takes bit lengths {bls}, "
                         f"{mdb} rounds on {cluster} blocks")
    return SumcheckPlan(out[0], out[2], out[4], out[5])


def sumcheck_route(bls, mdb: int, cluster: int):
    """(plan, route): "smem" where a block's store fits its shared memory,
    else "global" (the stores in one scratch buffer).  A route by shape:
    the kernel takes either; ValueError where neither fits a block."""
    plan = sumcheck_plan(tuple(bls), mdb, cluster)
    if plan.smem <= SUMCHECK_SMEM:
        return plan, "smem"
    if plan.smem_global <= SUMCHECK_SMEM:
        return plan, "global"
    raise ValueError(f"fs_sumcheck: bit lengths {tuple(bls)}, {mdb} rounds "
                     f"on {cluster} blocks need {plan.smem_global} bytes of "
                     f"shared memory a block, past {SUMCHECK_SMEM}")


def _bases(tables):
    """The tables' v, a, m as three base tensors, each table at one offset
    from all three, and the plane strides: the tables' own storage where
    they allow it (every phase-2 table a slice of the same vdad, addV and
    multV), else packed copies."""
    v0, a0, m0, _ = tables[0]
    arrs = [(v, a, m) for v, a, m, _ in tables]

    def off(x, base):
        return (x.data_ptr() - base.data_ptr()) // 8

    def fits():
        for k in range(3):
            base = tables[0][k]
            if base is None:
                continue
            for t in arrs:
                x = t[k]
                if (x.stride(0) != base.stride(0) or
                        (x.shape[1] > 1 and x.stride(1) != 1) or
                        off(x, base) != off(t[0], v0)):
                    return False
        return True

    if fits():
        return (v0, a0, m0), [off(t[0], v0) for t in arrs]
    packed = tuple(None if tables[0][k] is None else
                   torch.cat([t[k] for t in arrs], dim=1) for k in range(3))
    offs, o = [], 0
    for *_, bl in tables:
        offs.append(o)
        o += 1 << bl
    return packed, offs


def fs_sumcheck_cuda(tables, mdb: int, D, absorb: bool = False):
    """fs_sumcheck on the card, one launch: same signature and bits as
    fs_sumcheck_plain."""
    n = len(tables)
    kernels.check_cuda("fs_sumcheck", (D,), [(4,)])
    if not 1 <= n <= SUMCHECK_TABLES:
        raise ValueError(f"fs_sumcheck: {n} tables, 1 to {SUMCHECK_TABLES} "
                         f"taken")
    if not 0 <= mdb <= 62:
        raise ValueError(f"fs_sumcheck: {mdb} rounds")
    has_a = tables[0][1] is not None
    for v, a, m, bl in tables:
        if (a is not None) != has_a or not 0 <= bl <= mdb:
            raise ValueError("fs_sumcheck: every table or none takes a, and "
                             "every bl is at most the rounds")
        for x in (v, a, m) if has_a else (v, m):
            if x.device != D.device or x.dtype != torch.int64 \
                    or tuple(x.shape) != (2, 1 << bl):
                raise ValueError(f"fs_sumcheck: a table {tuple(x.shape)} "
                                 f"{x.dtype} on {x.device}, expected "
                                 f"(2, {1 << bl}) int64 on {D.device}")
    (v, a, m), offs = _bases(tables)
    cluster = sumcheck_cluster(tables)
    plan, route = sumcheck_route([bl for *_, bl in tables], mdb, cluster)
    words = cluster * plan.store_words if route == "global" else 0
    scratch = torch.empty(words, dtype=torch.int64, device=D.device)
    out = torch.empty(8 * mdb + 6 * n + 4, dtype=torch.int64, device=D.device)
    kernels.launch(
        "fs_sumcheck", 1, v.data_ptr(), a.data_ptr() if has_a else None,
        m.data_ptr(), v.stride(0), a.stride(0) if has_a else 0, m.stride(0),
        (ctypes.c_longlong * n)(*offs),
        (ctypes.c_int * n)(*(bl for *_, bl in tables)), n, mdb, D.data_ptr(),
        int(absorb), out.data_ptr(), scratch.data_ptr() if words else None,
        cluster, kernels.stream_ptr())
    return (out[:6 * mdb].view(mdb, 2, 3), out[6 * mdb:8 * mdb].view(2, mdb),
            out[8 * mdb:8 * mdb + 6 * n].view(n, 2, 3), out[8 * mdb + 6 * n:])


def fs_sumcheck(tables, mdb: int, D, absorb: bool = False):
    """Every round of one FS sumcheck of m·v + a over `tables` [(v, a or
    None (zeros), m, bl)], each (2, 2^bl), sharing each round's challenge
    for mdb rounds (a table of bl < mdb is exhausted at round bl: its v·m
    + a joins the a_term chain of the joint phase 2).  absorb: then absorb
    table 0's bound v (the claim).  Returns (polys (mdb, 2, 3), rs (2,
    mdb), bound scalars (n, 2, 3) as (v, a, m) a table, D').  A CUDA state
    runs fs_sumcheck (one launch), a CPU state its plain twin."""
    if on_cuda(D, "FS sumcheck kernel"):
        return fs_sumcheck_cuda(tables, mdb, D.contiguous(), absorb)
    return fs_sumcheck_plain(tables, mdb, D, absorb)


def fs_scan_sumcheck(v, a, m, bl: int, D):
    """Sumcheck of m·v + a with a per-round absorb + squeeze.  v, a, m:
    (2, 2^bl).  Returns (polys (bl, 2, 3), rs (2, bl), bound scalars
    (v, a, m) each (2,), D'): fs_sumcheck of one table."""
    assert v.shape[1] == 1 << bl, (v.shape, bl)
    polys, rs, bounds, D = fs_sumcheck([(v, a, m, bl)], bl, D)
    return polys, rs, (bounds[0, :, 0], bounds[0, :, 1], bounds[0, :, 2]), D


# ---------------------------------------------------------------------------
# GKR prover
# ---------------------------------------------------------------------------

def fs_arrays(cc, plans, device) -> dict:
    """Per-layer scatter plans of the FS walk, made once per circuit on the
    device: p1P{i} and p2P{i} scatter the add and the mult contributions
    of layer i in one pass (the plan twice, side by side); liuP{i} is the
    Liu plan; D0 is the sponge's initial state.  The gather and
    coefficient tables are the glibc prover's (protocol.circuit_arrays)."""
    arrs = {"D0": init_state(device)}
    for i in range(1, cc.depth):
        L = cc.layers[i]
        P = plans[i]
        arrs[f"p1P{i}"] = concat_scatter_plans(
            [P.p1, P.p1], [L.size, L.size]).arrays(device)
        if P.p2 is not None:
            arrs[f"p2P{i}"] = concat_scatter_plans(
                [P.p2, P.p2], [L.size, L.size]).arrays(device)
        if P.liu_plan is not None:
            arrs[f"liuP{i}"] = P.liu_plan.arrays(device)
    return arrs


def _fs_layer(cc, plans, i, values, r_cur, D, rvs, arrs, fsa):
    """One layer of the FS walk (phase 1, joint phase 2, Liu) with every
    challenge squeezed from the sponge.  rvs: {j: r_v} of the consumer
    layers j > i, walked already.  Returns (LayerProof, LayerChallenges,
    new sponge state)."""
    L = cc.layers[i]
    P = plans[i]
    bl_prev = cc.layers[i - 1].bit_length
    pre_padded = cc.layers[i - 1].padded
    dev = values.device
    one = gf.ones((), dev)

    assert_r, D = squeeze(D)
    bg = protocol._scale_beta_asserts(
        cc, i, beta_table(r_cur, L.bit_length, one), assert_r,
        arrs.get(f"ia{i}"))[:, :L.size]
    y = values[:, arrs[f"y{i}"]]
    A, B, C, Dc = arrs[f"co{i}"]
    add_c = gf.mul(bg, gf.add(gf.mul(B, y), Dc))
    mult_c = gf.mul(bg, gf.add(A, gf.mul(C, y)))
    s = apply_scatter_arrays(torch.cat([add_c, mult_c], 1), fsa[f"p1P{i}"])
    tmp_v = protocol._values_block(cc, values, i - 1)
    # phase 1, then absorb claim_u: one fs_sumcheck
    p1_polys, r_u, bounds, D = fs_sumcheck(
        [(tmp_v, s[:, :pre_padded], s[:, pre_padded:], bl_prev)], bl_prev, D,
        absorb=True)
    claim_u = bounds[0, :, 0]

    p2_polys = claims_v = r_v = None
    if L.max_dad_bit_length >= 0:
        beta_u = beta_table(r_u, bl_prev, one)
        tmp_g = gf.mul(bg, beta_u[:, arrs[f"x{i}"]])
        cu = claim_u[:, None]
        addv_c = gf.mul(tmp_g, gf.add(gf.mul(A, cu), Dc))
        multv_c = gf.mul(tmp_g, gf.add(B, gf.mul(C, cu)))
        s = apply_scatter_arrays(torch.cat([addv_c, multv_c], 1),
                                 fsa[f"p2P{i}"])
        tot = L.dad_padded_total
        vdad = torch.where(arrs[f"dgm{i}"][None, :],
                           values[:, arrs[f"dg{i}"]], 0)
        addV, multV = s[:, :tot], s[:, tot:]
        # the joint phase 2 over every dad table (slices of vdad, addV and
        # multV), one fs_sumcheck
        tables, slot = [], {}
        for li in range(i):
            if L.dad_sizes[li] == 0:
                continue
            bl_l = L.dad_bls[li]
            sl = slice(L.dad_offsets[li], L.dad_offsets[li] + (1 << bl_l))
            slot[li] = len(tables)
            tables.append((vdad[:, sl], addV[:, sl], multV[:, sl], bl_l))
        p2_polys, r_v, bounds, D = fs_sumcheck(tables, L.max_dad_bit_length,
                                               D)
        zero = None if len(slot) == i else gf.zeros((), dev)
        claims_v = torch.stack([bounds[slot[li], :, 0] if li in slot
                                else zero for li in range(i)])
        # absorb claims_v, then squeeze Liu's sig
        sig, D = absorb_squeeze(D, claims_v.t(), cc.depth)
    else:
        sig, D = squeeze_vec(D, cc.depth)

    # Liu: merge the claims about layer i-1 made by layers i .. depth-1
    bsig = beta_table(r_u, bl_prev, sig[:, 0])
    pre_size = cc.layers[i - 1].size
    multL = torch.zeros((2, pre_padded), dtype=torch.int64, device=dev)
    multL[:, :pre_size] = bsig[:, :pre_size]
    if P.liu_plan is not None:
        parts = []
        for (j, ds, bl_jl, _off) in P.liu_consumers:
            # j == i is this layer's own dad table, drawn just above
            rv_j = r_v if j == i else rvs[j]
            parts.append(beta_table(rv_j[:, :bl_jl], bl_jl,
                                    sig[:, j - i + 1])[:, :ds])
        multL = gf.add(multL, apply_scatter_arrays(torch.cat(parts, 1),
                                                   fsa[f"liuP{i}"]))
    liu_polys, r_liu, bounds, D = fs_sumcheck(
        [(tmp_v, None, multL, bl_prev)], bl_prev, D, absorb=True)
    liu_claim = bounds[0, :, 0]

    lp = protocol.LayerProof(
        p1_polys=p1_polys, claim_u=claim_u, p2_polys=p2_polys,
        claims_v=claims_v, liu_polys=liu_polys, liu_claim=liu_claim)
    chl = protocol.LayerChallenges(
        r_u=r_u, assert_r=assert_r, r_v=r_v, sig=sig, r_liu=r_liu)
    return lp, chl, D


def _fs_init(cc, values, root_l, D0):
    """The walk's start: absorb the input commitment root_l, squeeze the
    output claim point (it depends only on root_l), then compute vres and
    absorb it.  Returns (vres, r_out, D)."""
    r_out, D = absorb_squeeze(D0, root_l.view(2, 2).t(),
                              cc.layers[cc.depth - 1].bit_length)
    vres = mle_fold(protocol._values_block(cc, values, cc.depth - 1), r_out)
    return vres, r_out, absorb_elems(D, vres[:, None])


def _fs_walk(cc, plans, values, root_l, init, layer):
    """The FS walk through init(values, root_l) and layer(i, values, r_cur,
    D, rvs) for i from the top down (the eager functions or their graphs).
    Returns (Proof, Challenges, final state)."""
    vres, r_out, D = init(values, root_l)
    layer_proofs: List[Optional[protocol.LayerProof]] = [None] * cc.depth
    ch_layers: List[Optional[protocol.LayerChallenges]] = [None] * cc.depth
    r_cur = r_out
    for i in range(cc.depth - 1, 0, -1):
        # the Liu sums of layer i need r_v of its consumers j > i
        rvs = {j: ch_layers[j].r_v for (j, *_rest) in plans[i].liu_consumers
               if j != i}
        layer_proofs[i], ch_layers[i], D = layer(i, values, r_cur, D, rvs)
        r_cur = ch_layers[i].r_liu
    return (protocol.Proof(vres=vres, layers=layer_proofs),
            protocol.Challenges(r_out=r_out, layers=ch_layers), D)


def fs_prove(cc, plans, values, root_l, arrs, fsa):
    """The non-interactive GKR proof of ``values`` with every challenge
    squeezed from the device sponge, seeded by the input commitment root
    root_l ((4,) digest words).  arrs: protocol.circuit_arrays; fsa:
    fs_arrays.  Returns (Proof, Challenges, final state)."""
    return _fs_walk(
        cc, plans, values, root_l,
        lambda values, root_l: _fs_init(cc, values, root_l, fsa["D0"]),
        lambda i, values, r_cur, D, rvs: _fs_layer(cc, plans, i, values,
                                                   r_cur, D, rvs, arrs, fsa))


def make_fs_prover(cc, plans, arrs, device=None, staged=True, graphed=True):
    """Returns prove(values, root_l) -> (Proof, Challenges, final state),
    equal to ``fs_prove`` bit for bit, with the FS tables made here.
    staged=True: the JAX package's stages, each a graph (graphs.py): the
    init (sponge init, r_out, vres) and one graph per layer, whose
    arguments are (values, r_cur, D, rvs), chained on the graphs' own
    outputs and cloned once at the end.  staged=False: one graph of
    ``fs_prove``.  graphed=False: ``fs_prove`` itself, eager."""
    dev = _device.resolve(device)
    fsa = fs_arrays(cc, plans, dev)
    if not (staged and graphed):
        return graphs.program(
            lambda values, root_l: fs_prove(cc, plans, values, root_l, arrs,
                                            fsa), dev, "fs prover", graphed)

    init = graphs.Graphed(
        lambda values, root_l: _fs_init(cc, values, root_l, fsa["D0"]), dev,
        "fs prover init")
    layers = {i: graphs.Graphed(
        lambda values, r_cur, D, rvs, i=i: _fs_layer(
            cc, plans, i, values, r_cur, D, rvs, arrs, fsa),
        dev, f"fs prover layer {i}") for i in range(cc.depth - 1, 0, -1)}

    def run(values, root_l):
        return graphs.clone(_fs_walk(
            cc, plans, values, root_l,
            lambda *args: init.call(args, clone_out=False),
            lambda i, *args: layers[i].call(args, clone_out=False)))

    run.graphs = (init, *layers.values())
    return run


# ---------------------------------------------------------------------------
# PC half: public commit, fft_gkr messages and every FRI fold level
# ---------------------------------------------------------------------------

def _schedule_lengths(lg: int):
    """The fft_gkr draw schedule's keys and lengths, in the order of
    fft_gkr.draw_schedule; then each stage's ru, rv (lg each), al, be."""
    return (("r", lg), ("eval_points", 64), ("r0", lg + 10), ("r1", lg + 10),
            ("add_ru", lg + 6), ("add_rv", lg + 6), ("mult_ru", lg),
            ("mult_rv", lg))


def _fs_fft_schedule(D, lg: int, elems=None):
    """Absorb elems (if any), then squeeze the fft_gkr draw schedule in one
    fs_sponge call (the verifier's HostSponge feeds fft_gkr.run the same
    stream), split into its keys as views."""
    heads = _schedule_lengths(lg)
    total = sum(n for _, n in heads) + lg * (2 * lg + 2)
    ch, D = absorb_squeeze(D, elems, total)
    d, o = {}, 0
    for key, n in heads:
        d[key] = ch[:, o:o + n]
        o += n
    stages = []
    for _ in range(lg):
        stages.append((ch[:, o:o + lg], ch[:, o + lg:o + 2 * lg],
                       ch[:, o + 2 * lg], ch[:, o + 2 * lg + 1]))
        o += 2 * lg + 2
    d["stages"] = tuple(stages)
    return d, D


def _fs_pc_commit(l_codeword, final_point, D, bl0: int):
    """Public commit, absorb root_h and all_sum, squeeze the fft_gkr
    schedule.  Returns (h_oracle, all_sum, q_coefs, schedule, virtual
    oracle, D')."""
    q_values, q_coefs = virgo_pc.q_tables(final_point, bl0)
    h_oracle, _q_eval, _q_coefs, all_sum, vo = virgo_pc.commit_public(
        l_codeword, q_values, bl0)
    rt = h_oracle.tree[:, 1]
    sched, D = _fs_fft_schedule(
        D, bl0 - virgo_pc.LOG_SLICE,
        torch.cat([rt.view(2, 2).t(), all_sum], dim=1))
    return h_oracle, all_sum, q_coefs, sched, vo, D


def _fs_fold(cur, D, lgc: int):
    """One FRI level: squeeze r, fold (one level: one ``gf_fri_fold``
    launch off the cached twiddle table of the level's root), hash the
    level (one chain and one forest launch), absorb its root (one
    fs_sponge launch each).  Returns (oracle, r, codeword, D')."""
    r, D = squeeze(D)
    cur = virgo_pc.fold_step(cur, r, lgc)
    o = virgo_pc.make_oracle(cur)
    return o, r, cur, absorb_digest(D, o.tree[:, 1])


def _fs_pc_walk(l_codeword, final_point, D, bl0: int, commit, messages,
                fold):
    """The PC half through commit(l_codeword, final_point, D),
    messages(schedule) and fold(codeword, D, lgc) (the eager functions or
    their graphs); the FRI levels run from lgc = bl0 + RATE - LOG_SLICE
    down."""
    h_oracle, all_sum, q_coefs, sched, cur, D = commit(l_codeword,
                                                       final_point, D)
    msgs = messages(sched)
    lgc = bl0 + virgo_pc.RATE - virgo_pc.LOG_SLICE
    oracles, rands = [], []
    for _ in range(bl0 - virgo_pc.LOG_SLICE):
        o, r, cur, D = fold(cur, D, lgc)
        lgc -= 1
        oracles.append(o)
        rands.append(r)
    return (h_oracle, all_sum, q_coefs, msgs, oracles, cur,
            torch.stack(rands, dim=1), D)


def fs_pc_prove(l_codeword, final_point, D, bl0: int):
    """The PC half of the non-interactive prover on the device: public
    commit, absorb root_h and all_sum, the fft_gkr message tape, then per
    FRI level squeeze r, fold, hash the level and absorb its root before
    the next challenge.  Returns (h_oracle, all_sum, q_coefs (the q table's
    per-slice IFFT), fft_gkr messages, level oracles, final codeword,
    fold_rands (2, levels), D')."""
    lg = bl0 - virgo_pc.LOG_SLICE
    dev = l_codeword.device
    return _fs_pc_walk(
        l_codeword, final_point, D, bl0,
        lambda l_codeword, final_point, D: _fs_pc_commit(
            l_codeword, final_point, D, bl0),
        lambda sched: fft_gkr.prove_messages(lg, sched, dev), _fs_fold)


def make_fs_pc_prover(bl0: int, device=None, staged=True, graphed=True):
    """Returns run(l_codeword, final_point, D) -> fs_pc_prove's 8-tuple,
    bit for bit.  staged=True: the JAX package's stages, each a graph: the
    public commit with its absorbs and the schedule's squeezes, the fft_gkr
    message tape (``fft_gkr.prove_messages``) and one graph per FRI level,
    chained on the graphs' own outputs and cloned once at the end.
    staged=False: one graph of ``fs_pc_prove``.  graphed=False:
    ``fs_pc_prove`` itself, eager."""
    dev = _device.resolve(device)
    if not (staged and graphed):
        return graphs.program(
            lambda l_codeword, final_point, D: fs_pc_prove(
                l_codeword, final_point, D, bl0),
            dev, "fs pc prover", graphed)

    lg = bl0 - virgo_pc.LOG_SLICE
    commit = graphs.Graphed(
        lambda l_codeword, final_point, D: _fs_pc_commit(
            l_codeword, final_point, D, bl0), dev, "fs pc commit")
    tape = graphs.Graphed(lambda sched: fft_gkr.prove_messages(lg, sched, dev),
                          dev, "fs pc messages")
    top = bl0 + virgo_pc.RATE - virgo_pc.LOG_SLICE
    folds = {lgc: graphs.Graphed(
        lambda cur, D, lgc=lgc: _fs_fold(cur, D, lgc), dev,
        f"fs pc fold {lgc}") for lgc in range(top, top - lg, -1)}

    def run(l_codeword, final_point, D):
        return graphs.clone(_fs_pc_walk(
            l_codeword, final_point, D, bl0,
            lambda *args: commit.call(args, clone_out=False),
            lambda sched: tape.call((sched,), clone_out=False),
            lambda cur, D, lgc: folds[lgc].call((cur, D), clone_out=False)))

    run.graphs = (commit, tape, *folds.values())
    return run


# ---------------------------------------------------------------------------
# Host-side sponge (verifier re-derivation)
# ---------------------------------------------------------------------------

class HostSponge:
    def __init__(self):
        self.state = hashlib.sha3_256(DOMAIN_TAG).digest()

    def _h(self, data64: bytes) -> bytes:
        return hashlib.sha3_256(data64).digest()

    def absorb_pair(self, e0, e1):
        blob = b"".join(int(x).to_bytes(8, "little")
                        for x in (e0[0], e0[1], e1[0], e1[1]))
        self.state = self._h(blob + self.state)

    def absorb_elems(self, elems):
        """elems: list of (real, img) int pairs."""
        es = list(elems)
        if len(es) % 2:
            es.append((0, 0))
        for k in range(0, len(es), 2):
            self.absorb_pair(es[k], es[k + 1])

    def squeeze(self):
        h = self._h(self.state + b"\x01" + b"\x00" * 31)
        self.state = self._h(self.state + b"\x02" + b"\x00" * 31)
        w = np.frombuffer(h, dtype=np.uint64)
        return (int(w[0]) % gf.MOD, int(w[1]) % gf.MOD)

    def squeeze_vec(self, n):
        return [self.squeeze() for _ in range(n)]

    # rng-adapter API (GlibcRandom-compatible) so transcript-seeded
    # components (fft_gkr, query positions) can draw from the sponge
    def field_element(self):
        return self.squeeze()

    def rand(self):
        r, _ = self.squeeze()
        return r & 0x7FFFFFFF

    @staticmethod
    def from_device_state(D):
        """The device state (4,) int64 as the u64 words' little-endian
        bytes: the one device-to-host read between the GKR walk and query
        drawing."""
        sp = HostSponge.__new__(HostSponge)
        sp.state = gf.to_numpy(D).astype("<u8").tobytes()
        return sp

    def absorb_digest_words(self, words4):
        w = np.asarray(words4)
        self.absorb_pair((int(w[0]), int(w[1])), (int(w[2]), int(w[3])))


def _host(x) -> np.ndarray:
    """A proof field as host numpy u64: a port tensor is read once."""
    if isinstance(x, torch.Tensor):
        return gf.to_numpy(x)
    return np.asarray(x, dtype=np.uint64)


def derive_challenges(cc, proof: protocol.Proof, root_l, device):
    """Verifier side: re-derive every FS challenge from the proof messages
    with the host sponge.  root_l: (4,) digest words.  The proof's fields
    may be host numpy (as proof_io.load gives them: no device read at all)
    or port tensors (each read once).  Returns (Challenges on ``device``,
    the sponge after the GKR messages)."""
    sp = HostSponge()
    sp.absorb_digest_words(_host(root_l))

    def el(a):
        return (int(a[0]), int(a[1]))

    def polys_rs(polys):
        rs = []
        for j in range(polys.shape[0]):
            sp.absorb_elems([el(polys[j, :, 0]), el(polys[j, :, 1]),
                             el(polys[j, :, 2])])
            rs.append(sp.squeeze())
        return rs

    def T(pairs):
        out = np.zeros((2, len(pairs)), dtype=np.uint64)
        for k, (r, i) in enumerate(pairs):
            out[0, k], out[1, k] = r, i
        return gf.tensor(out, device)

    depth = cc.depth
    r_out = T(sp.squeeze_vec(cc.layers[depth - 1].bit_length))
    sp.absorb_elems([el(_host(proof.vres))])

    layers: list = [None] * depth
    for i in range(depth - 1, 0, -1):
        lp = proof.layers[i]
        assert_r = T([sp.squeeze()])[:, 0]
        r_u = T(polys_rs(_host(lp.p1_polys)))
        sp.absorb_elems([el(_host(lp.claim_u))])
        r_v = None
        if lp.p2_polys is not None:
            r_v = T(polys_rs(_host(lp.p2_polys)))
            cv = _host(lp.claims_v)
            sp.absorb_elems([el(cv[k]) for k in range(cv.shape[0])])
        sig = T(sp.squeeze_vec(depth))
        r_liu = T(polys_rs(_host(lp.liu_polys)))
        sp.absorb_elems([el(_host(lp.liu_claim))])
        layers[i] = protocol.LayerChallenges(
            r_u=r_u, assert_r=assert_r, r_v=r_v, sig=sig, r_liu=r_liu)
    return protocol.Challenges(r_out=r_out, layers=layers), sp


# (id of a compiled circuit, device) -> fs_verify's eager verifier, dropped
# with the circuit
_VERIFIERS: dict = {}


def fs_verify(cc, proof: protocol.Proof, root_l, output_values=None):
    """Non-interactive GKR verification: re-derive the challenges, then run
    the standard checks on the proof's device (an eager ``make_verifier``,
    made once per circuit and device, as ``driver.verify_fs`` keeps
    ``cp.verifier``).  proof: port tensors.  Returns (ok, final_claim,
    final_point)."""
    dev = proof.vres.device
    ch, _sp = derive_challenges(cc, proof, root_l, dev)
    key = (id(cc), str(dev))
    if key not in _VERIFIERS:
        _VERIFIERS[key] = protocol.make_verifier(cc, dev, graphed=False)
        weakref.finalize(cc, _VERIFIERS.pop, key, None)
    return _VERIFIERS[key](proof, ch, output_values)
