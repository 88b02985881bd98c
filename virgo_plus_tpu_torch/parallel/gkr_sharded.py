"""Sharded GKR prover: the sumcheck tables of one proof over the sp ranks.

Counterpart of ``virgo_plus_tpu/parallel/gkr_sharded.py`` (reference
src/prover.cpp:189-420), one process per rank (``parallel/mesh.py``).
Every rank holds the whole circuit, evaluates it and draws the same
challenges; what it holds of each sumcheck table is its shard.

* Layout: a table of 2^bl entries shards over its leading index bits, so
  rank q holds entries [q·2^(bl - log S), (q+1)·2^(bl - log S)).  K1 folds
  pairs (2i, 2i+1), the low bit, so the first bl - log S rounds stay local;
  the partial round polys are summed over sp, the S bound scalars form the
  2^log S tail table, and K1 folds the tail on every rank
  (``sharded.sharded_fold``).  Tables with bl < log S + 1 stay whole on
  every rank (``_is_sharded``).
* Table inits: the gate scatters are segment sums over a plan sorted by
  destination, so rank q's destination block is one contiguous segment of
  the sorted sources: rank q evaluates the gates of that segment only and
  segment-sums them.  Per-gate beta weights come from two half-size eq
  tables (``_halves``, ``_at``; the reference's initHalfTable,
  src/utils.cpp:8-27), and the Liu table's own beta part is rank q's slice
  of a tensor product (``_beta_local``), so no rank builds an O(#gates) or
  O(2^bl) table that it does not own.

Field operations are exact, so the regrouped sums give the single-device
prover's proof bit for bit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..circuits.compile import compile_circuit, eval_arrays, evaluate, \
    index, input_buffer
from ..field import gf
from ..gkr import protocol
from ..gkr.beta import beta_table
from ..gkr.sumcheck import mle_fold, prefix_sum, scan_sumcheck_batched
from .mesh import Mesh
from .sharded import sharded_fold


def _is_sharded(bl: int, log_s: int) -> bool:
    return bl >= log_s + 1 and log_s > 0


def _log_s(mesh: Mesh) -> int:
    log_s = mesh.sp.bit_length() - 1
    assert 1 << log_s == mesh.sp
    return log_s


# ---------------------------------------------------------------------------
# Compile-time plan blocks
# ---------------------------------------------------------------------------

def _plan_block(plan, lo: int, size: int, device) -> dict:
    """Destinations [lo, lo + size) of a ScatterPlan as index tensors:
    perm, the sources scattering there in destination order, and
    starts/ends into that segment's 0-prepended prefix sum.  A block
    nothing scatters into has an empty perm."""
    seg_lo = int(plan.starts[lo])
    seg_hi = int(plan.ends[lo + size - 1])
    return dict(perm=index(plan.perm[seg_lo:seg_hi], device),
                starts=index(plan.starts[lo:lo + size] - seg_lo, device),
                ends=index(plan.ends[lo:lo + size] - seg_lo, device))


def layer_plan_arrays(cc, plans, i: int, S: int, log_s: int, q: int,
                      device) -> dict:
    """Rank q's tensors of layer i: the gate tables (x, y, co, ia) and, for
    each scatter, the plan block of the destinations it owns (all of them
    for a table that stays whole).  Shared by the glibc and the FS sharded
    provers."""
    L = cc.layers[i]
    Pl = plans[i]
    arr = dict(x=index(L.x_idx, device), y=index(L.y_idx, device),
               co=gf.tensor(L.coeff, device))
    if L.has_assert:
        arr["ia"] = protocol._assert_mask(L, device)
    pre_padded = cc.layers[i - 1].padded
    if _is_sharded(cc.layers[i - 1].bit_length, log_s):
        lo, n = q * (pre_padded // S), pre_padded // S
    else:
        lo, n = 0, pre_padded
    arr["p1"] = _plan_block(Pl.p1, lo, n, device)
    if Pl.liu_plan is not None:
        arr["liu"] = _plan_block(Pl.liu_plan, lo, n, device)
    if Pl.p2 is not None:
        dg = np.asarray(L.dad_gather_idx)
        for li in range(i):
            if L.dad_sizes[li] == 0:
                continue
            bl_l = L.dad_bls[li]
            lo, n = L.dad_offsets[li], 1 << bl_l
            if _is_sharded(bl_l, log_s):
                n //= S
                lo += q * n
            arr[f"p2_{li}"] = _plan_block(Pl.p2, lo, n, device)
            arr[f"dg_{li}"] = index(np.maximum(dg[lo:lo + n], 0), device)
            arr[f"dgm_{li}"] = torch.from_numpy(dg[lo:lo + n] >= 0).to(device)
    return arr


def _scatter_apply_ordered(c, pl):
    """Segment-sum contributions already in perm order (2, k) into the
    block's (2, size) destinations."""
    s0 = torch.cat([gf.zeros((1,), c.device), prefix_sum(c)], dim=1)
    return gf.sub(s0[:, pl["ends"]], s0[:, pl["starts"]])


# ---------------------------------------------------------------------------
# Beta weights: split-half tables and the local slice of a tensor product
# ---------------------------------------------------------------------------

def _halves(r, bl: int, init):
    """Split-half eq tables (src/utils.cpp:8-27): entry g of
    beta_table(r, bl, init) is lo[g & (2^h - 1)] · hi[g >> h]."""
    h = bl // 2
    one = gf.ones((), r.device)
    return beta_table(r[:, :h], h, init), beta_table(r[:, h:bl], bl - h,
                                                     one), h


def _at(tabs, idx):
    lo, hi, h = tabs
    return gf.mul(lo[:, idx & ((1 << h) - 1)], hi[:, idx >> h])


def _beta_local(r, bl: int, local_bl: int, init, q: int):
    """Rank q's slice of beta_table(r, bl, init): the high variables give
    the scalar eq(r[local_bl:bl], bits(q)), the low ones the local table."""
    one = gf.ones((), r.device)
    scale = init
    for b in range(local_bl, bl):
        rb = r[:, b]
        scale = gf.mul(scale, rb if (q >> (b - local_bl)) & 1
                       else gf.sub(one, rb))
    return beta_table(r[:, :local_bl], local_bl, scale)


# ---------------------------------------------------------------------------
# Table inits of one layer on one rank (glibc and FS provers alike)
# ---------------------------------------------------------------------------

def _gate_weight(L, arr, r_cur, assert_r):
    """bg_at(g): the beta weight of gates g of layer L at the point r_cur,
    assert gates scaled by assert_r."""
    tabs = _halves(r_cur, L.bit_length, gf.ones((), r_cur.device))

    def bg_at(pg):
        bg = _at(tabs, pg)
        if L.has_assert:
            bg = torch.where(arr["ia"][pg][None, :],
                             gf.mul(bg, assert_r[:, None]), bg)
        return bg

    return bg_at


def _values_block(cc, values, i: int, mesh: Mesh, sharded: bool):
    """Layer i's padded values, or rank q's slice of them when sharded."""
    block = protocol._values_block(cc, values, i)
    if not sharded:
        return block
    n = block.shape[1] // mesh.sp
    return block[:, mesh.sp_rank * n:(mesh.sp_rank + 1) * n]


def _p1_tables(values, arr, bg_at):
    """Phase-1 (addV, multV) of the destinations this rank owns."""
    pl = arr["p1"]
    pg = pl["perm"]
    bg = bg_at(pg)
    y = values[:, arr["y"][pg]]
    A, B, C, D = arr["co"][:, :, pg]
    return (_scatter_apply_ordered(gf.mul(bg, gf.add(gf.mul(B, y), D)), pl),
            _scatter_apply_ordered(gf.mul(bg, gf.add(A, gf.mul(C, y))), pl))


def _p2_tables(values, arr, li: int, bg_at, tabs_u, claim_u):
    """Phase-2 (v, addV, multV) of source layer li's dad table."""
    pl = arr[f"p2_{li}"]
    pg = pl["perm"]
    tmp_g = gf.mul(bg_at(pg), _at(tabs_u, arr["x"][pg]))
    A, B, C, D = arr["co"][:, :, pg]
    cu = claim_u[:, None]
    vdad = torch.where(arr[f"dgm_{li}"][None, :], values[:, arr[f"dg_{li}"]],
                       0)
    return (vdad,
            _scatter_apply_ordered(gf.mul(tmp_g, gf.add(gf.mul(A, cu), D)),
                                   pl),
            _scatter_apply_ordered(gf.mul(tmp_g, gf.add(B, gf.mul(C, cu))),
                                   pl))


def _liu_mult(cc, plans, i: int, arr, r_u, sig, r_v_of, mesh: Mesh,
              log_s: int):
    """The Liu table's mult side for layer i-1 (the a side is zero):
    sig_0 · beta(r_u) on the live gates plus every consumer layer's
    sig_j · beta(r_v_j) scattered onto its dads.  r_v_of(j): layer j's r_v."""
    bl_prev = cc.layers[i - 1].bit_length
    pre_padded = cc.layers[i - 1].padded
    pre_size = cc.layers[i - 1].size
    dev = r_u.device
    if _is_sharded(bl_prev, log_s):
        q, n = mesh.sp_rank, pre_padded // mesh.sp
        bsig = _beta_local(r_u, bl_prev, bl_prev - log_s, sig[:, 0], q)
        gpos = q * n + torch.arange(n, device=dev)
        multL = torch.where(gpos < pre_size, bsig, 0)
    else:
        multL = torch.zeros((2, pre_padded), dtype=torch.int64, device=dev)
        multL[:, :pre_size] = beta_table(r_u, bl_prev, sig[:, 0])[:,
                                                                   :pre_size]
    if plans[i].liu_plan is None:
        return multL
    pl = arr["liu"]
    pg = pl["perm"]
    contr = torch.zeros((2, pg.shape[0]), dtype=torch.int64, device=dev)
    for (j, ds, bl_jl, offp) in plans[i].liu_consumers:
        tabs_j = _halves(r_v_of(j), bl_jl, sig[:, j - i + 1])
        inb = (pg >= offp) & (pg < offp + ds)
        rel = torch.clamp(pg - offp, 0, (1 << bl_jl) - 1)
        contr = gf.add(contr, torch.where(inb[None, :], _at(tabs_j, rel), 0))
    return gf.add(multL, _scatter_apply_ordered(contr, pl))


# ---------------------------------------------------------------------------
# The sharded prover
# ---------------------------------------------------------------------------

def _fold_all(jobs, mesh: Mesh, log_s: int):
    """jobs {bl: [(tag, v, a, m, r)]}, v, a, m this rank's blocks or whole
    tables -> {tag: (polys (bl, 2, 3), (vb, ab, mb) each (2,))}, the same
    on every rank: per table size one K1 call, or for a sharded size one
    local call, one field sum, one gather and one tail call."""
    out = {}
    for bl, group in sorted(jobs.items()):
        v, a, m, rs = (torch.stack([g[k] for g in group], dim=1)
                       for k in range(1, 5))
        polys, bound = (sharded_fold(v, a, m, rs, mesh)
                        if _is_sharded(bl, log_s)
                        else scan_sumcheck_batched(v, a, m, rs))
        for k, g in enumerate(group):
            out[g[0]] = (polys[:, k], tuple(b[:, k] for b in bound))
    return out


def make_sharded_prover(cc, plans, mesh: Mesh):
    """Returns run(values, ch) -> protocol.Proof with every table init and
    every fold sharded over the sp ranks; every rank returns the whole
    proof, bit-identical to protocol.prove's.  values: the whole (2, T)
    circuit values on this rank's device; ch: the challenge schedule."""
    log_s = _log_s(mesh)
    depth = cc.depth
    dev = mesh.device
    arrs = {i: layer_plan_arrays(cc, plans, i, mesh.sp, log_s, mesh.sp_rank,
                                 dev) for i in range(1, depth)}

    def run(values, ch):
        vres = mle_fold(protocol._values_block(cc, values, depth - 1),
                        ch.r_out)
        # phase-1 and Liu tables of every layer, folded per table size
        jobs, bg_at = {}, {}
        for i in range(depth - 1, 0, -1):
            L, arr, chl = cc.layers[i], arrs[i], ch.layers[i]
            bl_prev = cc.layers[i - 1].bit_length
            sh = _is_sharded(bl_prev, log_s)
            bg_at[i] = _gate_weight(L, arr, protocol._r_cur(cc, ch, i),
                                    chl.assert_r)
            vloc = _values_block(cc, values, i - 1, mesh, sh)
            add, mult = _p1_tables(values, arr, bg_at[i])
            multL = _liu_mult(cc, plans, i, arr, chl.r_u[:, :bl_prev],
                              chl.sig, lambda j: ch.layers[j].r_v, mesh,
                              log_s)
            jobs.setdefault(bl_prev, []).extend([
                (("p1", i), vloc, add, mult, chl.r_u[:, :bl_prev]),
                (("liu", i), vloc, torch.zeros_like(multL), multL,
                 chl.r_liu[:, :bl_prev])])
        res = _fold_all(jobs, mesh, log_s)

        # phase-2 tables (they need the phase-1 claims)
        jobs = {}
        for i in range(depth - 1, 0, -1):
            L, arr, chl = cc.layers[i], arrs[i], ch.layers[i]
            if L.max_dad_bit_length < 0:
                continue
            bl_prev = cc.layers[i - 1].bit_length
            tabs_u = _halves(chl.r_u, bl_prev, gf.ones((), dev))
            claim_u = res[("p1", i)][1][0]
            for li in range(i):
                if L.dad_sizes[li]:
                    bl_l = L.dad_bls[li]
                    jobs.setdefault(bl_l, []).append(
                        ((i, li),) + _p2_tables(values, arr, li, bg_at[i],
                                                tabs_u, claim_u)
                        + (chl.r_v[:, :bl_l],))
        p2_res = _fold_all(jobs, mesh, log_s)
        p2_out = protocol._prove_p2_combine(cc, ch, p2_res, ())

        layers = [None] * depth
        for i in range(depth - 1, 0, -1):
            p2_polys, claims_v = p2_out.get(i, (None, None))
            layers[i] = protocol.LayerProof(
                p1_polys=res[("p1", i)][0], claim_u=res[("p1", i)][1][0],
                p2_polys=p2_polys, claims_v=claims_v,
                liu_polys=res[("liu", i)][0],
                liu_claim=res[("liu", i)][1][0])
        return protocol.Proof(vres=vres, layers=layers)

    return run


# ---------------------------------------------------------------------------
# The whole sharded prove (GKR + PC), as driver.prove
# ---------------------------------------------------------------------------

def compile_sharded(circuit, mesh: Mesh) -> dict:
    """Compile once per circuit and mesh; pass to prove_sharded's
    ``compiled=`` to reuse the rank's tables across proves."""
    from . import pc_sharded

    cc = compile_circuit(circuit)
    plans = protocol.build_plans(cc)
    bl0 = cc.layers[0].bit_length
    return dict(cc=cc, plans=plans, bl0=bl0,
                eval_arrs=eval_arrays(cc, mesh.device),
                gkr=make_sharded_prover(cc, plans, mesh),
                pc=pc_sharded.sharded_pc_prove(mesh, bl0))


def prove_sharded(circuit, mesh: Mesh, seed: int = 3396,
                  witness: Optional[np.ndarray] = None, compiled=None):
    """The sharded prove of driver.prove: sharded GKR, sharded PC
    (pc_sharded) and query answers gathered from the shards
    (sharded_queries).  Codewords and Merkle trees stay sharded; only the
    opened values and path digests move.  Every rank returns the same
    (FullProof, info), the FullProof bit-identical to driver.prove's."""
    from .. import driver, proof_io
    from ..pc import fft_gkr, virgo_pc, vpd
    from ..utils.glibc_rand import GlibcRandom
    from .sharded_queries import answer_queries_sharded
    from .pc_sharded import gather_strided, unstride

    comp = compiled or compile_sharded(circuit, mesh)
    cc, bl0, dev = comp["cc"], comp["bl0"], mesh.device
    t0 = time.time()
    inputs = input_buffer(cc, witness, dev)
    values = evaluate(cc, inputs, comp["eval_arrs"])
    driver._check_asserts(cc, values)
    rng = GlibcRandom(seed)
    ch = protocol.make_challenges(cc, rng, dev)
    proof = comp["gkr"](values, ch)
    final_point = ch.layers[1].r_liu[:, :bl0]
    q_values = beta_table(final_point, bl0, gf.ones((), dev))

    n_folds = bl0 - virgo_pc.LOG_SLICE
    fg = fft_gkr.run(n_folds, rng, device=dev)
    randomness = []
    for _ in range(n_folds):
        r, i = rng.field_element()
        randomness.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                      dev).reshape(2))
    out = comp["pc"](inputs, q_values, randomness)
    pows = vpd.draw_positions(rng, bl0)
    answers, query_size = answer_queries_sharded(
        pows, bl0, out["l"], out["h"], out["levels"], mesh)

    full = proof_io.FullProof(
        vres=gf.to_numpy(proof.vres),
        layers=[None] + [driver._layer_proof_arrays(proof.layers[i])
                         for i in range(1, cc.depth)],
        root_l=gf.to_numpy(out["l"].root),
        root_h=gf.to_numpy(out["h"].root),
        all_sum=gf.to_numpy(out["all_sum"]),
        level_roots=np.stack([gf.to_numpy(o.root) for o in out["levels"]]),
        final_codeword=unstride(gf.to_numpy(gather_strided(
            out["levels"][-1].cw, mesh)), mesh.sp),
        fft_gkr_messages=fg.messages,
        queries=answers,
        meta=dict(seed=seed, bl0=bl0, depth=cc.depth, mesh_shards=mesh.sp))
    info = dict(prove_time=time.time() - t0,
                gkr_proof_size=driver.gkr_proof_size_bytes(cc),
                pc_proof_size=fg.proof_size + query_size + 2 * 32 + 16,
                fft_gkr_ok=fg.ok, backend=mesh.backend,
                per_rank_pc_bytes=_pc_bytes(out))
    return full, info


def _pc_bytes(out) -> int:
    """Bytes of the PC state this rank holds after the prove: its strided
    codeword blocks and its Merkle digests."""
    n = 0
    for o in [out["l"], out["h"]] + out["levels"]:
        for t in (o.cw, o.sub, o.top):
            if t is not None:
                n += t.numel() * t.element_size()
    return n
