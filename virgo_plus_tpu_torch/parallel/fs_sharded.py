"""Fiat–Shamir sharded prover: the sponge on every rank, the tables sharded.

Counterpart of ``virgo_plus_tpu/parallel/fs_sharded.py``.  FS challenges
depend on the messages: each round's challenge is squeezed after its round
poly is absorbed, so the walk is sequential.  Every rank holds the same
sponge (``gkr/fs.py``: an absorb-then-squeeze stream one ``fs_sponge``
launch on the card) and the tables are sharded as in
``gkr_sharded`` (same plan blocks, gate weights and beta slices).  A round
of a sharded table computes the rank's partial poly, sums it over sp,
absorbs and squeezes on every rank, and binds the local tables; once the
local bits are spent, the S bound scalars are gathered into the 2^log S
tail, which every rank folds whole (one ``fs_sumcheck``).  The rounds with
a collective inside keep their field ops a kernel each.

The PC half threads the sponge through the sharded pipeline
(``pc_sharded``): public commit, absorb root_h and all_sum, squeeze the
fft_gkr schedule, then per FRI level squeeze r, fold locally, hash the
level's sharded tree and absorb its root.  Proofs equal
``driver.prove_fs``'s bit for bit and verify with ``driver.verify_fs``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..circuits.compile import compile_circuit, eval_arrays, evaluate, \
    input_buffer
from ..field import gf
from ..gkr import fs, protocol
from ..gkr.beta import beta_table
from ..gkr.sumcheck import tree_sum
from ..pc import fft_gkr, virgo_pc
from . import pc_sharded
from .gkr_sharded import (_gate_weight, _halves, _is_sharded, _liu_mult,
                          _log_s, _p1_tables, _p2_tables, _values_block,
                          layer_plan_arrays)
from .mesh import Mesh


def _fs_fold_sharded(v, a, m, bl: int, log_s: int, mesh: Mesh, D):
    """fs.fs_scan_sumcheck of a table sharded over sp: v, a, m are this
    rank's (2, 2^(bl - log S)) blocks.  Returns (polys (bl, 2, 3), rs
    (2, bl), bound (v, a, m) each (2,), D'), the same on every rank."""
    T = torch.stack([v, a, m], dim=1)
    polys, rs = [], []
    for _ in range(bl - log_s):
        poly, T0, d = fs._round(T)
        poly = mesh.field_sum(poly)
        rs1, D = fs.absorb_squeeze(D, poly, 1)
        r = rs1[:, 0]
        T = fs._bind(T0, d, r)
        polys.append(poly)
        rs.append(r)
    # the S bound scalars, in shard order, are the tail table
    vt, at, mt = mesh.all_gather(T[:, :, 0]).permute(2, 1, 0)  # (2, S) each
    polys_t, rs_t, bound, D = fs.fs_scan_sumcheck(vt, at, mt, log_s, D)
    return (torch.cat([torch.stack(polys), polys_t]),
            torch.cat([torch.stack(rs, dim=1), rs_t], dim=1), bound, D)


def _fs_phase2_joint(groups, mdb: int, D, mesh: Mesh):
    """fs._phase2_plain's rounds with sharded tables: groups {bl: (li
    list, sharded, T (2, 3, K, n))}.  The partial polys of the sharded
    groups are summed over sp once a round; a sharded group whose local
    tables are down to one entry is gathered into its (2, 3, K, S) tail
    and goes on whole.
    Returns (polys (mdb, 2, 3), r_v (2, mdb), {li: bound v (2,)}, D')."""
    dev = D.device
    zero = gf.zeros((), dev)
    one = gf.ones((), dev)
    a_term = zero
    polys, rs, bounds = [], [], {}
    for j in range(mdb):
        if j > 0:
            a_term = gf.mul(a_term, gf.sub(one, rs[-1]))
        pj = gf.zeros((3,), dev)
        pj_sh = None
        live = {}
        for bl, (lis, sh, T) in groups.items():
            if j < bl:
                poly, T0, d = fs._round(T)
                if sh:
                    pj_sh = poly if pj_sh is None else gf.add(pj_sh, poly)
                else:
                    pj = gf.add(pj, poly)
                live[bl] = (T0, d)
            elif j == bl:
                v, a, m = T[:, 0, :, 0], T[:, 1, :, 0], T[:, 2, :, 0]
                a_term = gf.add(a_term, tree_sum(gf.add(gf.mul(v, m), a)))
                bounds.update((li, v[:, k]) for k, li in enumerate(lis))
        if pj_sh is not None:
            pj = gf.add(pj, mesh.field_sum(pj_sh))
        pj = gf.add(pj, torch.stack([zero, gf.neg(a_term), a_term], 1))
        rs1, D = fs.absorb_squeeze(D, pj, 1)
        r = rs1[:, 0]
        for bl, (T0, d) in live.items():
            lis, sh, _ = groups[bl]
            T = fs._bind(T0, d, r)
            if sh and T.shape[-1] == 1:
                T = mesh.all_gather(T[..., 0]).permute(1, 2, 3, 0)
                sh = False
            groups[bl] = (lis, sh, T)
        polys.append(pj)
        rs.append(r)
    for bl, (lis, _sh, T) in groups.items():
        if bl == mdb:
            bounds.update((li, T[:, 0, k, 0]) for k, li in enumerate(lis))
    polys = (torch.stack(polys) if polys
             else torch.zeros((0, 2, 3), dtype=torch.int64, device=dev))
    r_v = (torch.stack(rs, dim=1) if rs
           else torch.zeros((2, 0), dtype=torch.int64, device=dev))
    return polys, r_v, bounds, D


def _fs_layer(cc, plans, i: int, values, r_cur, D, rvs, arr, mesh: Mesh,
              log_s: int):
    """fs._fs_layer on this rank: phase 1, the joint phase 2 and Liu, with
    the tables' inits and folds sharded as gkr_sharded's.  Returns
    (LayerProof, LayerChallenges, D'), the same on every rank."""
    L = cc.layers[i]
    bl_prev = cc.layers[i - 1].bit_length
    sh1 = _is_sharded(bl_prev, log_s)
    dev = values.device

    def fold(v, a, m, bl, sharded, D):
        if sharded:
            return _fs_fold_sharded(v, a, m, bl, log_s, mesh, D)
        return fs.fs_scan_sumcheck(v, a, m, bl, D)

    assert_r, D = fs.squeeze(D)
    bg_at = _gate_weight(L, arr, r_cur, assert_r)
    vloc = _values_block(cc, values, i - 1, mesh, sh1)
    add, mult = _p1_tables(values, arr, bg_at)
    p1_polys, r_u, (claim_u, _, _), D = fold(vloc, add, mult, bl_prev, sh1,
                                             D)
    D = fs.absorb_elems(D, claim_u[:, None])

    p2_polys = claims_v = r_v = None
    if L.max_dad_bit_length >= 0:
        tabs_u = _halves(r_u, bl_prev, gf.ones((), dev))
        jobs = {}
        for li in range(i):
            if L.dad_sizes[li]:
                jobs.setdefault(L.dad_bls[li], []).append((li, torch.stack(
                    _p2_tables(values, arr, li, bg_at, tabs_u, claim_u), 1)))
        groups = {bl: ([li for li, _ in js], _is_sharded(bl, log_s),
                       torch.stack([t for _, t in js], 2))
                  for bl, js in jobs.items()}
        p2_polys, r_v, bounds, D = _fs_phase2_joint(
            groups, L.max_dad_bit_length, D, mesh)
        zero = gf.zeros((), dev)
        claims_v = torch.stack([bounds.get(li, zero) for li in range(i)])
        D = fs.absorb_elems(D, claims_v.t())

    sig, D = fs.squeeze_vec(D, cc.depth)
    multL = _liu_mult(cc, plans, i, arr, r_u, sig,
                      lambda j: r_v if j == i else rvs[j], mesh, log_s)
    liu_polys, r_liu, (liu_claim, _, _), D = fold(
        vloc, torch.zeros_like(multL), multL, bl_prev, sh1, D)
    D = fs.absorb_elems(D, liu_claim[:, None])
    lp = protocol.LayerProof(
        p1_polys=p1_polys, claim_u=claim_u, p2_polys=p2_polys,
        claims_v=claims_v, liu_polys=liu_polys, liu_claim=liu_claim)
    chl = protocol.LayerChallenges(
        r_u=r_u, assert_r=assert_r, r_v=r_v, sig=sig, r_liu=r_liu)
    return lp, chl, D


def make_fs_sharded_prover(cc, plans, mesh: Mesh):
    """Returns prove(values, root_l) -> (Proof, Challenges, D), the sharded
    fs.make_fs_prover (eager: gloo collectives cannot be captured): every
    rank returns the same."""
    log_s = _log_s(mesh)
    arrs = {i: layer_plan_arrays(cc, plans, i, mesh.sp, log_s, mesh.sp_rank,
                                 mesh.device) for i in range(1, cc.depth)}
    D0 = fs.init_state(mesh.device)

    def prove(values, root_l):
        return fs._fs_walk(
            cc, plans, values, root_l,
            lambda values, root_l: fs._fs_init(cc, values, root_l, D0),
            lambda i, values, r_cur, D, rvs: _fs_layer(
                cc, plans, i, values, r_cur, D, rvs, arrs[i], mesh, log_s))

    return prove


def make_fs_sharded_pc(mesh: Mesh, bl0: int):
    """The sharded fs.fs_pc_prove, eager.  Returns run(l_local (2, 65, L),
    final_point, D) -> (h ShardedOracle, all_sum, fft_gkr messages, level
    ShardedOracles, D'): fs_pc_prove's outputs but q_coefs and fold_rands,
    which a proof does not carry."""
    public = pc_sharded.sharded_commit_public(mesh, bl0)
    lg = bl0 - virgo_pc.LOG_SLICE

    def run(l_local, final_point, D):
        dev = l_local.device
        q_values = beta_table(final_point, bl0, gf.ones((), dev))
        h_oracle, all_sum, vo = public(l_local, q_values)
        rt = h_oracle.root
        D = fs.absorb_pair(D, rt[:2], rt[2:])
        D = fs.absorb_elems(D, all_sum)
        sched, D = fs._fs_fft_schedule(D, lg)
        msgs = fft_gkr.prove_messages(lg, sched, dev)
        cur = vo
        lgc = bl0 + virgo_pc.RATE - virgo_pc.LOG_SLICE
        levels = []
        for _ in range(lg):
            r, D = fs.squeeze(D)
            cur = pc_sharded.sharded_fold_step(cur, r, lgc, mesh)
            o = pc_sharded.sharded_oracle_tree(cur, mesh)
            D = fs.absorb_pair(D, o.root[:2], o.root[2:])
            lgc -= 1
            levels.append(o)
        return h_oracle, all_sum, msgs, levels, D

    return run


def compile_fs_sharded(circuit, mesh: Mesh) -> dict:
    """Compile once per circuit and mesh; pass to prove_fs_sharded's
    ``compiled=``."""
    cc = compile_circuit(circuit)
    plans = protocol.build_plans(cc)
    bl0 = cc.layers[0].bit_length
    return dict(cc=cc, plans=plans, bl0=bl0,
                eval_arrs=eval_arrays(cc, mesh.device),
                commit=pc_sharded.sharded_commit_private(mesh, bl0),
                gkr=make_fs_sharded_prover(cc, plans, mesh),
                pc=make_fs_sharded_pc(mesh, bl0))


def prove_fs_sharded(circuit, mesh: Mesh,
                     witness: Optional[np.ndarray] = None, compiled=None):
    """The sharded driver.prove_fs: the sponge threads through the sharded
    GKR walk and the sharded PC half; codewords and trees stay sharded and
    only the query answers move.  Every rank returns the same (FullProof,
    info), the FullProof bit-identical to driver.prove_fs's."""
    from .. import driver, proof_io
    from ..pc import vpd
    from .sharded_queries import answer_queries_sharded

    comp = compiled or compile_fs_sharded(circuit, mesh)
    cc, bl0, dev = comp["cc"], comp["bl0"], mesh.device
    t0 = time.time()
    inputs = input_buffer(cc, witness, dev)
    values = evaluate(cc, inputs, comp["eval_arrs"])
    l_oracle = comp["commit"](inputs)
    proof, ch, D = comp["gkr"](values, l_oracle.root)
    h_oracle, all_sum, msgs, levels, D = comp["pc"](
        l_oracle.cw, ch.layers[1].r_liu[:, :bl0], D)
    pows = vpd.draw_positions(fs.HostSponge.from_device_state(D), bl0)
    answers, query_size = answer_queries_sharded(pows, bl0, l_oracle,
                                                 h_oracle, levels, mesh)
    full = proof_io.FullProof(
        vres=gf.to_numpy(proof.vres),
        layers=[None] + [driver._layer_proof_arrays(proof.layers[i])
                         for i in range(1, cc.depth)],
        root_l=gf.to_numpy(l_oracle.root),
        root_h=gf.to_numpy(h_oracle.root),
        all_sum=gf.to_numpy(all_sum),
        level_roots=np.stack([gf.to_numpy(o.root) for o in levels]),
        final_codeword=pc_sharded.unstride(gf.to_numpy(
            pc_sharded.gather_strided(levels[-1].cw, mesh)), mesh.sp),
        fft_gkr_messages=[gf.to_numpy(m) for m in msgs],
        queries=answers,
        meta=dict(mode=1, bl0=bl0, depth=cc.depth, mesh_shards=mesh.sp))
    fg_size = fft_gkr.fft_gkr_proof_size(bl0 - virgo_pc.LOG_SLICE)
    info = dict(prove_time=time.time() - t0,
                gkr_proof_size=driver.gkr_proof_size_bytes(cc),
                pc_proof_size=fg_size + query_size + 2 * 32 + 16,
                fft_gkr_ok=True, backend=mesh.backend)
    return full, info
