"""The Virgo++ GKR protocol for unlayered circuits: prover and verifier.

Counterpart of ``virgo_plus_tpu/gkr/protocol.py`` (reference src/prover.cpp,
src/verifier.cpp).  Challenges are a schedule precomputed per circuit shape
(the reference's F::random() stream does not depend on the messages), so
the prover is one feed-forward computation: every phase-1 and Liu table is
initialised in one launch (``inits.py``), folded per table size in one K1
launch, then the phase-2 tables are initialised from the phase-1 claims in
one more launch and folded the same way.

Layer walk (verifier.cpp:134-189): output MLE fold (Vres), then per layer
phase-1 sumcheck over the left input, phase-2 over right inputs grouped by
source layer, a wiring-predicate consistency check, and the Liu
claim-merging sumcheck; the surviving claim about the input layer is
discharged by the polynomial commitment (pc/).
"""

from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import device as _device
from .. import graphs
from ..field import chains, gf
from ..utils.glibc_rand import GlibcRandom
from ..circuits.compile import (G0, CompiledCircuit, coeffs, eval_arrays,
                                evaluate, index)
from . import inits, vchecks
from .beta import beta_table_plain
from .sumcheck import ScatterPlan, scan_sumcheck_batched, tree_sum


# ---------------------------------------------------------------------------
# Challenge schedule (exact draw order of verifier.cpp / fieldElement::random)
# ---------------------------------------------------------------------------

@dataclass
class LayerChallenges:
    r_u: torch.Tensor                 # (2, max_bl)
    assert_r: torch.Tensor            # (2,)
    r_v: Optional[torch.Tensor]       # (2, maxDadBl) or None
    sig: torch.Tensor                 # (2, depth)
    r_liu: torch.Tensor               # (2, max_bl)


@dataclass
class Challenges:
    r_out: torch.Tensor               # (2, bl_last)
    layers: List[Optional[LayerChallenges]]  # index by layer; [0] unused


def _draw(rng: GlibcRandom, n: int) -> np.ndarray:
    vals = np.zeros((2, n), dtype=np.uint64)
    for k in range(n):
        vals[0, k], vals[1, k] = rng.field_element()
    return vals


def make_challenges(cc: CompiledCircuit, rng: Optional[GlibcRandom],
                    device) -> Challenges:
    """Draw order: r_out (bl_last); per layer top..1: r_u (max_bl),
    assert_random (1), r_v (maxDadBl, only if layer has dads), sig (depth),
    r_liu (max_bl).  Matches verifier.cpp:144,196,202,236,278-279."""
    if rng is None:
        rng = GlibcRandom(3396)
    T = lambda a: gf.tensor(a, device)
    depth = cc.depth
    r_out = T(_draw(rng, cc.layers[depth - 1].bit_length))
    layers: List[Optional[LayerChallenges]] = [None] * depth
    for i in range(depth - 1, 0, -1):
        r_u = T(_draw(rng, cc.max_bl))
        assert_r = T(_draw(rng, 1)[:, 0])
        mdb = cc.layers[i].max_dad_bit_length
        r_v = T(_draw(rng, mdb)) if mdb >= 0 else None
        sig = T(_draw(rng, depth))
        r_liu = T(_draw(rng, cc.max_bl))
        layers[i] = LayerChallenges(r_u, assert_r, r_v, sig, r_liu)
    return Challenges(r_out=r_out, layers=layers)


# ---------------------------------------------------------------------------
# Compile-time scatter plans
# ---------------------------------------------------------------------------

@dataclass
class LayerPlans:
    p1: ScatterPlan
    p2: Optional[ScatterPlan]
    # Liu scatter for pre-layer i-1: contributions from consumers j>=i
    liu_consumers: list          # [(j, dad_size, dad_bl, offset)]
    liu_plan: Optional[ScatterPlan]


def _assert_mask(L, device):
    m = np.zeros(1 << L.bit_length, dtype=bool)
    m[:L.size] = L.is_assert
    return torch.from_numpy(m).to(device)


def circuit_arrays(cc: CompiledCircuit, plans, device) -> dict:
    """The per-layer index tensors and coefficient planes (the FS prover;
    the planes are views of the evaluation plan's), the evaluation plan
    ("ev") and the init stages' and the phase-2 combine's plans, made once
    per circuit on the device."""
    arrs = eval_arrays(cc, device)
    ev = arrs["ev"]
    for i in range(1, cc.depth):
        L = cc.layers[i]
        g0 = int(ev.steps[i, G0])
        arrs[f"x{i}"] = index(L.x_idx, device)
        arrs[f"y{i}"] = index(L.y_idx, device)
        arrs[f"co{i}"] = ev.co[..., g0:g0 + L.size]
        if L.has_assert:
            arrs[f"ia{i}"] = _assert_mask(L, device)
        if plans[i].p2 is not None:
            arrs[f"dg{i}"] = index(np.clip(L.dad_gather_idx, 0, None), device)
            arrs[f"dgm{i}"] = torch.from_numpy(
                L.dad_gather_idx >= 0).to(device)
    arrs.update(init_plans(cc, plans, device))
    return arrs


# (id of a compiled circuit, device) -> its init_plans, dropped with the
# circuit: every maker of the same circuit shares one set
_INIT_PLANS: dict = {}


def init_plans(cc: CompiledCircuit, plans, device) -> dict:
    """The init stages' plans ("p1I", and "p2I" with the phase-2 combine's
    "p2C" when a layer has phase-2 tables), made once per circuit and
    device (host numpy, then read-only device tensors).  plans:
    ``build_plans(cc)``."""
    key = (id(cc), str(device))
    if key not in _INIT_PLANS:
        p1_groups, p2_groups = _groups(cc)
        out = {"p1I": inits.p1_plan(cc, plans, p1_groups, device)}
        p2 = inits.p2_plan(cc, plans, p2_groups, device)
        if p2 is not None:
            out.update(p2I=p2, p2C=p2_combine_plan(cc, device))
        _INIT_PLANS[key] = out
        weakref.finalize(cc, _INIT_PLANS.pop, key, None)
    return dict(_INIT_PLANS[key])


def build_plans(cc: CompiledCircuit) -> List[Optional[LayerPlans]]:
    src = cc.source
    plans: List[Optional[LayerPlans]] = [None] * cc.depth
    for i in range(1, cc.depth):
        L = cc.layers[i]
        pre_padded = cc.layers[i - 1].padded
        p1 = ScatterPlan.build(np.asarray(L.x_idx), pre_padded)
        p2 = None
        if L.max_dad_bit_length >= 0:
            p2 = ScatterPlan.build(np.asarray(L.p2_flat_idx),
                                   L.dad_padded_total)
        # Liu for pre layer i-1: consumers j in [i, depth)
        consumers = []
        idx_parts = []
        off = 0
        for j in range(i, cc.depth):
            Lj = src.layers[j]
            ds = Lj.dad_size[i - 1] if i - 1 < len(Lj.dad_size) else 0
            if ds > 0:
                consumers.append((j, ds, Lj.dad_bit_length[i - 1], off))
                idx_parts.append(Lj.dad_id[i - 1])
                off += ds
        liu_plan = None
        if idx_parts:
            liu_plan = ScatterPlan.build(np.concatenate(idx_parts), pre_padded)
        plans[i] = LayerPlans(p1=p1, p2=p2, liu_consumers=consumers,
                              liu_plan=liu_plan)
    return plans


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

@dataclass
class LayerProof:
    p1_polys: torch.Tensor              # (bl_prev, 2, 3)
    claim_u: torch.Tensor               # (2,)
    p2_polys: Optional[torch.Tensor]    # (maxDadBl, 2, 3)
    claims_v: Optional[torch.Tensor]    # (i, 2) one claim per source layer
    liu_polys: torch.Tensor             # (bl_prev, 2, 3)
    liu_claim: torch.Tensor             # (2,)


@dataclass
class Proof:
    vres: torch.Tensor                  # (2,)
    layers: List[Optional[LayerProof]]


def _values_block(cc, values, i):
    off = int(cc.value_off[i])
    return values[..., off:off + cc.layers[i].padded]


def _scale_beta_asserts(cc, i, bg, assert_r, mask, mul=gf.mul):
    """Multiply the assert gates' beta entries by assert_r."""
    if not cc.layers[i].has_assert:
        return bg
    return torch.where(mask[None, :], mul(bg, assert_r[:, None]), bg)


def _lead_first(t, axis: int, n_lead: int):
    """Move the `n_lead` batch axes that start at `axis` to the front."""
    if not n_lead:
        return t
    return t.movedim(tuple(range(axis, axis + n_lead)), tuple(range(n_lead)))


def _groups(cc):
    """Static fold groups: which tables fold together per size."""
    p1_groups = {}
    for i in range(cc.depth - 1, 0, -1):
        p1_groups.setdefault(cc.layers[i - 1].bit_length, []).append(i)
    p2_groups = {}
    for i in range(cc.depth - 1, 0, -1):
        L = cc.layers[i]
        if L.max_dad_bit_length < 0:
            continue
        for li in range(i):
            if L.dad_sizes[li] > 0:
                p2_groups.setdefault(L.dad_bls[li], []).append((i, li))
    return p1_groups, p2_groups


def prove(cc: CompiledCircuit, plans, values, ch: Challenges, arrs) -> Proof:
    """Full GKR proof.  All sumchecks of one table size fold in one K1
    launch: layers are independent once the challenge schedule is fixed,
    so the messages are the same as a per-layer walk's.

    values (2, T) gives one proof; a batch (2, B, T) of witnesses of the
    same circuit, proved under the same challenges, gives one Proof whose
    arrays carry the batch first (vres (B, 2), p1_polys (B, bl, 2, 3), ...),
    with each batch's tables folded as more tables of the same K1 calls.
    Four stages, which make_prover(staged=True) replays as four graphs."""
    vres, p1_stacked, liu_stacked = _prove_inits(cc, plans, values, ch, arrs)
    p1_res, liu_res = _prove_folds(cc, p1_stacked, liu_stacked)
    p2_stacked = _prove_p2_inits(cc, plans, values, ch, _claims(p1_res), arrs)
    p2_out = _prove_p2(ch, p2_stacked, tuple(values.shape[1:-1]),
                       arrs.get("p2C"))
    return _assemble(cc, vres, p1_res, liu_res, p2_out, values.dim() - 2)


def _claims(p1_res):
    return {i: res[1] for i, res in p1_res.items()}


def _prove_folds(cc, p1_stacked, liu_stacked):
    """Every phase-1 and Liu fold.  Both kinds of table are ready after
    the inits, so the same-size jobs of both phases merge into one K1
    launch.  Returns (p1_res, liu_res), each {layer: (polys, bound v)}."""
    p1_groups, _ = _groups(cc)
    m_stacked, m_groups = {}, {}
    for bl in sorted(set(p1_stacked) | set(liu_stacked)):
        parts, tags = [], []
        if bl in p1_stacked:
            parts.append(p1_stacked[bl])
            tags += [("p1", i) for i in p1_groups[bl]]
        if bl in liu_stacked:
            parts.append(liu_stacked[bl])
            tags += [("liu", i) for i in p1_groups[bl]]
        m_stacked[bl] = tuple(torch.cat([p[k] for p in parts], dim=-2)
                              for k in range(4))
        m_groups[bl] = tags
    m_res = _apply_grouped(m_stacked, m_groups)
    p1_res = {i: m_res[("p1", i)] for bl in p1_stacked
              for i in p1_groups[bl]}
    liu_res = {i: m_res[("liu", i)] for bl in liu_stacked
               for i in p1_groups[bl]}
    return p1_res, liu_res


def _prove_p2(ch, p2_stacked, lead, plan):
    """The phase-2 folds, one K1 launch per table size, and the combine
    into per-layer messages and claims.  lead: the batch shape; plan: the
    circuit's ``p2_combine_plan``."""
    if not p2_stacked:
        return {}
    return _p2_combine(ch, [_fold_stacked(*job) for _, job in
                            sorted(p2_stacked.items())], lead, plan)


def _assemble(cc, vres, p1_res, liu_res, p2_out, n_lead) -> Proof:
    """The Proof of the stages' results, batch axes first."""
    lead = lambda t, axis: None if t is None else _lead_first(t, axis, n_lead)
    layer_proofs: List[Optional[LayerProof]] = [None] * cc.depth
    for i in range(cc.depth - 1, 0, -1):
        p2_polys, claims_v = p2_out.get(i, (None, None))
        layer_proofs[i] = LayerProof(
            p1_polys=lead(p1_res[i][0], 2), claim_u=lead(p1_res[i][1], 1),
            p2_polys=lead(p2_polys, 2), claims_v=lead(claims_v, 2),
            liu_polys=lead(liu_res[i][0], 2),
            liu_claim=lead(liu_res[i][1], 1))
    return Proof(vres=lead(vres, 1), layers=layer_proofs)


def make_prover(cc: CompiledCircuit, plans, device=None, staged=True,
                graphed=True):
    """Returns prove(values, ch) -> Proof, equal to ``prove`` bit for bit,
    replayed as graphs (graphs.py) with the circuit's tables made here.
    staged=True keeps the JAX package's stage boundaries, so that each
    stage's device time can be read apart (chip_smoke.py times each stage's
    replay): the inits, the merged phase-1 and Liu folds, the phase-2
    inits, and the phase-2 folds with the combine, four graphs replayed in
    order, each stage's outputs copied into the next one's buffers.
    staged=False: one graph of ``prove``, as the driver uses it.
    graphed=False: ``prove`` itself, eager."""
    dev = _device.resolve(device)
    arrs = circuit_arrays(cc, plans, dev)
    if not (staged and graphed):
        return graphs.program(
            lambda values, ch: prove(cc, plans, values, ch, arrs), dev,
            "prover", graphed)

    inits = graphs.Graphed(
        lambda values, ch: _prove_inits(cc, plans, values, ch, arrs), dev,
        "prover inits")
    folds = graphs.Graphed(
        lambda p1_stacked, liu_stacked: _prove_folds(cc, p1_stacked,
                                                     liu_stacked),
        dev, "prover p1+liu folds")
    p2_inits = graphs.Graphed(
        lambda values, ch, claims: _prove_p2_inits(cc, plans, values, ch,
                                                   claims, arrs),
        dev, "prover p2 inits")
    p2 = graphs.Graphed(
        lambda ch, p2_stacked, lead: _prove_p2(ch, p2_stacked, lead,
                                               arrs.get("p2C")),
        dev, "prover p2 folds+combine")
    has_p2 = "p2I" in arrs

    def run(values, ch):
        vres, p1_stacked, liu_stacked = inits.call((values, ch), False)
        p1_res, liu_res = folds.call((p1_stacked, liu_stacked), False)
        p2_out = {}
        if has_p2:
            p2_stacked = p2_inits.call((values, ch, _claims(p1_res)), False)
            p2_out = p2.call((ch, p2_stacked, tuple(values.shape[1:-1])),
                             False)
        return graphs.clone(_assemble(cc, vres, p1_res, liu_res, p2_out,
                                      values.dim() - 2))

    run.graphs = (inits, folds, p2_inits, p2)
    return run


def make_evaluator(cc: CompiledCircuit, device=None, graphed=True):
    """Returns evaluate(inputs) -> the circuit's values, as one graph of
    ``circuits.compile.evaluate`` with its tables made here (eager for
    graphed=False)."""
    dev = _device.resolve(device)
    arrs = eval_arrays(cc, dev)
    return graphs.program(lambda inputs: evaluate(cc, inputs, arrs), dev,
                          "evaluator", graphed)


def _unstack(raw, groups):
    """raw: {bl: (polys (bl, 2, ..., K, 3), (vb, ab, mb) each (2, ..., K))}
    batched fold outputs; groups: {bl: [tag, ...]} table order.  Returns
    {tag: (polys, vb)}."""
    out = {}
    for bl, (polys, (vb, _ab, _mb)) in sorted(raw.items()):
        for kk, tag in enumerate(groups[bl]):
            out[tag] = (polys[..., kk, :], vb[..., kk])
    return out


def _fold_stacked(v, a, m, rs):
    """One K1 call on stacked jobs: v, a, m (2, ..., K, 2^bl), rs (2, K, bl)
    shared by the middle (batch) axes, which fold as more tables.  Returns
    (polys (bl, 2, ..., K, 3), bound (v, a, m) each (2, ..., K))."""
    lead = v.shape[1:-2]
    k, n = v.shape[-2:]
    bl = rs.shape[-1]
    nk = math.prod(lead) * k
    rs = rs.reshape((2,) + (1,) * len(lead) + (k, bl)).expand(
        (2,) + lead + (k, bl))
    polys, bound = scan_sumcheck_batched(
        v.reshape(2, nk, n), a.reshape(2, nk, n), m.reshape(2, nk, n),
        rs.reshape(2, nk, bl))
    polys = polys.reshape((bl,) + lead + (k, 2, 3)).movedim(-2, 1)
    return polys, tuple(b.reshape((2,) + lead + (k,)) for b in bound)


def _apply_grouped(stacked, groups):
    """Fold every table size as its own K1 launch (K tables each, times the
    batch)."""
    raw = {bl: _fold_stacked(*job) for bl, job in sorted(stacked.items())}
    return _unstack(raw, groups)


def _r_cur(cc, ch, i):
    return (ch.r_out if i == cc.depth - 1
            else ch.layers[i + 1].r_liu[:, :cc.layers[i].bit_length])


def _prove_inits(cc, plans, values, ch, arrs):
    """vres and every layer's phase-1 and Liu tables, {bl: (v, a, m, rs)}
    each, the tables (2, *lead, K, 2^bl) in ``_groups``' order: the beta
    tables (shared by a batch), vres as the top values block against the
    top layer's bg table (one product, one sum: ``mle_fold``'s bits), and
    one ``inits.p1_inits`` call."""
    plan = arrs["p1I"]
    c0 = inits.challenge_buffer(plan, ch)
    betas = inits.beta_tables(plan, c0)
    top = inits.beta_table(plan, betas, ("bg", cc.depth - 1))
    vres = tree_sum(gf.mul(_values_block(cc, values, cc.depth - 1), top))
    out = inits.p1_inits(plan, values, c0, betas)
    return (vres,) + inits.p1_views(plan, out, tuple(values.shape[1:-1]))


def _prove_p2_inits(cc, plans, values, ch, claims, arrs):
    """Every phase-2 table, {bl: (vdad, addV, multV, rs)} (they need the
    phase-1 claims {layer: (2, *lead)}): the beta tables and one
    ``inits.p2_inits`` call."""
    plan = arrs.get("p2I")
    if plan is None:
        return {}
    c0 = inits.challenge_buffer(plan, ch, claims)
    out = inits.p2_inits(plan, values, c0, inits.beta_tables(plan, c0))
    return inits.p2_views(plan, out, tuple(values.shape[1:-1]))


@dataclass
class P2CombinePlan:
    """The index tensors of the phase-2 combine (``_p2_combine``), made
    once per circuit (``p2_combine_plan``).  The phase-2 tables are numbered
    in fold order (table size, then ``_groups``' order); their round
    polynomials lie term-major in one buffer, group by group, round j of
    table k of a group of K at the group's base + j K + k.  The messages
    lie on a grid of (layer, round) slots, ``rounds`` a layer.  Each plan
    is a ``chains.segsum`` plan (idx, starts, ends)."""
    layers: List[int]       # the layers with phase-2 messages, top down
    mdb: List[int]          # their max_dad_bit_length
    rounds: int             # the grid's rounds a layer: the largest mdb
    first_add: Optional[int]  # the first round with a bound term, if any
    polys: tuple    # slot (l, j): round j of the layer's tables of bl > j
    add: tuple      # slot (l, j): the layer's tables of bl == j < mdb
    rv: tuple       # slot (l, j): r_v[j] of the layer (j < mdb), from the
                    # r_v's side by side
    claims: tuple   # (i, li) in order: the table of (i, li), or none


def _segsum_plan(segments, device):
    """A chains.segsum plan (idx, starts, ends) of lists of terms."""
    lens = np.array([len(s) for s in segments], dtype=np.int64)
    ends = np.cumsum(lens)
    idx = np.array([t for s in segments for t in s], dtype=np.int64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (idx, ends - lens, ends))


def p2_combine_plan(cc, device) -> Optional[P2CombinePlan]:
    """The phase-2 combine's plan, None without phase-2 layers."""
    _, p2_groups = _groups(cc)
    layers = [i for i in range(cc.depth - 1, 0, -1)
              if cc.layers[i].max_dad_bit_length >= 0]
    if not layers:
        return None
    mdb = [cc.layers[i].max_dad_bit_length for i in layers]
    rounds = max(mdb)
    where = {}     # (i, li) -> (table number, first term, term step)
    q = base = 0
    for bl, tags in sorted(p2_groups.items()):
        for k, tag in enumerate(tags):
            where[tag] = (q + k, base + k, len(tags))
        q += len(tags)
        base += bl * len(tags)
    polys, add, rv, claims = [], [], [], []
    rv_off = 0
    for i, m in zip(layers, mdb):
        L = cc.layers[i]
        tabs = [(where[(i, li)], L.dad_bls[li]) for li in range(i)
                if L.dad_sizes[li] > 0]
        for j in range(rounds):
            polys.append([t0 + j * step for (_, t0, step), bl in tabs
                          if j < bl])
            add.append([q for (q, _, _), bl in tabs if bl == j < m])
            rv.append([rv_off + j] if j < m else [])
        rv_off += m
        claims += [[where[(i, li)][0]] if L.dad_sizes[li] > 0 else []
                   for li in range(i)]
    first_add = min((k % rounds for k, seg in enumerate(add) if seg),
                    default=None)
    return P2CombinePlan(
        layers=layers, mdb=mdb, rounds=rounds, first_add=first_add,
        **{k: _segsum_plan(v, device) for k, v in
           (("polys", polys), ("add", add), ("rv", rv), ("claims", claims))})


def _prove_p2_combine(cc, ch, p2_res, lead):
    """Per-layer phase-2 round messages + add_term chain + claims from the
    folds' results {(i, li): (polys (bl, 2, *lead, 3), (vb, ab, mb) each
    (2, *lead))} (JAX ``_prove_p2_combine``'s form, which the sharded
    prover hands in); every per-layer scalar is (2, *lead) for a batch of
    shape `lead`.  Stacks the results as the folds give them and runs
    ``_p2_combine``."""
    plan = p2_combine_plan(cc, ch.r_out.device)
    if plan is None:
        return {}
    _, p2_groups = _groups(cc)
    groups = [(torch.stack([p2_res[t][0] for t in tags], dim=-2),
               tuple(torch.stack([p2_res[t][1][k] for t in tags], dim=-1)
                     for k in range(3)))
              for _, tags in sorted(p2_groups.items())]
    return _p2_combine(ch, groups, lead, plan)


def _p2_combine(ch, groups, lead, plan):
    """The phase-2 messages and claims of every layer at once: groups, one
    per table size in fold order, of (polys (bl, 2, *lead, K, 3), (vb, ab,
    mb) each (2, *lead, K)).  Per layer l and round j < mdb the message is
    the sum of round j of its tables with bl > j, plus [0, -a_j, a_j] where
    a_j = a_{j-1} (1 - r_v[j-1]) + the sum of vb mb + ab over its tables
    with bl == j (a_{-1} = 0); claim li of layer i is the vb of table
    (i, li), or 0.  Segment sums over the circuit's plan do the sums, the
    recurrence runs over j for all layers together, and a circuit with no
    bound term below its layers' mdb (a = 0) skips it."""
    n_lead = len(lead)
    n_layers, rounds = len(plan.layers), plan.rounds
    # the round polynomials, term-major (T, *lead, 2, 3), read as
    # (2, *lead, 3, T): free of copies for lead ()
    terms = torch.cat([p.movedim(1, -2).movedim(n_lead + 1, 1)
                       .reshape((-1,) + lead + (2, 3)) for p, _ in groups])
    sums = chains.segsum(terms.permute(n_lead + 1, *range(1, n_lead + 1),
                                       n_lead + 2, 0), plan.polys)
    vb = torch.cat([b[0] for _, b in groups], dim=-1)       # (2, *lead, Q)
    claims = chains.segsum(vb, plan.claims)
    if plan.first_add is None:
        msgs = sums
    else:
        dev = vb.device
        e = gf.add(gf.mul(vb, torch.cat([b[2] for _, b in groups], dim=-1)),
                   torch.cat([b[1] for _, b in groups], dim=-1))
        e = chains.segsum(e, plan.add).reshape(
            (2,) + lead + (n_layers, rounds))
        rv = torch.cat([ch.layers[i].r_v[:, :m]
                        for i, m in zip(plan.layers, plan.mdb)], dim=1)
        c = gf.sub(gf.ones((1,), dev), chains.segsum(rv, plan.rv)).reshape(
            (2,) + (1,) * n_lead + (n_layers, rounds))
        first = plan.first_add
        a = e[..., first]
        cols = [torch.zeros_like(a)] * first + [a]
        for j in range(first + 1, rounds):
            a = gf.add(gf.mul(a, c[..., j - 1]), e[..., j])
            cols.append(a)
        a = torch.stack(cols, dim=-1).reshape(
            (2,) + lead + (n_layers * rounds,))
        msgs = gf.add(sums, torch.stack([torch.zeros_like(a), gf.neg(a), a],
                                        dim=-2))
    msgs = msgs.reshape((2,) + lead + (3, n_layers, rounds))
    p2_out = {}
    off = 0
    for l, (i, m) in enumerate(zip(plan.layers, plan.mdb)):
        p2_out[i] = (msgs[..., l, :m].movedim(-1, 0),
                     claims[..., off:off + i].movedim(-1, 0))
        off += i
    return p2_out


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

# The layer walk below is the verifier entries' plain twin (``vchecks``):
# on a card every verifier program is one entry launch, so the walk runs
# ``gf``'s plain ops (and the plain beta tables and tree sums) on any
# device, launching no kernel of its own.
_add, _mul = gf.add_plain, gf.mul_plain


def _check_round_chain(polys, rs, previous_sum):
    """Check p_j(0)+p_j(1) == prev and chain prev = p_j(r_j): p(0) + p(1)
    = a + b + 2c (``sumcheck.quad_at_0_plus_1``), p(r) by Horner
    (``eval_quad``).  Returns (ok (bool tensor), final previous_sum)."""
    ok = torch.ones((), dtype=torch.bool, device=previous_sum.device)
    for j in range(polys.shape[0]):
        a, b, c = polys[j, :, 0], polys[j, :, 1], polys[j, :, 2]
        ok = ok & torch.all(_add(_add(a, b), _add(c, c)) == previous_sum)
        r = rs[:, j]
        previous_sum = _add(_mul(_add(_mul(a, r), b), r), c)
    return ok, previous_sum


def verifier_arrays(cc: CompiledCircuit, device) -> dict:
    """Per-layer index/coefficient tensors the verifier needs."""
    src = cc.source
    arrs = {}
    for i in range(1, cc.depth):
        L = cc.layers[i]
        arrs[f"vx{i}"] = index(L.x_idx, device)
        arrs[f"vco{i}"] = gf.tensor(L.coeff, device)
        if L.has_assert:
            arrs[f"via{i}"] = _assert_mask(L, device)
        if L.max_dad_bit_length >= 0:
            ls = np.asarray(src.layers[i].l)
            arrs[f"vlv{i}"] = index(
                np.where(ls < 0, 0, np.asarray(src.layers[i].lv)), device)
            arrs[f"vsl{i}"] = index(np.where(ls < 0, i - 1, ls), device)
    for j in range(1, cc.depth):
        Lj = src.layers[j]
        for i1 in range(len(Lj.dad_size)):
            if Lj.dad_size[i1] > 0:
                arrs[f"vdad{j}_{i1}"] = index(Lj.dad_id[i1], device)
    return arrs


def predicate_check(cc: CompiledCircuit, i: int, lp: LayerProof,
                    r_cur, ch: LayerChallenges, previous_sum_mid,
                    varrs: dict):
    """The O(#gates) wiring-predicate sweep (verifier.cpp:63-132, 160-166):
    the reference's "slow" verifier cost (verify_slow_timer).  It consumes
    the previousSum reached after the phase-2 rounds and yields a bool."""
    L = cc.layers[i]
    bl_prev = cc.layers[i - 1].bit_length
    dev = r_cur.device
    one = gf.ones((), dev)
    mul, add = _mul, _add

    bg = beta_table_plain(r_cur, L.bit_length, one)
    bg = _scale_beta_asserts(cc, i, bg, ch.assert_r,
                             varrs.get(f"via{i}"), mul)[:, :L.size]
    bu = beta_table_plain(ch.r_u[:, :bl_prev], bl_prev, one)
    w = mul(bg, bu[:, varrs[f"vx{i}"]])
    if L.max_dad_bit_length >= 0:
        bv = beta_table_plain(ch.r_v[:, :L.max_dad_bit_length],
                              L.max_dad_bit_length, one)
        w = mul(w, bv[:, varrs[f"vlv{i}"]])
    cu = lp.claim_u[:, None]
    if lp.claims_v is not None and lp.claims_v.shape[0] > 0:
        cv = lp.claims_v.t()[:, varrs[f"vsl{i}"]]
    else:
        cv = gf.zeros((L.size,), dev)
    A, B, C, D = varrs[f"vco{i}"]
    gate_val = add(add(mul(A, cu), mul(B, cv)),
                   add(mul(C, mul(cu, cv)), D))
    test_value = chains.tree_sum_plain(mul(w, gate_val))
    return torch.all(test_value == previous_sum_mid)


def verify_layer_fast(cc: CompiledCircuit, i: int, lp: LayerProof,
                      r_cur, ch: LayerChallenges, previous_sum,
                      proof: Proof, ch_all: Challenges, varrs: dict):
    """The succinct half of one layer's verification: round chains + Liu
    (verifier.cpp:191-337 minus the predicate sweeps).  Returns
    (ok, previous_sum_mid, new_sum)."""
    L = cc.layers[i]
    src = cc.source
    bl_prev = cc.layers[i - 1].bit_length
    dev = r_cur.device
    one = gf.ones((), dev)
    mul, add = _mul, _add

    # phase 1 round checks
    ok1, previous_sum = _check_round_chain(lp.p1_polys,
                                           ch.r_u[:, :bl_prev], previous_sum)
    # phase 2 round checks
    ok2 = torch.ones((), dtype=torch.bool, device=dev)
    if L.max_dad_bit_length >= 0:
        ok2, previous_sum = _check_round_chain(
            lp.p2_polys, ch.r_v[:, :L.max_dad_bit_length], previous_sum)
    previous_sum_mid = previous_sum

    # Liu phase (verifier.cpp:272-337)
    sig = ch.sig
    liu_sum = mul(sig[:, 0], lp.claim_u)
    for j in range(i, cc.depth):
        # claims about layer i-1 pending from higher layers (incl. this one)
        lp_j = proof.layers[j]
        if lp_j.claims_v is not None and lp_j.claims_v.shape[0] > i - 1:
            liu_sum = add(liu_sum, mul(sig[:, j - i + 1],
                                       lp_j.claims_v[i - 1]))
    ok4, previous_sum = _check_round_chain(lp.liu_polys,
                                           ch.r_liu[:, :bl_prev], liu_sum)
    # gr computation
    bu_liu = beta_table_plain(ch.r_liu[:, :bl_prev], bl_prev, one)
    bsig = beta_table_plain(ch.r_u[:, :bl_prev], bl_prev, sig[:, 0])
    pre_size = cc.layers[i - 1].size
    gr = chains.tree_sum_plain(mul(bsig[:, :pre_size],
                                   bu_liu[:, :pre_size]))
    for j in range(i, cc.depth):
        Lj = src.layers[j]
        ds = Lj.dad_size[i - 1] if i - 1 < len(Lj.dad_size) else 0
        if ds == 0:
            continue
        bl_jl = Lj.dad_bit_length[i - 1]
        bt = beta_table_plain(ch_all.layers[j].r_v[:, :bl_jl], bl_jl,
                              sig[:, j - i + 1])
        gathered = bu_liu[:, varrs[f"vdad{j}_{i - 1}"]]
        gr = add(gr, chains.tree_sum_plain(mul(bt[:, :ds], gathered)))
    ok5 = torch.all(mul(lp.liu_claim, gr) == previous_sum)
    return ok1 & ok2 & ok4 & ok5, previous_sum_mid, lp.liu_claim


def verify_layer(cc: CompiledCircuit, i: int, lp: LayerProof, r_cur,
                 ch: LayerChallenges, previous_sum, proof: Proof,
                 ch_all: Challenges, varrs: dict):
    """verifier.cpp:191-337 for one layer: the succinct checks and the
    predicate sweep.  Returns (ok (bool tensor), new_sum)."""
    ok_fast, mid, new_sum = verify_layer_fast(cc, i, lp, r_cur, ch,
                                              previous_sum, proof, ch_all,
                                              varrs)
    ok_slow = predicate_check(cc, i, lp, r_cur, ch, mid, varrs)
    return ok_fast & ok_slow, new_sum


def _output_ok(proof, ch, output_values):
    """vres against the claimed output block's MLE (``mle_fold``'s table,
    product and sum), when one is given."""
    dev = proof.vres.device
    ok = torch.ones((), dtype=torch.bool, device=dev)
    if output_values is not None:
        k = ch.r_out.shape[1]
        beta = beta_table_plain(ch.r_out, k, gf.ones((), dev))
        folded = chains.tree_sum_plain(_mul(output_values[..., :1 << k],
                                            beta))
        ok = ok & torch.all(folded == proof.vres)
    return ok


def verify(cc: CompiledCircuit, proof: Proof, ch: Challenges,
           output_values=None, varrs: Optional[dict] = None):
    """Full GKR verification (without the polynomial commitment): every
    layer's succinct checks, then every layer's predicate sweep on their
    mids (``_verify_fast_all``, ``_verify_slow_all``: on a CUDA proof one
    verifier entry each), the same checks as ``verify_layer`` layer by
    layer.  output_values: optional (2, 2^bl_last) claimed output block to
    check vres against; varrs: verifier_arrays (made here on the proof's
    device when None).  Returns (ok (bool tensor), final_claim,
    final_point): the surviving claim V_input(final_point) == final_claim
    for the PC opening."""
    if varrs is None:
        varrs = verifier_arrays(cc, proof.vres.device)
    ok, mids, previous_sum, r_cur = _verify_fast_all(cc, proof, ch,
                                                     output_values, varrs)
    return (ok & _verify_slow_all(cc, proof, ch, mids, varrs), previous_sum,
            r_cur)


def _verify_fast_all(cc, proof, ch, output_values, varrs):
    """All layers' succinct checks.  The previousSum entering layer i is
    the upper layer's Liu claim (proof data), so no layer waits on another:
    on a CUDA proof one gkr_verify_fast launch, on a CPU proof its plain
    twin (``vchecks``).  Returns (ok, mids, final_claim, final_point)."""
    return vchecks.verify_fast(vchecks.plan(cc, varrs, proof.vres.device),
                               proof, ch, output_values)


def _verify_slow_all(cc, proof, ch, mids, varrs):
    """All layers' O(#gates) wiring-predicate sweeps (the reference's
    verify_slow_timer half): on a CUDA proof one gkr_verify_slow launch,
    on a CPU proof its plain twin."""
    return vchecks.verify_slow(vchecks.plan(cc, varrs, proof.vres.device),
                               proof, ch, mids)


def make_verifier(cc: CompiledCircuit, device=None, staged=True,
                  graphed=True):
    """Returns verify(proof, challenges, output_values=None) ->
    (ok: bool, final_claim, final_point), with the verifier's tables made
    here.  staged=True: the succinct checks, then (if they hold) the
    predicate sweeps, as two programs with the device read of ``ok``
    between them, keeping the reference's fast/slow split
    (verifier.cpp:180, verifier.h:45-46) as the JAX package's ``fast_all``
    (``fast_all_out`` with an output block) and ``slow_all``.
    staged=False: one program of ``verify``.  Each program is a graph per
    argument shape (graphs.py; a proof's None fields are part of its
    shape), or eager for graphed=False.  On a card a program's field work
    is one verifier entry a program (two for ``verify``), over the
    circuit's ``vchecks`` plan, made here.  After each call
    ``run.last_split`` holds (fast_seconds, slow_seconds); unstaged, all
    of it counts as fast."""
    dev = _device.resolve(device)
    varrs = verifier_arrays(cc, dev)
    vchecks.plan(cc, varrs, dev)
    if not staged:
        whole = graphs.program(
            lambda proof, ch, out: verify(cc, proof, ch, out, varrs), dev,
            "verifier", graphed)

        def run(proof, ch, output_values=None):
            t0 = time.perf_counter()
            ok, previous_sum, r_cur = whole(proof, ch, output_values)
            ok = bool(ok)                  # waits for the device
            run.last_split = (time.perf_counter() - t0, 0.0)
            return ok, previous_sum, r_cur

        run.graphs = (whole,)
        run.last_split = (0.0, 0.0)
        return run

    fast = graphs.program(
        lambda proof, ch: _verify_fast_all(cc, proof, ch, None, varrs), dev,
        "verifier fast_all", graphed)
    fast_out = graphs.program(
        lambda proof, ch, out: _verify_fast_all(cc, proof, ch, out, varrs),
        dev, "verifier fast_all_out", graphed)
    slow = graphs.program(
        lambda proof, ch, mids: _verify_slow_all(cc, proof, ch, mids, varrs),
        dev, "verifier slow_all", graphed)

    def run(proof, ch, output_values=None):
        t0 = time.perf_counter()
        ok, mids, previous_sum, r_cur = (
            fast(proof, ch) if output_values is None
            else fast_out(proof, ch, output_values))
        ok = bool(ok)                      # waits for the device
        t_fast = time.perf_counter() - t0
        ok = ok and bool(slow(proof, ch, mids))
        run.last_split = (t_fast, time.perf_counter() - t0 - t_fast)
        return ok, previous_sum, r_cur

    run.graphs = (fast, fast_out, slow)
    run.last_split = (0.0, 0.0)
    return run
