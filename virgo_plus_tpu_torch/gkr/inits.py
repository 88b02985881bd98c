"""The GKR table inits: every layer's phase-1 and Liu tables, then every
phase-2 table, one kernel launch a stage.

Counterpart of the stage programs ``_prove_inits`` and ``_prove_p2_inits``
of ``virgo_plus_tpu/gkr/protocol.py`` (:698, :784), whose per-layer
gathers, gate products, fused gate scatter and table stacks XLA fuses
inside the staged jits.  ``protocol.circuit_arrays`` makes one plan per
stage and circuit (``p1_plan``, ``p2_plan``: host numpy, then tensors on
the device), and a stage is

* ``challenge_buffer``: one ``torch.cat`` of the challenge vectors the
  stage reads (and, for phase 2, the phase-1 claims) into ``c0`` (2, NC);
* ``beta_tables``: one gather of the beta tables' challenges and inits
  out of ``c0``, then one ``beta.beta_tables_batched`` call per table
  size;
* ``p1_inits`` / ``p2_inits``: on a CUDA tensor one launch of
  ``gkr_p1_inits`` / ``gkr_p2_inits`` (``csrc/gkr_inits.cu``), on a CPU
  tensor the plain twin (``p1_inits_plain``, ``p2_inits_plain``: gathers,
  ``gf``'s plain ops and prefix sums), which counts
  ``kernels.PLAIN_CALLS``.  Either writes one flat buffer, which
  ``p1_views`` / ``p2_views`` cut without a copy into the stacked tables
  the sumchecks read: per table size, (2, *lead, K, 2^bl) arrays and the
  (2, K, bl) round challenges, the tables in ``protocol._groups``' order.

What a stage computes, for values (2, *lead, T) (R = prod(lead) rows; the
challenges and the tables built from them are shared by the rows):

* phase 1, layer i, slot s of layer i - 1: the tables (v, a, m) and the Liu
  tables (v, 0, m') with v = layer i - 1's values block,
  a[s] = sum_{g: x(g) = s} bg'(g) (B_g y_g + D_g),
  m[s] = sum_{g: x(g) = s} bg'(g) (A_g + C_g y_g), y_g = values[y(g)],
  bg'(g) = bg_i(g), times assert_r on an assert gate, and
  m'[s] = bsig_i(s) [s < size(i - 1)] + sum of the Liu consumers' bt_ij(k)
  with dad_id_j(k) = s;
* phase 2, table (i, li), slot s: vdad[s] = values[dg(s)] (0 on padding),
  addV[s] = sum_{g: p2(g) = s} bg'(g) bu_i(x(g)) (A_g cu_i + D_g),
  multV[s] = sum_{g: p2(g) = s} bg'(g) bu_i(x(g)) (B_g + C_g cu_i), cu_i
  layer i's phase-1 claim of the row;
* and both, the stacked round challenges (2, K, bl) of each table size.

The plan holds each stage's terms sorted by destination slot, as
``ScatterPlan`` does, with the static data a term reads (its coefficient
words, its y or x index, its gate's beta entry and assert bit) permuted
into term order.  Each slot belongs to a summer class fixed in the plan: a
thread slot (at most ``THREAD_MAX`` terms, the plan's ``thread_max``), a
warp (at most ``WARP_MAX``) or a block.  The kernel sums the thread slots
32 to a warp, which it finds by their counts, and the others from
``lists``.  Field arithmetic is exact and every result canonical, so the
kernel, the twin and the JAX package give the same bits (the kernel
regroups a slot's sums by field identities, ``csrc/gkr_inits.cu``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..field import chains, gf
from .beta import beta_tables_batched

# a slot's summer: a thread, a warp or a block, by its longest term list
THREAD, WARP, BLOCK = range(3)
THREAD_MAX, WARP_MAX = 16, 512
MAX_BETA_GROUPS = 32     # csrc/gkr_inits.cu: beta tables by value
REF_SHIFT = 40           # a beta reference: group << REF_SHIFT | word offset
ASSERT_BIT = 1 << 31     # a term's gate word: gate | ASSERT_BIT on an assert
# a table's record (int64 fields, csrc/gkr_inits.cu): its first slot, its
# output group's word base W and K n, its offset k n in the group, its
# values block (phase 1), the previous layer's size (phase 1), the beta
# references of bg and of bsig (phase 1) or bu (phase 2), the c0 column of
# assert_r (-1: none) and its layer's place among the claims (phase 2)
(T_SLOT, T_GBASE, T_KN, T_KOFF, T_VOFF, T_SIZE, T_BG, T_B2, T_ASSERT,
 T_CLAIM) = range(10)
TAB_FIELDS = 10
WORDS = {1: 6, 2: 3}     # output arrays a group: (v, a, m, v, 0, m'); (vdad, addV, multV)
ENTRY = {1: "gkr_p1_inits", 2: "gkr_p2_inits"}


@dataclass
class InitPlan:
    """One stage's plan (see the module docstring); device tensors and the
    host numbers that shape the call."""
    stage: int
    groups: list        # [(bl, [table tag])] output groups, ``_groups`` order
    gbase: list         # per group: the words K n of the groups before it
    w_total: int
    rs_off: list        # per group: its stacked challenges in the rs region
    rs_words: int
    chal: list          # c0's static pieces [(key, width)]
    nc_static: int
    claim_layers: list  # phase 2: the layers whose claims close c0
    betas: list         # [(bl, [beta tag])] a chains.table call each
    beta_pos: dict      # beta tag -> (group, table)
    beta_off: list      # per beta group: its r block and init block in the gather
    n_slots: int
    n_terms: int
    n_liu: int
    classes: tuple      # slots a class: (thread, warp, block)
    thread_max: int     # a thread slot's most terms (THREAD_MAX)
    one: torch.Tensor       # (2, 1): the element 1
    gather: torch.Tensor    # int64: the beta inputs' c0 columns
    tab: torch.Tensor       # int64 (tables, TAB_FIELDS)
    slot_tab: torch.Tensor  # int32 (Q,)
    starts: torch.Tensor    # int32 (Q + 1,)
    liu_starts: torch.Tensor  # int32 (Q + 1,), phase 1; empty in phase 2
    dg: torch.Tensor        # int32 (Q,), phase 2: values column, -1 padding
    coef: torch.Tensor      # int64 (8, terms): A, B, C, D re and im
    idx: torch.Tensor       # int32 (terms,): y (phase 1) or x (phase 2)
    gate: torch.Tensor      # int32 (terms,): gate | ASSERT_BIT
    liu_ref: torch.Tensor   # int64 (Liu terms,): beta references
    lists: torch.Tensor     # int32: the warp, then the block slots
    rs: torch.Tensor        # int32 (3, pairs): c0 column, word, plane stride

    def out_words(self, rows: int) -> int:
        return 2 * WORDS[self.stage] * rows * self.w_total + self.rs_words

    def tensors(self):
        return [self.one, self.gather, self.tab, self.slot_tab, self.starts,
                self.liu_starts, self.dg, self.coef, self.idx, self.gate,
                self.liu_ref, self.lists, self.rs]


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

class _Columns:
    """c0's static pieces: each challenge vector the stage reads, once, in
    the order first asked for."""

    def __init__(self, cc):
        self.cc = cc
        self.start = {}
        self.pieces = []
        self.n = 0

    def width(self, key):
        cc, kind = self.cc, key[0]
        if kind in ("one", "assert_r"):
            return 1
        if kind == "r_out":
            return cc.layers[cc.depth - 1].bit_length
        if kind == "sig":
            return cc.depth
        if kind == "r_v":
            return cc.layers[key[1]].max_dad_bit_length
        return cc.max_bl                                  # r_u, r_liu

    def col(self, key, j: int = 0) -> int:
        if key not in self.start:
            self.start[key] = self.n
            self.pieces.append((key, self.width(key)))
            self.n += self.width(key)
        return self.start[key] + j


def _r_cur_key(cc, i):
    return ("r_out",) if i == cc.depth - 1 else ("r_liu", i + 1)


def _betas(jobs):
    """jobs {tag: (bl, r column, init column)} -> (groups [(bl, tags)] by
    size, {tag: (group, table)}, gather columns, per group (r offset, init
    offset) in the gather)."""
    by_bl = {}
    for tag, (bl, _r, _init) in jobs.items():
        by_bl.setdefault(bl, []).append(tag)
    groups = sorted(by_bl.items())
    if len(groups) > MAX_BETA_GROUPS:
        raise ValueError(f"gkr inits: {len(groups)} beta table sizes, "
                         f"{MAX_BETA_GROUPS} taken")
    pos, cols, offs = {}, [], []
    for g, (bl, tags) in enumerate(groups):
        r_off = len(cols)
        for k, tag in enumerate(tags):
            pos[tag] = (g, k)
            cols += [jobs[tag][1] + j for j in range(bl)]
        offs.append((r_off, len(cols)))
        cols += [jobs[tag][2] for tag in tags]
    return groups, pos, cols, offs


def _ref(groups, pos, tag) -> int:
    g, k = pos[tag]
    return (g << REF_SHIFT) | (k << groups[g][0])


def _classes(lengths):
    """(slots a class, the warp then the block slots)."""
    kind = np.where(lengths <= THREAD_MAX, THREAD,
                    np.where(lengths <= WARP_MAX, WARP, BLOCK))
    lists = [np.flatnonzero(kind == c) for c in (THREAD, WARP, BLOCK)]
    return tuple(len(x) for x in lists), np.concatenate(lists[1:])


def _counts(sp):
    """The terms of each segment of a ScatterPlan."""
    return sp.ends.astype(np.int64) - sp.starts


def _starts(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _i64(a, device):
    """An int64 tensor of integer or uint64 words (the bits kept)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64
                            else a.astype(np.int64, copy=False)).to(device)


def _finish(stage, cols, groups, betas, tabs, counts, terms, liu, dg, rs,
            claim_layers, device):
    """The InitPlan of a stage's pieces (host numpy) on `device`.  betas:
    ``_betas``' result; tabs: the table records in slot order, beta tags
    in T_BG / T_B2; counts: the terms of each slot; liu: (counts,
    references) of the Liu terms (phase 1) or None; rs: per group, the c0
    columns of each stacked challenge block's tables."""
    bgroups, pos, gather, boffs = betas
    first = np.array([rec[T_SLOT] for rec in tabs] + [len(counts)])
    slot_tab = np.repeat(np.arange(len(tabs)), np.diff(first))
    for rec in tabs:
        rec[T_BG], rec[T_B2] = (_ref(bgroups, pos, rec[T_BG]),
                                _ref(bgroups, pos, rec[T_B2]))
    rs_off, words, pairs = [], 0, []
    for g, (bl, _tables) in enumerate(groups):
        rs_off.append(words)
        for block in rs[g]:               # a stacked (2, K, bl) each
            for k, col in enumerate(block):
                pairs += [(col + j, words + k * bl + j, len(block) * bl)
                          for j in range(bl)]
            words += 2 * len(block) * bl
    liu_counts, refs = ((np.zeros_like(counts), np.zeros(0, np.int64))
                        if liu is None else liu)
    liu_starts = _starts(liu_counts) if liu else np.zeros(0, np.int32)
    classes, lists = _classes(np.maximum(counts, liu_counts))
    coef, idx, gate = terms
    return InitPlan(
        stage=stage, groups=groups,
        gbase=[_first_slot(groups, g) for g in range(len(groups))],
        w_total=_first_slot(groups, len(groups)), rs_off=rs_off,
        rs_words=words, chal=cols.pieces, nc_static=cols.n,
        claim_layers=claim_layers, betas=bgroups, beta_pos=pos,
        beta_off=boffs, n_slots=len(slot_tab), n_terms=len(idx),
        n_liu=len(refs), classes=classes, thread_max=THREAD_MAX,
        one=gf.ones((1,), device), gather=_i64(gather, device),
        tab=_i64(np.array(tabs, dtype=np.int64).reshape(-1, TAB_FIELDS),
                 device),
        slot_tab=_i32(slot_tab, device), starts=_i32(_starts(counts), device),
        liu_starts=_i32(liu_starts, device),
        dg=_i32(np.zeros(0) if dg is None else dg, device),
        coef=_i64(coef, device), idx=_i32(idx, device),
        gate=_i32(gate.astype(np.uint32).view(np.int32), device),
        liu_ref=_i64(refs, device), lists=_i32(lists, device),
        rs=_i32(np.array(pairs, dtype=np.int64).reshape(-1, 3).T, device))


def _first_slot(groups, g):
    """The first slot of output group g, which is also its word base W_g:
    the entries K 2^bl of the groups before it."""
    return sum(len(ts) << bl for bl, ts in groups[:g])


def _gate_words(L, gates):
    g = np.asarray(gates, dtype=np.int64)
    if L.has_assert:
        g = g | (np.asarray(L.is_assert, dtype=np.int64)[gates] << 31)
    return g


def _coef_terms(L, gates):
    return np.asarray(L.coeff, dtype=np.uint64)[:, :, gates].reshape(8, -1)


def _cat(xs, rows=None):
    if rows is None:
        return np.concatenate(xs) if xs else np.zeros(0, np.int64)
    return np.concatenate(xs, 1) if xs else np.zeros((rows, 0), np.uint64)


def p1_plan(cc, plans, groups, device) -> InitPlan:
    """The phase-1 + Liu stage's plan.  plans: ``protocol.build_plans``
    (each layer's gates and Liu terms sorted by destination, and its Liu
    consumers); groups: ``protocol._groups``' phase-1 groups
    {bl: [layer]}."""
    depth = cc.depth
    cols = _Columns(cc)
    one = cols.col(("one",))
    jobs = {}
    for i in range(depth - 1, 0, -1):
        bl_prev = cc.layers[i - 1].bit_length
        jobs[("bg", i)] = (cc.layers[i].bit_length,
                           cols.col(_r_cur_key(cc, i)), one)
        jobs[("bsig", i)] = (bl_prev, cols.col(("r_u", i)),
                             cols.col(("sig", i), 0))
        for (j, _ds, bl_jl, _off) in plans[i].liu_consumers:
            jobs[("bt", i, j)] = (bl_jl, cols.col(("r_v", j)),
                                  cols.col(("sig", i), j - i + 1))
    betas = _betas(jobs)
    tabs, counts, liu_counts = [], [], []
    coef, idx, gate, refs, rs = [], [], [], [], []
    out_groups = list(groups.items())
    for g, (bl, layers) in enumerate(out_groups):
        n = 1 << bl
        rs.append(([cols.col(("r_u", i)) for i in layers],
                   [cols.col(("r_liu", i)) for i in layers]))
        for k, i in enumerate(layers):
            L, pre = cc.layers[i], cc.layers[i - 1]
            tabs.append([_first_slot(out_groups, g) + k * n,
                         _first_slot(out_groups, g), len(layers) * n, k * n,
                         int(cc.value_off[i - 1]), pre.size, ("bg", i),
                         ("bsig", i),
                         cols.col(("assert_r", i)) if L.has_assert else -1,
                         -1])
            P = plans[i]
            order = P.p1.perm
            counts.append(_counts(P.p1))
            coef.append(_coef_terms(L, order))
            idx.append(np.asarray(L.y_idx)[order])
            gate.append(_gate_words(L, order))
            if P.liu_plan is None:
                liu_counts.append(np.zeros(n, np.int64))
                continue
            ref = [_ref(betas[0], betas[1], ("bt", i, j))
                   + np.arange(ds, dtype=np.int64)
                   for (j, ds, _bl, _off) in P.liu_consumers]
            liu_counts.append(_counts(P.liu_plan))
            refs.append(np.concatenate(ref)[P.liu_plan.perm])
    return _finish(1, cols, out_groups, betas, tabs, _cat(counts),
                   (_cat(coef, 8), _cat(idx), _cat(gate)),
                   (_cat(liu_counts), _cat(refs)), None, rs, [], device)


def p2_plan(cc, plans, groups, device):
    """The phase-2 stage's plan, None without phase-2 layers.  plans:
    ``protocol.build_plans`` (each layer's gates sorted by phase-2 slot);
    groups: ``protocol._groups``' phase-2 groups {bl: [(layer, source
    layer)]}."""
    layers = [i for i in range(cc.depth - 1, 0, -1)
              if cc.layers[i].max_dad_bit_length >= 0]
    if not layers:
        return None
    cols = _Columns(cc)
    one = cols.col(("one",))
    jobs = {}
    for i in layers:
        jobs[("bg", i)] = (cc.layers[i].bit_length,
                           cols.col(_r_cur_key(cc, i)), one)
        jobs[("bu", i)] = (cc.layers[i - 1].bit_length,
                           cols.col(("r_u", i)), one)
    betas = _betas(jobs)
    # each layer's term data in phase-2 slot order, once: a table's terms
    # are one range of them
    by_slot = {}
    for i in layers:
        L, P = cc.layers[i], plans[i].p2
        by_slot[i] = (P, _counts(P), _coef_terms(L, P.perm),
                      np.asarray(L.x_idx)[P.perm], _gate_words(L, P.perm))
    tabs, counts, dg = [], [], []
    coef, idx, gate, rs = [], [], [], []
    out_groups = list(groups.items())
    for g, (bl, tables) in enumerate(out_groups):
        n = 1 << bl
        rs.append(([cols.col(("r_v", i)) for i, _li in tables],))
        for k, (i, li) in enumerate(tables):
            L = cc.layers[i]
            off = L.dad_offsets[li]
            tabs.append([_first_slot(out_groups, g) + k * n,
                         _first_slot(out_groups, g), len(tables) * n, k * n,
                         -1, -1, ("bg", i), ("bu", i),
                         cols.col(("assert_r", i)) if L.has_assert else -1,
                         layers.index(i)])
            P, t_counts, t_coef, t_x, t_gate = by_slot[i]
            lo, hi = P.starts[off], P.ends[off + n - 1]
            counts.append(t_counts[off:off + n])
            coef.append(t_coef[:, lo:hi])
            idx.append(t_x[lo:hi])
            gate.append(t_gate[lo:hi])
            dg.append(np.asarray(L.dad_gather_idx, dtype=np.int64)
                      [off:off + n])
    return _finish(2, cols, out_groups, betas, tabs, _cat(counts),
                   (_cat(coef, 8), _cat(idx), _cat(gate)), None, _cat(dg),
                   rs, layers, device)


# ---------------------------------------------------------------------------
# Inputs and outputs of a stage
# ---------------------------------------------------------------------------

def _piece(plan, ch, key):
    kind = key[0]
    if kind == "one":
        return plan.one
    if kind == "r_out":
        return ch.r_out
    lc = ch.layers[key[1]]
    if kind == "assert_r":
        return lc.assert_r.reshape(2, 1)
    return getattr(lc, kind)


def challenge_buffer(plan: InitPlan, ch, claims=None):
    """c0 (2, NC): the plan's challenge vectors side by side, then (phase 2)
    each claim layer's claims (2, *lead) as R columns.  One ``torch.cat``."""
    pieces = [_piece(plan, ch, key) for key, _w in plan.chal]
    if claims is not None:
        pieces += [claims[i].reshape(2, -1) for i in plan.claim_layers]
    return torch.cat(pieces, dim=1)


def beta_tables(plan: InitPlan, c0):
    """The stage's beta tables, one (2, L, 2^bl) tensor per size: one
    gather of their challenges and inits out of c0, one
    ``beta_tables_batched`` call per size."""
    src = torch.index_select(c0, 1, plan.gather)
    out = []
    for (bl, tags), (r_off, i_off) in zip(plan.betas, plan.beta_off):
        n = len(tags)
        r = src[:, r_off:r_off + n * bl].view(2, n, bl)
        out.append(beta_tables_batched(r, bl, src[:, i_off:i_off + n]))
    return out


def beta_table(plan: InitPlan, tables, tag):
    """One beta table (2, 2^bl) of the stage, a view of its size's tensor."""
    g, k = plan.beta_pos[tag]
    return tables[g][:, k]


def _group_arrays(plan, out, g, lead):
    bl, tables = plan.groups[g]
    rows, k, n = math.prod(lead), len(tables), 1 << bl
    block = 2 * rows * k * n
    base = 2 * WORDS[plan.stage] * rows * plan.gbase[g]
    return [out[base + a * block:base + (a + 1) * block]
            .view((2,) + tuple(lead) + (k, n))
            for a in range(WORDS[plan.stage])]


def _group_rs(plan, out, g, which, lead):
    bl, tables = plan.groups[g]
    k = len(tables)
    base = (2 * WORDS[plan.stage] * math.prod(lead) * plan.w_total
            + plan.rs_off[g] + which * 2 * k * bl)
    return out[base:base + 2 * k * bl].view(2, k, bl)


def p1_views(plan: InitPlan, out, lead):
    """gkr_p1_inits' buffer as ({bl: (v, a, m, rs)} phase 1, {bl: (v, 0,
    m', rs)} Liu), the tables (2, *lead, K, 2^bl), rs (2, K, bl)."""
    p1, liu = {}, {}
    for g, (bl, _layers) in enumerate(plan.groups):
        v, a, m, lv, la, lm = _group_arrays(plan, out, g, lead)
        p1[bl] = (v, a, m, _group_rs(plan, out, g, 0, lead))
        liu[bl] = (lv, la, lm, _group_rs(plan, out, g, 1, lead))
    return p1, liu


def p2_views(plan: InitPlan, out, lead):
    """gkr_p2_inits' buffer as {bl: (vdad, addV, multV, rs)}."""
    return {bl: tuple(_group_arrays(plan, out, g, lead))
            + (_group_rs(plan, out, g, 0, lead),)
            for g, (bl, _tables) in enumerate(plan.groups)}


# ---------------------------------------------------------------------------
# The entries: dispatch, kernels, plain twins
# ---------------------------------------------------------------------------

def _on_cuda(x) -> bool:
    t = x.device.type
    if t == "cuda":
        return True
    if t == "cpu":
        return False
    raise ValueError(f"gkr inits: no kernels for device {x.device}")


def p1_inits(plan: InitPlan, values, c0, betas):
    """Phase 1 + Liu: the flat buffer that ``p1_views`` cuts.  values (2,
    *lead, T) contiguous; c0 from ``challenge_buffer``; betas from
    ``beta_tables``."""
    fn = p1_inits_cuda if _on_cuda(values) else p1_inits_plain
    return fn(plan, values, c0, betas)


def p2_inits(plan: InitPlan, values, c0, betas):
    """Phase 2: the flat buffer that ``p2_views`` cuts."""
    fn = p2_inits_cuda if _on_cuda(values) else p2_inits_plain
    return fn(plan, values, c0, betas)


def _rows(plan, values, c0):
    """(rows, values' last axis, the c0 column of the first claim)."""
    rows = math.prod(values.shape[1:-1])
    claims = len(plan.claim_layers) * rows
    if values.shape[0] != 2 or tuple(c0.shape) != (2, plan.nc_static
                                                   + claims):
        raise ValueError(f"{ENTRY[plan.stage]}: values {tuple(values.shape)}"
                         f", c0 {tuple(c0.shape)} against the plan's "
                         f"{plan.nc_static} + {claims} columns")
    return rows, values.shape[-1], plan.nc_static


def _launch(stage: int, plan: InitPlan, values, c0, betas):
    entry = ENTRY[stage]
    dev = values.device
    if dev.type != "cuda" or plan.stage != stage:
        raise ValueError(f"{entry}: a stage-{stage} plan and CUDA tensors "
                         f"taken, got a stage-{plan.stage} plan on {dev}")
    rows, tv, claim_base = _rows(plan, values, c0)
    for t in [values, c0, *betas] + plan.tensors():
        if t.device != dev:
            raise ValueError(f"{entry}: every tensor on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: tensors must be contiguous")
    if any(t.dtype != torch.int64 for t in [values, c0, *betas]):
        raise TypeError(f"{entry}: expected int64 values, c0 and tables")
    if len(betas) != len(plan.betas) or any(
            tuple(t.shape) != (2, len(tags), 1 << bl)
            for t, (bl, tags) in zip(betas, plan.betas)):
        raise ValueError(f"{entry}: beta tables "
                         f"{[tuple(t.shape) for t in betas]} against the "
                         f"plan's {[(len(t), bl) for bl, t in plan.betas]}")
    out = torch.empty((plan.out_words(rows),), dtype=torch.int64, device=dev)
    _nt, nw, nb = plan.classes
    kernels.check_int(entry, items=max(plan.n_slots, plan.rs.shape[1]),
                      warps=nw, blocks=nb, slots=plan.n_slots,
                      terms=max(plan.n_terms, plan.n_liu))
    ptrs = (ctypes.c_void_p * len(betas))(*[t.data_ptr() for t in betas])
    planes = (ctypes.c_longlong * len(betas))(*[t.shape[1] * t.shape[2]
                                                for t in betas])
    kernels.launch(entry, 1, values.data_ptr(), rows, tv, c0.data_ptr(),
                   c0.shape[1], claim_base, len(betas), ptrs, planes,
                   plan.tab.data_ptr(), plan.slot_tab.data_ptr(),
                   plan.starts.data_ptr(), plan.liu_starts.data_ptr(),
                   plan.dg.data_ptr(), plan.coef.data_ptr(), plan.n_terms,
                   plan.idx.data_ptr(), plan.gate.data_ptr(),
                   plan.liu_ref.data_ptr(), plan.lists.data_ptr(),
                   plan.n_slots, plan.thread_max, nw, nb,
                   plan.rs.data_ptr(), plan.rs.shape[1], out.data_ptr(),
                   2 * WORDS[plan.stage] * rows * plan.w_total,
                   kernels.stream_ptr())
    return out


def p1_inits_cuda(plan: InitPlan, values, c0, betas):
    """gkr_p1_inits on the card, one launch: same signature and bits as
    p1_inits_plain on canonical inputs."""
    return _launch(1, plan, values, c0, betas)


def p2_inits_cuda(plan: InitPlan, values, c0, betas):
    """gkr_p2_inits on the card, one launch."""
    return _launch(2, plan, values, c0, betas)


def _segsum(x, starts):
    """Field sums of the last axis over the segments [starts[q],
    starts[q + 1]): an exact prefix sum on the plain add."""
    s = chains.prefix_sum(x, gf.add_plain)
    s0 = torch.cat([torch.zeros(s.shape[:-1] + (1,), dtype=s.dtype,
                                device=s.device), s], -1)
    st = starts.long()
    return gf.sub_plain(s0[..., st[1:]], s0[..., st[:-1]])


def _beta_at(betas, refs):
    """The beta entries (2, ...) at packed references (int64 tensor)."""
    flat = torch.cat([t.reshape(2, -1) for t in betas], 1)
    offs = torch.tensor(np.cumsum([0] + [t[0].numel() for t in betas[:-1]]),
                        dtype=torch.int64, device=flat.device)
    idx = offs[refs >> REF_SHIFT] + (refs & ((1 << REF_SHIFT) - 1))
    return flat[:, idx]


def _term_tables(plan):
    """Each term's table record (terms, TAB_FIELDS)."""
    st = plan.starts.long()
    slot = torch.repeat_interleave(
        torch.arange(plan.n_slots, device=st.device), st[1:] - st[:-1],
        output_size=plan.n_terms)
    return plan.tab[plan.slot_tab.long()[slot]]


def _gated_beta(plan, trec, betas, c0):
    """bg'(g) of every term (2, terms): its layer's bg entry, times
    assert_r on an assert gate."""
    gate = plan.gate.long()
    b = _beta_at(betas, trec[:, T_BG] + (gate & (ASSERT_BIT - 1)))
    is_assert = (gate & ASSERT_BIT) != 0
    ar = c0[:, trec[:, T_ASSERT].clamp(min=0)]
    return torch.where(is_assert, gf.mul_plain(b, ar), b)


def _scatter(plan, out, rows, words):
    """Write per-slot words [(array, (2, rows, Q))] at the kernel's
    addresses: 2 ARR rows W + ((array 2 + plane) rows + row) K n + k n + s
    (W, K n and k n the slot's table's)."""
    dev = out.device
    rec = plan.tab[plan.slot_tab.long()]
    s = torch.arange(plan.n_slots, device=dev) - rec[:, T_SLOT]
    kn = rec[:, T_KN][None]
    row = torch.arange(rows, device=dev)[:, None]
    base = (2 * WORDS[plan.stage] * rows * rec[:, T_GBASE] + rec[:, T_KOFF]
            + s)[None] + row * kn
    for arr, x in words:
        for p in range(2):
            out[(base + (arr * 2 + p) * rows * kn).reshape(-1)] = \
                x[p].reshape(-1)


def _stacked_challenges(plan, out, c0, rows):
    """The rs region: each pair's c0 column, both planes."""
    base = 2 * WORDS[plan.stage] * rows * plan.w_total
    src, dst, stride = (plan.rs[k].long() for k in range(3))
    out[base + dst] = c0[0, src]
    out[base + dst + stride] = c0[1, src]


def p1_inits_plain(plan: InitPlan, values, c0, betas):
    """Plain twin of gkr_p1_inits: per-term gathers and products, exact
    prefix sums by slot, the slots written at the kernel's addresses;
    ``gf``'s plain ops only."""
    kernels.PLAIN_CALLS["gkr_p1_inits"] += 1
    rows, tv, _ = _rows(plan, values, c0)
    vals = values.reshape(2, rows, tv)
    mul, add = gf.mul_plain, gf.add_plain
    b = _gated_beta(plan, _term_tables(plan), betas, c0)[:, None]
    A, B, C, D = (plan.coef[2 * k:2 * k + 2, None] for k in range(4))
    y = vals[:, :, plan.idx.long()]
    a = _segsum(mul(b, add(mul(B, y), D)), plan.starts)
    m = _segsum(mul(b, add(A, mul(C, y))), plan.starts)
    rec = plan.tab[plan.slot_tab.long()]
    s = torch.arange(plan.n_slots, device=values.device) - rec[:, T_SLOT]
    liu = add(_segsum(_beta_at(betas, plan.liu_ref), plan.liu_starts),
              torch.where(s < rec[:, T_SIZE],
                          _beta_at(betas, rec[:, T_B2] + s), 0))
    v = vals[:, :, rec[:, T_VOFF] + s]
    out = torch.zeros((plan.out_words(rows),), dtype=torch.int64,
                      device=values.device)
    _scatter(plan, out, rows, [(0, v), (1, a), (2, m), (3, v),
                               (4, torch.zeros_like(v)),
                               (5, liu[:, None].expand(2, rows, -1))])
    _stacked_challenges(plan, out, c0, rows)
    return out


def p2_inits_plain(plan: InitPlan, values, c0, betas):
    """Plain twin of gkr_p2_inits."""
    kernels.PLAIN_CALLS["gkr_p2_inits"] += 1
    rows, tv, claim_base = _rows(plan, values, c0)
    vals = values.reshape(2, rows, tv)
    mul, add = gf.mul_plain, gf.add_plain
    trec = _term_tables(plan)
    tmp = mul(_gated_beta(plan, trec, betas, c0),
              _beta_at(betas, trec[:, T_B2] + plan.idx.long()))[:, None]
    cu = c0[:, claim_base + trec[:, T_CLAIM][None] * rows
            + torch.arange(rows, device=c0.device)[:, None]]
    A, B, C, D = (plan.coef[2 * k:2 * k + 2, None] for k in range(4))
    add_v = _segsum(mul(tmp, add(mul(A, cu), D)), plan.starts)
    mult_v = _segsum(mul(tmp, add(B, mul(C, cu))), plan.starts)
    dg = plan.dg.long()
    vd = torch.where(dg >= 0, vals[:, :, dg.clamp(min=0)], 0)
    out = torch.zeros((plan.out_words(rows),), dtype=torch.int64,
                      device=values.device)
    _scatter(plan, out, rows, [(0, vd), (1, add_v), (2, mult_v)])
    _stacked_challenges(plan, out, c0, rows)
    return out
