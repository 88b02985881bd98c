"""The GKR verifier's two programs, one kernel launch each: every layer's
succinct checks (``gkr_verify_fast``) and every layer's predicate sweep
(``gkr_verify_slow``).

Counterpart of the JAX verifier jits ``_verify_fast_all`` and
``_verify_slow_all`` (``virgo_plus_tpu/gkr/protocol.py:894``, :917), whose
round checks, Liu sums and predicate sweeps XLA fuses.  Here:

* ``plan(cc, varrs, device)``: the flat plan of a circuit, made once per
  circuit and device (``protocol.make_verifier``): host numpy tables of
  jobs, items, stages, beta tables and their parts, the parts each item
  builds, term segments, rounds and Liu terms, as int32 tensors on the
  device, and the predicate sweep's gate arrays and the Liu sums' dad
  lists, cats of ``verifier_arrays``' tensors;
* ``verify_fast`` / ``verify_slow``: a CUDA proof goes to the entries
  (``verify_fast_cuda``: one ``torch.cat`` of the round polynomials and one
  of the challenges and proof scalars, then one ``gkr_verify_fast`` launch;
  ``verify_slow_cuda``: one cat and one ``gkr_verify_slow`` launch), a CPU
  proof to the plain twins (``verify_fast_plain``, ``verify_slow_plain``:
  ``protocol``'s layer walk on ``gf``'s plain ops), which count
  ``kernels.PLAIN_CALLS``.

What the entries compute, in the twins' terms (``protocol.verify_layer_fast``,
``predicate_check``, ``_output_ok``):

* fast, layer i (its pre-layer i - 1): round j of its phase-1, phase-2 and
  Liu chains checks p_j(0) + p_j(1) against p_{j-1}(r_{j-1}); round 0's
  value is the upper layer's Liu claim (vres at the top), the end of phase
  1, or liu_sum = sig_0 claim_u + sum_j sig_{j-i+1} claims_v_j[i-1].  Each
  is proof or challenge data, so every round is checked on its own.  Then
  liu_claim gr against the Liu chain's end, with gr = sig_0 sum_{s <
  size(i-1)} bu(s) bliu(s) + sum_j sig_{j-i+1} sum_{k < ds_j} bv_j(k)
  bliu(dad_j(k)), and mid (the end of phase 2, else of phase 1) out; with
  an output block, sum_g out[g] bout(g) against vres;
* slow, layer i: sum_{g < size(i)} bg'(g) bu(x_g) bv(lv_g) (A_g cu + B_g
  cv_g + C_g cu cv_g + D_g) against mid, bg' = bg times assert_r on an
  assert gate; bv = 1 and cv = 0 for a layer without dads.

The b* are beta tables (``beta.beta_table``), each read as a product of
parts: beta(r, g) over k bits is the product, over ``part_widths(k)``
(at most PART_BITS bits a part), of part_p[the bits of g in part p]; an
item builds the parts its segments read in shared memory, each part's
entries as products of a low and a high half (``half_widths``).  A
table's init (sig, for bsig and each bt) multiplies its first part's
entries, as ``beta_table(r, k, init)`` has it; a table with a second
column (col2) is the product of two tables of the same bits, entry by
entry (bsig bliu of a layer's own range): the field is exact, so the
product of the parts is the twin's table, or product of tables.  Every
product and sum of canonical inputs is canonical, so sums in any order
give the twins' bits.  The plain ops are not the field's on words of p or
more, so every step that reads a proof or output word is the plain op's
own (``csrc/gf_int64.cuh``) in the twins' order: the rounds, liu_sum, the
checks' products, the cu cv table, and the terms of a "tree" job (a layer
of the slow program, the output block), summed in the twins' tree
(``chains.tree_sum_plain``) where a word is not canonical.  The verdict
and mids are the twins' on any int64 words.

A job is a layer of the fast program (its rounds and gr), the output
block, or a layer of the slow program.  A stage is up to STAGE_SEGS of its
segments whose tables fit STAGE_WORDS words of shared memory, their
halves HALF_WORDS and their parts STAGE_PARTS; its segments' terms are one
range, each segment starting at a multiple of GROUP.  An item, a block of
the launch, is a run of whole GROUP-term groups of one stage: the plan
cuts each stage into items of about equal products (``term_cost``), about
ITEMS_PER_SM a multiprocessor of the card over the whole program, none
below MIN_ITEM_COST; a tree job (one segment) into items of 2^h aligned
terms (J_TREE = h, J_TREE_K = K, its tree's height), so that each item
is a subtree of the twin's.  Value references name a c0 column (REF_COL), a
round polynomial at a c0 column (REF_EVAL: p(r)) or the job's liu_sum
(REF_LIU).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import kernels

# csrc/gkr_verify.cu: a block's threads, a beta part's most bits, a
# stage's most table words, half-part words, segments and parts, the terms
# of a group, an assert gate's bit
THREADS = 256
PART_BITS = 8
STAGE_WORDS = 8192
HALF_WORDS = 2048
STAGE_SEGS = 32
STAGE_PARTS = 64
GROUP = 32
ASSERT_BIT = 1 << 31
# items a multiprocessor of the card (the kernel's resident blocks an SM),
# an item's least products, the SMs of a plan made for the CPU (an H100's)
ITEMS_PER_SM = 2
MIN_ITEM_COST = 2048
DEFAULT_SMS = 132

REF_COL, REF_EVAL, REF_LIU = range(3)
SEG_PRE, SEG_DAD, SEG_OUT, SEG_GATE = range(4)
# int32 fields of a job, item, item's part to build, stage (host only),
# beta part, table, segment, round and Liu term (csrc/gkr_verify.cu's
# enums, in the same order)
JOB_FIELDS = ("J_STAGE0", "J_STAGE1", "J_ITEM0", "J_ITEM1", "J_ROUND0",
              "J_ROUND1", "J_LIU0", "J_LIU1", "J_MUL", "J_EXP", "J_EXP_A",
              "J_EXP_B", "J_MID", "J_MID_KIND", "J_MID_A", "J_MID_B",
              "J_TREE", "J_TREE_K")
ITEM_FIELDS = ("I_JOB", "I_STAGE", "I_T0", "I_T1", "I_SEG0", "I_SEG1",
               "I_BUILD0", "I_BUILD1", "I_ENTRIES", "I_HALVES")
# an item's part to build: the part's fields (PART_FIELDS), then its first
# entry and first half entry in the item's build
BUILD_FIELDS = ("B_COL", "B_COL2", "B_W", "B_BASE", "B_SCALE", "B_FIRST",
                "B_HFIRST")
STAGE_FIELDS = ("S_PART0", "S_PART1", "S_ENTRIES", "S_SEG0", "S_SEG1",
                "S_TERMS")
PART_FIELDS = ("P_COL", "P_COL2", "P_W", "P_BASE", "P_SCALE")
TABLE_FIELDS = ("T_COL", "T_COL2", "T_BITS", "T_SMEM", "T_SCALE")
SEG_FIELDS = ("G_KIND", "G_N", "G_FIRST", "G_OFF", "G_TA", "G_TB", "G_TC",
              "G_KA", "G_KB", "G_KC", "G_SA", "G_SB", "G_SC", "G_ASSERT",
              "G_CU", "G_CV", "G_NCV", "G_CUV")
ROUND_FIELDS = ("R_ROW", "R_COL", "R_KIND", "R_A", "R_B")
LIU_FIELDS = ("L_SIG", "L_CLAIM")
(J_STAGE0, J_STAGE1, J_ITEM0, J_ITEM1, J_ROUND0, J_ROUND1, J_LIU0, J_LIU1,
 J_MUL, J_EXP, J_EXP_A, J_EXP_B, J_MID, J_MID_KIND, J_MID_A,
 J_MID_B, J_TREE, J_TREE_K) = range(18)
(I_JOB, I_STAGE, I_T0, I_T1, I_SEG0, I_SEG1, I_BUILD0, I_BUILD1, I_ENTRIES,
 I_HALVES) = range(10)
B_COL, B_COL2, B_W, B_BASE, B_SCALE, B_FIRST, B_HFIRST = range(7)
S_PART0, S_PART1, S_ENTRIES, S_SEG0, S_SEG1, S_TERMS = range(6)
P_COL, P_COL2, P_W, P_BASE, P_SCALE = range(5)
T_COL, T_COL2, T_BITS, T_SMEM, T_SCALE = range(5)
(G_KIND, G_N, G_FIRST, G_OFF, G_TA, G_TB, G_TC, G_KA, G_KB, G_KC, G_SA, G_SB,
 G_SC, G_ASSERT, G_CU, G_CV, G_NCV, G_CUV) = range(18)
R_ROW, R_COL, R_KIND, R_A, R_B = range(5)
L_SIG, L_CLAIM = range(2)
# the device tensors of a plan, in the C entry's order (the kernel reads a
# part's and a table's fields from an item's builds and a segment's row;
# stages, parts and tables stay on the host)
KERNEL_TABLES = ("jobs", "items", "builds", "segs", "rounds", "liu")


def part_widths(k: int) -> list:
    """The bits of each part of a k-bit beta table: ceil(k / PART_BITS)
    parts (one for k = 0), the first k mod n one bit wider."""
    n = max(1, -(-k // PART_BITS))
    return [k // n + (p < k % n) for p in range(n)]


def half_widths(w: int) -> tuple:
    """The bits of a w-bit part's low and high halves."""
    return (w + 1) // 2, w // 2


def half_entries(w: int) -> int:
    lo, hi = half_widths(w)
    return (1 << lo) + (1 << hi)


def table_words(k: int) -> int:
    return 2 * sum(1 << w for w in part_widths(k))


def table_halves(k: int) -> int:
    return 2 * sum(half_entries(w) for w in part_widths(k))


def _spans(n):
    """A segment's terms rounded up to whole groups."""
    return -(-n // GROUP) * GROUP


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

class _Cols:
    """c0's pieces: (key, width) side by side, each key's first column."""

    def __init__(self):
        self.pieces, self.start, self.n = [], {}, 0

    def add(self, key, width: int):
        self.start[key] = self.n
        self.pieces.append((key, width))
        self.n += width

    def __getitem__(self, key):
        return self.start[key]


class _Tables:
    """The rows of one program's tables, appended job by job."""

    def __init__(self):
        self.jobs, self.stages, self.parts, self.tables = [], [], [], []
        self.segs, self.rounds, self.liu = [], [], []
        self.table_parts = []     # a table's [first part, end)
        self.max_words = self.max_halves = 0

    def job(self, segments, rounds=(), liu=(), mul=-1, exp=(REF_COL, 0, 0),
            mid=-1, mid_ref=(REF_COL, 0, 0), tree=False):
        """One job: its segments [(row, table keys (col, k, init column or
        -1, col2 or -1) of TA, TB, TC or None)], packed into stages, its
        rounds and Liu terms, the check's factor column (or -1), its
        expected and mid references and mid's output row (or -1); a tree
        job (one segment of at most THREADS - 1 cv claims) is cut into
        subtrees of the twin's tree sum (J_TREE set by _items).  A
        table's init scales its first part's entries; col2 makes it the
        product of the tables at col and col2.  A gate segment with cv
        claims (G_NCV) gets its cu cv table in the stage's words."""
        first_stage, first_round = len(self.stages), len(self.rounds)
        first_liu = len(self.liu)
        self.rounds += rounds
        self.liu += liu
        state = {}

        def start():
            state.update(cur={}, words=0, halves=0, entries=0, terms=0,
                         part=len(self.parts), seg=len(self.segs))

        def close():
            self.stages.append([state["part"], len(self.parts),
                                state["entries"], state["seg"],
                                len(self.segs), state["terms"]])
            self.max_words = max(self.max_words, state["words"])
            self.max_halves = max(self.max_halves, state["halves"])

        def need(keys, row):
            keys = [k for k in dict.fromkeys(x for x in keys if x is not None)
                    if k not in state["cur"]]
            return keys, (sum(table_words(k[1]) for k in keys)
                          + 2 * row[G_NCV],
                          sum(table_halves(k[1]) for k in keys),
                          sum(len(part_widths(k[1])) for k in keys))

        start()
        for row, keys in segments:
            if row[G_N] <= 0:
                raise ValueError("gkr_verify: an empty segment")
            new, (words, halves, parts) = need(keys, row)
            if state["cur"] and (
                    state["words"] + words > STAGE_WORDS
                    or state["halves"] + halves > HALF_WORDS
                    or len(self.parts) - state["part"] + parts > STAGE_PARTS
                    or len(self.segs) - state["seg"] == STAGE_SEGS):
                close()
                start()
                new, (words, halves, parts) = need(keys, row)
            if (words > STAGE_WORDS or halves > HALF_WORDS
                    or parts > STAGE_PARTS):
                raise ValueError(f"gkr_verify: a segment's tables of {words} "
                                 f"words, {halves} half words and {parts} "
                                 f"parts exceed a stage's {STAGE_WORDS}, "
                                 f"{HALF_WORDS}, {STAGE_PARTS}")
            for key in new:
                col, k, init, col2 = key
                state["cur"][key] = len(self.tables)
                self.tables.append([col, col2, k, state["words"], init])
                first_part, off = len(self.parts), 0
                for w in part_widths(k):
                    self.parts.append([col + off, col2 + off if col2 >= 0
                                       else -1, w, state["words"],
                                       init if off == 0 else -1])
                    state["words"] += 2 << w
                    state["halves"] += 2 * half_entries(w)
                    state["entries"] += 1 << w
                    off += w
                self.table_parts.append((first_part, len(self.parts)))
            row = list(row)
            if row[G_NCV]:
                row[G_CUV] = state["words"]
                state["words"] += 2 * row[G_NCV]
            row[G_FIRST] = state["terms"]
            state["terms"] += _spans(row[G_N])
            for c, key in enumerate(keys):
                t = -1 if key is None else state["cur"][key]
                row[G_TA + c] = t
                row[G_KA + c] = -1 if t < 0 else self.tables[t][T_BITS]
                row[G_SA + c] = -1 if t < 0 else self.tables[t][T_SMEM]
            self.segs.append(row)
        if segments:
            close()
        n = segments[0][0][G_N] if tree else 0
        if tree and (len(segments) != 1 or segments[0][0][G_NCV] >= THREADS):
            raise ValueError("gkr_verify: a tree job is one segment of at "
                             f"most {THREADS - 1} cv claims")
        self.jobs.append([first_stage, len(self.stages), 0, 0, first_round,
                          len(self.rounds), first_liu, len(self.liu), mul,
                          *exp, mid, *mid_ref, -1,
                          (n - 1).bit_length() if tree else -1])


def term_cost(seg, tables) -> int:
    """A segment's products a term, roughly, in the kernel's order (a
    hoisted lookup one, a gathered one np - 1, each term's own products,
    one for its sum and loads): what the plan balances items by."""
    np_ = lambda t: len(part_widths(int(tables[t][T_BITS]))) if t >= 0 else 0
    kind = seg[G_KIND]
    if kind == SEG_PRE:
        return 2
    if kind == SEG_OUT:
        return 3
    if kind == SEG_DAD:
        return 2 + np_(seg[G_TB])
    return 6 + np_(seg[G_TB]) + np_(seg[G_TC])


def _items(tab, sms):
    """The items of every job (each job's items contiguous, in job order)
    and the parts each builds: (items (n, I_FIELDS), builds (m,
    B_FIELDS)); the jobs' J_ITEM0 / J_ITEM1 set in place."""
    stages = np.asarray(tab.stages, dtype=np.int64).reshape(-1, len(STAGE_FIELDS))
    segs = np.asarray(tab.segs, dtype=np.int64).reshape(-1, len(SEG_FIELDS))
    costs = []                      # each stage's cost a group
    for st in stages:
        c = np.zeros(st[S_TERMS] // GROUP)
        for g in segs[st[S_SEG0]:st[S_SEG1]]:
            n, g0 = int(g[G_N]), int(g[G_FIRST]) // GROUP
            k = term_cost(g, tab.tables)
            c[g0:g0 + n // GROUP] += k * GROUP
            if n % GROUP:
                c[g0 + n // GROUP] += k * (n % GROUP)
        costs.append(c)
    total = sum(float(c.sum()) for c in costs)
    per = max(MIN_ITEM_COST, total / max(1, sms * ITEMS_PER_SM))
    items, builds = [], []
    for j, job in enumerate(tab.jobs):
        job[J_ITEM0] = len(items)
        for s in range(job[J_STAGE0], job[J_STAGE1]):
            c, st = costs[s], stages[s]
            cum = np.cumsum(c)
            k = max(1, min(len(c), int(round(cum[-1] / per))))
            if job[J_TREE_K] >= 0:
                # 2^h aligned terms an item, 2^h near the stage's terms
                # over k, h <= K (one item of the whole tree for K <= 5)
                K = job[J_TREE_K]
                h = K if K <= 5 else min(K, 5 + max(0, int(round(
                    np.log2(len(c) / k)))))
                job[J_TREE] = h
                step = max(1, (1 << h) // GROUP)
                cuts = np.append(np.arange(0, len(c), step), len(c))
            else:
                cuts = np.unique(np.concatenate([[0], np.searchsorted(
                    cum, cum[-1] * np.arange(1, k) / k) + 1, [len(c)]]))
            for a, b in zip(cuts[:-1], cuts[1:]):
                t0, t1 = int(a) * GROUP, int(b) * GROUP
                ss = [i for i in range(st[S_SEG0], st[S_SEG1])
                      if segs[i][G_FIRST] < t1
                      and segs[i][G_FIRST] + _spans(segs[i][G_N]) > t0]
                used = dict.fromkeys(t for i in ss
                                     for t in segs[i][G_TA:G_TC + 1] if t >= 0)
                b0, first, hfirst = len(builds), 0, 0
                for t in used:
                    for p in range(*tab.table_parts[t]):
                        builds.append(tab.parts[p] + [first, hfirst])
                        first += 1 << tab.parts[p][P_W]
                        hfirst += half_entries(tab.parts[p][P_W])
                items.append([j, s, t0, t1, ss[0], ss[-1] + 1, b0,
                              len(builds), first, hfirst])
        # every job has a segment, so an item: its check runs there
        assert len(items) > job[J_ITEM0], j
        job[J_ITEM1] = len(items)
    return items, builds


def _seg(kind, n, off=0, a=-1, cu=-1, cv=-1, ncv=0):
    row = [0] * len(SEG_FIELDS)
    row[G_KIND], row[G_N], row[G_OFF] = kind, n, off
    row[G_ASSERT], row[G_CU], row[G_CV], row[G_NCV] = a, cu, cv, ncv
    row[G_CUV] = -1
    return row


def _chain(rounds, row0, n, col0, source):
    """A round chain's rounds (polynomial rows row0.., challenges at c0
    columns col0..) checked against `source` then each previous round's
    p(r); returns the chain's end reference."""
    ref = source
    for j in range(n):
        rounds.append([row0 + j, col0 + j, *ref])
        ref = (REF_EVAL, row0 + j, col0 + j)
    return ref


class KernelPlan:
    """One program's flat plan: the c0 pieces, host numpy tables and their
    device tensors (``tensors``), and the launch's shape: the table and
    half words of shared memory, each job's items (``items_of``)."""

    def __init__(self, entry, cols, tab, n_jobs, device, sms, idx=None,
                 gates=None, n_rows=0, layers=0):
        self.entry = entry
        self.cols = cols
        self.n_jobs = n_jobs             # jobs without the output block
        self.n_rows = n_rows             # round polynomial rows (fast)
        self.layers = layers
        self.table_words = tab.max_words
        self.half_words = tab.max_halves
        items, builds = _items(tab, sms)
        self.host = {name: np.asarray(rows, dtype=np.int32).reshape(
            -1, len(fields))
            for name, rows, fields in (
                ("jobs", tab.jobs, JOB_FIELDS),
                ("items", items, ITEM_FIELDS),
                ("builds", builds, BUILD_FIELDS),
                ("stages", tab.stages, STAGE_FIELDS),
                ("parts", tab.parts, PART_FIELDS),
                ("tables", tab.tables, TABLE_FIELDS),
                ("segs", tab.segs, SEG_FIELDS),
                ("rounds", tab.rounds, ROUND_FIELDS),
                ("liu", tab.liu, LIU_FIELDS))}
        self.tensors = {k: torch.from_numpy(self.host[k]).to(device)
                        for k in KERNEL_TABLES}
        empty32 = torch.zeros((1,), dtype=torch.int32, device=device)
        self.idx = idx if idx is not None and idx.numel() else empty32
        gx, glv, gsl, coef = gates or (empty32,) * 3 + (
            torch.zeros((8, 1), dtype=torch.int64, device=device),)
        self.gx, self.glv, self.gsl, self.coef = gx, glv, gsl, coef
        self.g_total = coef.shape[1]

    def items_of(self, jobs: int) -> int:
        """The items (blocks) of a launch over the first `jobs` jobs."""
        return int(self.host["jobs"][jobs - 1][J_ITEM1]) if jobs else 1

    def all_tensors(self):
        return list(self.tensors.values()) + [self.idx, self.gx, self.glv,
                                              self.gsl, self.coef]


def _i32(parts, device):
    return (torch.cat([p.to(torch.int32) for p in parts]) if parts
            else torch.zeros((0,), dtype=torch.int32, device=device))


def _fast_plan(cc, varrs, device, sms) -> KernelPlan:
    """gkr_verify_fast's plan: a job a layer, top down, then the output
    block's job (launched only with an output block).  A layer's own range
    reads one table, bsig bliu (r_u's with sig's init, times r_liu's)."""
    src, depth = cc.source, cc.depth
    cols = _Cols()
    layers = list(range(depth - 1, 0, -1))
    for i in layers:
        L, bl_prev = cc.layers[i], cc.layers[i - 1].bit_length
        cols.add(("r_u", i), bl_prev)
        if L.max_dad_bit_length >= 0:
            cols.add(("r_v", i), L.max_dad_bit_length)
        cols.add(("sig", i), depth - i + 1)
        cols.add(("r_liu", i), bl_prev)
        cols.add(("claim_u", i), 1)
        cols.add(("liu_claim", i), 1)
        if L.max_dad_bit_length >= 0:
            cols.add(("claims_v", i), i)
    cols.add(("vres",), 1)
    bl_out = cc.layers[depth - 1].bit_length
    cols.add(("r_out",), bl_out)
    tab, dads = _Tables(), []
    row = n_dads = 0
    for k, i in enumerate(layers):
        L, bl_prev = cc.layers[i], cc.layers[i - 1].bit_length
        mdb = L.max_dad_bit_length
        sig = cols[("sig", i)]
        rounds = []
        top = (REF_COL, cols[("vres",)] if i == depth - 1
               else cols[("liu_claim", i + 1)], 0)
        end = _chain(rounds, row, bl_prev, cols[("r_u", i)], top)
        row += bl_prev
        if mdb >= 0:
            end = _chain(rounds, row, mdb, cols[("r_v", i)], end)
            row += mdb
        liu_end = _chain(rounds, row, bl_prev, cols[("r_liu", i)],
                         (REF_LIU, 0, 0))
        row += bl_prev
        liu = [[sig, cols[("claim_u", i)]]]
        bsig_bliu = (cols[("r_u", i)], bl_prev, sig, cols[("r_liu", i)])
        bliu = (cols[("r_liu", i)], bl_prev, -1, -1)
        segments = [(_seg(SEG_PRE, cc.layers[i - 1].size),
                     (bsig_bliu, None, None))]
        for j in range(i, depth):
            if cc.layers[j].max_dad_bit_length >= 0:
                liu.append([sig + j - i + 1, cols[("claims_v", j)] + i - 1])
            Lj = src.layers[j]
            ds = Lj.dad_size[i - 1] if i - 1 < len(Lj.dad_size) else 0
            if ds == 0:
                continue
            bt = (cols[("r_v", j)], Lj.dad_bit_length[i - 1],
                  sig + j - i + 1, -1)
            segments.append((_seg(SEG_DAD, ds, n_dads), (bt, bliu, None)))
            dads.append(varrs[f"vdad{j}_{i - 1}"])
            n_dads += ds
        tab.job(segments, rounds, liu, mul=cols[("liu_claim", i)],
                exp=liu_end, mid=k, mid_ref=end)
    cols.add(("out",), 1 << bl_out)
    tab.job([(_seg(SEG_OUT, 1 << bl_out, cols[("out",)]),
              ((cols[("r_out",)], bl_out, -1, -1), None, None))],
            exp=(REF_COL, cols[("vres",)], 0), tree=True)
    return KernelPlan("gkr_verify_fast", cols, tab, len(layers), device, sms,
                      idx=_i32(dads, device), n_rows=row,
                      layers=len(layers))


def _slow_plan(cc, varrs, device, sms) -> KernelPlan:
    """gkr_verify_slow's plan: a job a layer, top down, each one gate
    segment; the gate arrays (x | ASSERT_BIT on an assert gate, lv, sl,
    the coefficients (8, gates)) over every layer."""
    depth = cc.depth
    cols = _Cols()
    cols.add(("r_out",), cc.layers[depth - 1].bit_length)
    layers = list(range(depth - 1, 0, -1))
    for i in layers:
        L, bl_prev = cc.layers[i], cc.layers[i - 1].bit_length
        cols.add(("r_u", i), bl_prev)
        if L.max_dad_bit_length >= 0:
            cols.add(("r_v", i), L.max_dad_bit_length)
        if i >= 2:
            cols.add(("r_liu", i), bl_prev)
        if L.has_assert:
            cols.add(("assert_r", i), 1)
        cols.add(("claim_u", i), 1)
        if L.max_dad_bit_length >= 0:
            cols.add(("claims_v", i), i)
    for k in range(len(layers)):
        cols.add(("mid", k), 1)
    tab = _Tables()
    gx, glv, gsl, coef = [], [], [], []
    off = 0
    for k, i in enumerate(layers):
        L, bl_prev = cc.layers[i], cc.layers[i - 1].bit_length
        mdb = L.max_dad_bit_length
        r_cur = (cols[("r_out",)] if i == depth - 1
                 else cols[("r_liu", i + 1)])
        x = varrs[f"vx{i}"].to(torch.int32)
        if L.has_assert:
            x = x | (varrs[f"via{i}"][:L.size].to(torch.int32)
                     * torch.tensor(-ASSERT_BIT, dtype=torch.int32,
                                    device=device))
        zeros = torch.zeros((L.size,), dtype=torch.int32, device=device)
        gx.append(x)
        glv.append(varrs[f"vlv{i}"] if mdb >= 0 else zeros)
        gsl.append(varrs[f"vsl{i}"] if mdb >= 0 else zeros)
        coef.append(varrs[f"vco{i}"].reshape(8, L.size))
        seg = _seg(SEG_GATE, L.size, off,
                   a=cols[("assert_r", i)] if L.has_assert else -1,
                   cu=cols[("claim_u", i)],
                   cv=cols[("claims_v", i)] if mdb >= 0 else -1,
                   ncv=i if mdb >= 0 else 0)
        keys = ((r_cur, L.bit_length, -1, -1),
                (cols[("r_u", i)], bl_prev, -1, -1),
                (cols[("r_v", i)], mdb, -1, -1) if mdb >= 0 else None)
        tab.job([(seg, keys)], exp=(REF_COL, cols[("mid", k)], 0),
                tree=True)
        off += L.size
    gates = (_i32(gx, device), _i32(glv, device), _i32(gsl, device),
             torch.cat(coef, dim=1) if coef else None)
    return KernelPlan("gkr_verify_slow", cols, tab, len(layers), device, sms,
                      gates=gates if coef else None, layers=len(layers))


def _sm_count(dev) -> int:
    """The card's multiprocessors; DEFAULT_SMS for a plan on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return DEFAULT_SMS


class VerifierPlan:
    """A circuit's verifier plan on one device: the twins' circuit and
    ``verifier_arrays``, and the two programs' kernel plans ``fast`` and
    ``slow``, their items sized for the device's multiprocessors."""

    def __init__(self, cc, varrs, device):
        self.cc, self.varrs = cc, varrs
        self.device = torch.device(device)
        sms = _sm_count(self.device)
        self.fast = _fast_plan(cc, varrs, self.device, sms)
        self.slow = _slow_plan(cc, varrs, self.device, sms)


# (id of a compiled circuit, device) -> its VerifierPlan, dropped with the
# circuit
_PLANS: dict = {}


def plan(cc, varrs, device) -> VerifierPlan:
    """The circuit's verifier plan on `device`, made once (varrs:
    ``protocol.verifier_arrays(cc, device)``)."""
    key = (id(cc), str(torch.device(device)))
    if key not in _PLANS:
        _PLANS[key] = VerifierPlan(cc, varrs, device)
        weakref.finalize(cc, _PLANS.pop, key, None)
    return _PLANS[key]


# ---------------------------------------------------------------------------
# Inputs of a call
# ---------------------------------------------------------------------------

def _cols2(t, what: str, width: int):
    """t's first `width` columns as a (2, width) view; raises unless t is
    (2, >= width)."""
    if t is None or t.dim() != 2 or t.shape[0] != 2 or t.shape[1] < width:
        raise ValueError(f"gkr_verify: {what} is "
                         f"{None if t is None else tuple(t.shape)}, (2, >= "
                         f"{width}) taken")
    return t[:, :width]


def _exact(t, what: str, shape):
    if t is None or tuple(t.shape) != tuple(shape):
        raise ValueError(f"gkr_verify: {what} is "
                         f"{None if t is None else tuple(t.shape)}, {shape} "
                         f"taken")
    return t


def _piece(key, width, proof, ch, out, mids):
    """One c0 piece (2, width) of a call, checked against the plan."""
    kind = key[0]
    if kind == "vres":
        return _exact(proof.vres, "vres", (2,)).reshape(2, 1)
    if kind == "r_out":
        return _exact(ch.r_out, "r_out", (2, width))
    if kind == "out":
        return _cols2(out, "the output block", width)
    if kind == "mid":
        return _exact(mids[key[1]], "a mid", (2,)).reshape(2, 1)
    i = key[1]
    lp, lc = proof.layers[i], ch.layers[i]
    what = f"layer {i}'s {kind}"
    if kind in ("claim_u", "liu_claim"):
        return _exact(getattr(lp, kind), what, (2,)).reshape(2, 1)
    if kind == "claims_v":
        return _exact(lp.claims_v, what, (width, 2)).t()
    if kind == "assert_r":
        return _exact(lc.assert_r, what, (2,)).reshape(2, 1)
    return _cols2(getattr(lc, kind), what, width)


def _c0(kp: KernelPlan, proof, ch, out=None, mids=None):
    """c0 (2, NC): the plan's pieces side by side, one ``torch.cat``."""
    return torch.cat([_piece(key, w, proof, ch, out, mids)
                      for key, w in kp.cols.pieces
                      if key != ("out",) or out is not None], dim=1)


def _polys(cc, proof):
    """Every layer's phase-1, phase-2 and Liu polynomials, top down, as
    rows of one (R, 2, 3) tensor: one ``torch.cat``."""
    parts = []
    for i in range(cc.depth - 1, 0, -1):
        lp, bl_prev = proof.layers[i], cc.layers[i - 1].bit_length
        mdb = cc.layers[i].max_dad_bit_length
        parts.append(_exact(lp.p1_polys, f"layer {i}'s p1_polys",
                            (bl_prev, 2, 3)))
        if mdb >= 0:
            parts.append(_exact(lp.p2_polys, f"layer {i}'s p2_polys",
                                (mdb, 2, 3)))
        elif lp.p2_polys is not None or lp.claims_v is not None:
            raise ValueError(f"gkr_verify: layer {i} has no dads, but its "
                             f"proof has phase-2 messages")
        parts.append(_exact(lp.liu_polys, f"layer {i}'s liu_polys",
                            (bl_prev, 2, 3)))
    return torch.cat(parts, dim=0)


def _final(cc, proof, ch):
    """(final_claim, final_point) as the twin gives them: the bottom
    layer's Liu claim and its r_liu cut to the input's bits."""
    if cc.depth < 2:
        return proof.vres, ch.r_out
    return (proof.layers[1].liu_claim,
            ch.layers[1].r_liu[:, :cc.layers[0].bit_length])


# ---------------------------------------------------------------------------
# The entries: dispatch, kernels, plain twins
# ---------------------------------------------------------------------------

def _on_cuda(proof) -> bool:
    t = proof.vres.device.type
    if t == "cuda":
        return True
    if t == "cpu":
        return False
    raise ValueError(f"gkr_verify: no kernels for device {proof.vres.device}")


def verify_fast(vp: VerifierPlan, proof, ch, output_values=None):
    """Every layer's succinct checks (and the output block's, when given):
    (ok (bool tensor), mids (a (2,) tensor a layer, top down), final_claim,
    final_point)."""
    fn = verify_fast_cuda if _on_cuda(proof) else verify_fast_plain
    return fn(vp, proof, ch, output_values)


def verify_slow(vp: VerifierPlan, proof, ch, mids):
    """Every layer's predicate sweep against its mid: ok (bool tensor)."""
    fn = verify_slow_cuda if _on_cuda(proof) else verify_slow_plain
    return fn(vp, proof, ch, mids)


_SCRATCH = {}   # (device, stream) -> (scratch words, jobs, items)
_RETIRED = []   # outgrown scratch: a captured graph may still use it


def _scratch(dev, jobs: int, items: int) -> tuple:
    """(address, jobs, items) of the current stream's scratch for a launch
    of `jobs` jobs and `items` items: the arrival word, a count a job,
    an expected value a job and a partial sum an item.  The words are
    zeroed once here and the counts are zero after every launch, since the
    last item of each job and the last job put them back.  None is made
    inside a capture: the eager call on the capturing stream before it
    makes it (graphs.py)."""
    key = (dev, kernels.stream_ptr())
    s = _SCRATCH.get(key)
    if s is None or s[1] < jobs or s[2] < items:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gkr_verify: no scratch for this plan on the "
                               "capturing stream; an eager call on that "
                               "stream makes it first")
        if s is not None:
            _RETIRED.append(s[0])
        nj, ni = max(jobs, 64, s[1] if s else 0), max(items, 1024,
                                                     s[2] if s else 0)
        s = _SCRATCH[key] = (torch.zeros((1 + 3 * nj + 2 * ni,),
                                         dtype=torch.int64, device=dev),
                             nj, ni)
    return s[0].data_ptr(), s[1], s[2]


def _launch(kp: KernelPlan, c0, polys, jobs: int, mids_out=None):
    """One launch of kp's entry over `jobs` jobs (a block an item of
    theirs); returns ok."""
    dev = c0.device
    if dev.type != "cuda":
        raise ValueError("gkr_verify: a card's plan and CUDA tensors taken")
    for t in [c0, polys] + kp.all_tensors():
        if t is not None and t.device != dev:
            raise ValueError(f"{kp.entry}: every tensor on one CUDA device")
    if any(t is not None and t.dtype != torch.int64 for t in (c0, polys)):
        raise TypeError(f"{kp.entry}: expected int64 proof and challenge "
                        f"words")
    ok = torch.empty((), dtype=torch.bool, device=dev)
    items = kp.items_of(jobs)
    kernels.check_int(kp.entry, items=items, columns=c0.shape[1],
                      gates=kp.g_total)
    scratch, jobs_cap, items_cap = _scratch(dev, jobs, items)
    p = lambda t: None if t is None else t.data_ptr()
    T = kp.tensors
    kernels.launch(kp.entry, 1, c0.data_ptr(), c0.shape[1], p(polys),
                   *(T[k].data_ptr() for k in KERNEL_TABLES),
                   kp.idx.data_ptr(), kp.gx.data_ptr(), kp.glv.data_ptr(),
                   kp.gsl.data_ptr(), kp.coef.data_ptr(), kp.g_total, jobs,
                   items, kp.table_words, kp.half_words, jobs_cap, items_cap,
                   p(mids_out), ok.data_ptr(), scratch, kernels.stream_ptr())
    return ok


def verify_fast_cuda(vp: VerifierPlan, proof, ch, output_values=None):
    """gkr_verify_fast on the card, one launch: same signature and bits
    as verify_fast_plain (on canonical output words)."""
    kp = vp.fast
    polys = _polys(vp.cc, proof)
    c0 = _c0(kp, proof, ch, output_values)
    mids = torch.empty((kp.layers, 2), dtype=torch.int64, device=c0.device)
    ok = _launch(kp, c0, polys, kp.n_jobs + (output_values is not None),
                 mids)
    return (ok, [mids[k] for k in range(kp.layers)]) + _final(vp.cc, proof,
                                                              ch)


def verify_slow_cuda(vp: VerifierPlan, proof, ch, mids):
    """gkr_verify_slow on the card, one launch: same signature and bits
    as verify_slow_plain (on canonical claims)."""
    kp = vp.slow
    if len(mids) != kp.layers:
        raise ValueError(f"gkr_verify_slow: {len(mids)} mids for "
                         f"{kp.layers} layers")
    c0 = _c0(kp, proof, ch, mids=mids)
    return _launch(kp, c0, None, kp.n_jobs)


def verify_fast_plain(vp: VerifierPlan, proof, ch, output_values=None):
    """Plain twin of gkr_verify_fast: the JAX ``_verify_fast_all``'s walk
    (``protocol.verify_layer_fast`` a layer, ``_output_ok``) on ``gf``'s
    plain ops, so that on the card it launches no kernel of its own."""
    from . import protocol      # protocol dispatches to this module
    kernels.PLAIN_CALLS["gkr_verify_fast"] += 1
    cc = vp.cc
    previous_sum = proof.vres
    ok = protocol._output_ok(proof, ch, output_values)
    r_cur = ch.r_out
    mids = []
    for i in range(cc.depth - 1, 0, -1):
        ok_i, mid, previous_sum = protocol.verify_layer_fast(
            cc, i, proof.layers[i], r_cur, ch.layers[i], previous_sum,
            proof, ch, vp.varrs)
        ok = ok & ok_i
        mids.append(mid)
        r_cur = ch.layers[i].r_liu[:, :cc.layers[i - 1].bit_length]
    return ok, mids, previous_sum, r_cur


def verify_slow_plain(vp: VerifierPlan, proof, ch, mids):
    """Plain twin of gkr_verify_slow: the JAX ``_verify_slow_all``'s
    sweeps (``protocol.predicate_check`` a layer) on ``gf``'s plain
    ops."""
    from . import protocol
    kernels.PLAIN_CALLS["gkr_verify_slow"] += 1
    cc = vp.cc
    ok = torch.ones((), dtype=torch.bool, device=proof.vres.device)
    r_cur = ch.r_out
    for k, i in enumerate(range(cc.depth - 1, 0, -1)):
        ok = ok & protocol.predicate_check(cc, i, proof.layers[i], r_cur,
                                           ch.layers[i], mids[k], vp.varrs)
        r_cur = ch.layers[i].r_liu[:, :cc.layers[i - 1].bit_length]
    return ok

