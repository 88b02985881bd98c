"""The GKR verifier's two programs, one kernel launch each: every layer's
succinct checks (``gkr_verify_fast``) and every layer's predicate sweep
(``gkr_verify_slow``).

Counterpart of the JAX verifier jits ``_verify_fast_all`` and
``_verify_slow_all`` (``virgo_plus_tpu/gkr/protocol.py:894``, :917), whose
round checks, Liu sums and predicate sweeps XLA fuses.  Here:

* ``plan(cc, varrs, device)``: the flat plan of a circuit, made once per
  circuit and device (``protocol.make_verifier``): host numpy tables of
  jobs, stages, beta tables and their parts, term segments, rounds and
  Liu terms, as int32 tensors on the device, and the predicate sweep's
  gate arrays and the Liu sums' dad lists, cats of ``verifier_arrays``'
  tensors;
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
(at most PART_BITS bits a part), of part_p[the bits of g in part p]; each
part's 2^w entries are built in shared memory by every block.  A table's
init (sig, for bsig and each bt) multiplies its first part's entries, as
``beta_table(r, k, init)`` has it: the field is exact, so the product of
the parts is the twin's table.  Every product and sum of canonical inputs is canonical,
so sums in any order give the twins' bits; every step that reads proof
words is the plain op's own (``csrc/gf_int64.cuh``) in the twins' order,
so the rounds, liu_sum and the checks' products equal the twins' on any
int64 words, and the sweeps' and the output block's sums do on canonical
claims and output words.

A job is one cluster of ``cluster`` blocks: a layer of the fast program
(its rounds and gr), the output block, or a layer of the slow program.
A stage is up to STAGE_SEGS of its segments whose tables fit STAGE_WORDS
words of shared memory; its segments' terms are one range, cut over the
cluster's threads.  Value
references name a c0 column (REF_COL), a round polynomial at a c0 column
(REF_EVAL: p(r)) or the job's liu_sum (REF_LIU).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import kernels

# csrc/gkr_verify.cu: a block's threads, the most blocks of a cluster, a
# beta part's most bits, a stage's most table words and segments, an
# assert gate's bit
THREADS = 512
MAX_CLUSTER = 8
PART_BITS = 8
STAGE_WORDS = 12288
STAGE_SEGS = 32
ASSERT_BIT = 1 << 31

REF_COL, REF_EVAL, REF_LIU = range(3)
SEG_PRE, SEG_DAD, SEG_OUT, SEG_GATE = range(4)
# int32 fields of a job, stage, beta part, table, segment, round and Liu
# term (csrc/gkr_verify.cu's enums, in the same order)
JOB_FIELDS = ("J_STAGE0", "J_STAGE1", "J_ROUND0", "J_ROUND1", "J_LIU0",
              "J_LIU1", "J_MUL", "J_EXP", "J_EXP_A", "J_EXP_B", "J_MID",
              "J_MID_KIND", "J_MID_A", "J_MID_B")
STAGE_FIELDS = ("S_PART0", "S_PART1", "S_ENTRIES", "S_SEG0", "S_SEG1",
                "S_TERMS")
PART_FIELDS = ("P_COL", "P_W", "P_BASE", "P_FIRST", "P_SCALE")
TABLE_FIELDS = ("T_COL", "T_BITS", "T_SMEM", "T_SCALE")
SEG_FIELDS = ("G_KIND", "G_N", "G_FIRST", "G_OFF", "G_TA", "G_TB", "G_TC",
              "G_ASSERT", "G_CU", "G_CV")
ROUND_FIELDS = ("R_ROW", "R_COL", "R_KIND", "R_A", "R_B")
LIU_FIELDS = ("L_SIG", "L_CLAIM")
(J_STAGE0, J_STAGE1, J_ROUND0, J_ROUND1, J_LIU0, J_LIU1, J_MUL, J_EXP,
 J_EXP_A, J_EXP_B, J_MID, J_MID_KIND, J_MID_A, J_MID_B) = range(14)
S_PART0, S_PART1, S_ENTRIES, S_SEG0, S_SEG1, S_TERMS = range(6)
P_COL, P_W, P_BASE, P_FIRST, P_SCALE = range(5)
T_COL, T_BITS, T_SMEM, T_SCALE = range(4)
(G_KIND, G_N, G_FIRST, G_OFF, G_TA, G_TB, G_TC, G_ASSERT, G_CU,
 G_CV) = range(10)
R_ROW, R_COL, R_KIND, R_A, R_B = range(5)
L_SIG, L_CLAIM = range(2)


def part_widths(k: int) -> list:
    """The bits of each part of a k-bit beta table: ceil(k / PART_BITS)
    parts (one for k = 0), the first k mod n one bit wider."""
    n = max(1, -(-k // PART_BITS))
    return [k // n + (p < k % n) for p in range(n)]


def table_words(k: int) -> int:
    return 2 * sum(1 << w for w in part_widths(k))


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
        self.max_words = 0
        self.max_terms = 0

    def job(self, segments, rounds=(), liu=(), mul=-1, exp=(REF_COL, 0, 0),
            mid=-1, mid_ref=(REF_COL, 0, 0)):
        """One job: its segments [(row, table keys (col, k, init column or
        -1) of TA, TB, TC or None)], packed into stages of at most
        STAGE_WORDS table words and STAGE_SEGS segments, its rounds and Liu
        terms, the check's factor column (or -1), its expected and mid
        references and mid's output row (or -1).  A table's init scales
        its first part's entries."""
        first_stage, first_round = len(self.stages), len(self.rounds)
        first_liu = len(self.liu)
        self.rounds += rounds
        self.liu += liu
        cur, words, entries, terms = {}, 0, 0, 0
        first_part, first_seg = len(self.parts), len(self.segs)

        def close():
            self.stages.append([first_part, len(self.parts), entries,
                                first_seg, len(self.segs), terms])
            self.max_words = max(self.max_words, words)
            self.max_terms = max(self.max_terms, terms)

        for row, keys in segments:
            new = [k for k in dict.fromkeys(x for x in keys if x is not None)
                   if k not in cur]
            need = sum(table_words(k) for _, k, _ in new)
            if cur and (words + need > STAGE_WORDS
                        or len(self.segs) - first_seg == STAGE_SEGS):
                close()
                cur, words, entries, terms = {}, 0, 0, 0
                first_part, first_seg = len(self.parts), len(self.segs)
                new = list(dict.fromkeys(x for x in keys if x is not None))
                need = sum(table_words(k) for _, k, _ in new)
            if need > STAGE_WORDS:
                raise ValueError(f"gkr_verify: beta tables of {need} words "
                                 f"exceed a stage's {STAGE_WORDS}")
            for col, k, init in new:
                cur[(col, k, init)] = len(self.tables)
                self.tables.append([col, k, words, init])
                off = 0
                for w in part_widths(k):
                    self.parts.append([col + off, w, words, entries,
                                       init if off == 0 else -1])
                    words += 2 << w
                    entries += 1 << w
                    off += w
            row = list(row)
            row[G_FIRST] = terms
            terms += row[G_N]
            for f, key in zip((G_TA, G_TB, G_TC), keys):
                row[f] = -1 if key is None else cur[key]
            self.segs.append(row)
        if segments:
            close()
        self.jobs.append([first_stage, len(self.stages), first_round,
                          len(self.rounds), first_liu, len(self.liu), mul,
                          *exp, mid, *mid_ref])


def _seg(kind, n, off=0, a=-1, cu=-1, cv=-1):
    row = [0] * len(SEG_FIELDS)
    row[G_KIND], row[G_N], row[G_OFF] = kind, n, off
    row[G_ASSERT], row[G_CU], row[G_CV] = a, cu, cv
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
    device tensors (``tensors``), and the launch's shape."""

    def __init__(self, entry, cols, tab, n_jobs, device, idx=None,
                 gates=None, n_rows=0, layers=0):
        self.entry = entry
        self.cols = cols
        self.n_jobs = n_jobs             # jobs without the output block
        self.n_rows = n_rows             # round polynomial rows (fast)
        self.layers = layers
        self.smem_words = tab.max_words
        # the blocks of a job's cluster: enough for its largest stage at
        # one term a thread, at most MAX_CLUSTER
        need = -(-max(tab.max_terms, 1) // THREADS)
        self.cluster = min(MAX_CLUSTER, 1 << (need - 1).bit_length())
        self.host = {name: np.asarray(rows, dtype=np.int32).reshape(
            -1, len(fields))
            for name, rows, fields in (
                ("jobs", tab.jobs, JOB_FIELDS),
                ("stages", tab.stages, STAGE_FIELDS),
                ("parts", tab.parts, PART_FIELDS),
                ("tables", tab.tables, TABLE_FIELDS),
                ("segs", tab.segs, SEG_FIELDS),
                ("rounds", tab.rounds, ROUND_FIELDS),
                ("liu", tab.liu, LIU_FIELDS))}
        self.tensors = {k: torch.from_numpy(v).to(device)
                        for k, v in self.host.items()}
        empty32 = torch.zeros((1,), dtype=torch.int32, device=device)
        self.idx = idx if idx is not None and idx.numel() else empty32
        gx, glv, gsl, coef = gates or (empty32,) * 3 + (
            torch.zeros((8, 1), dtype=torch.int64, device=device),)
        self.gx, self.glv, self.gsl, self.coef = gx, glv, gsl, coef
        self.g_total = coef.shape[1]

    def all_tensors(self):
        return list(self.tensors.values()) + [self.idx, self.gx, self.glv,
                                              self.gsl, self.coef]


def _i32(parts, device):
    return (torch.cat([p.to(torch.int32) for p in parts]) if parts
            else torch.zeros((0,), dtype=torch.int32, device=device))


def _fast_plan(cc, varrs, device) -> KernelPlan:
    """gkr_verify_fast's plan: a job a layer, top down, then the output
    block's job (launched only with an output block)."""
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
    tab, rounds_all, dads = _Tables(), [], []
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
        bsig = (cols[("r_u", i)], bl_prev, sig)
        bliu = (cols[("r_liu", i)], bl_prev, -1)
        segments = [(_seg(SEG_PRE, cc.layers[i - 1].size),
                     (bsig, bliu, None))]
        for j in range(i, depth):
            if cc.layers[j].max_dad_bit_length >= 0:
                liu.append([sig + j - i + 1, cols[("claims_v", j)] + i - 1])
            Lj = src.layers[j]
            ds = Lj.dad_size[i - 1] if i - 1 < len(Lj.dad_size) else 0
            if ds == 0:
                continue
            bt = (cols[("r_v", j)], Lj.dad_bit_length[i - 1],
                  sig + j - i + 1)
            segments.append((_seg(SEG_DAD, ds, n_dads), (bt, bliu, None)))
            dads.append(varrs[f"vdad{j}_{i - 1}"])
            n_dads += ds
        tab.job(segments, rounds, liu, mul=cols[("liu_claim", i)],
                exp=liu_end, mid=k, mid_ref=end)
    cols.add(("out",), 1 << bl_out)
    tab.job([(_seg(SEG_OUT, 1 << bl_out, cols[("out",)]),
              ((cols[("r_out",)], bl_out, -1), None, None))],
            exp=(REF_COL, cols[("vres",)], 0))
    return KernelPlan("gkr_verify_fast", cols, tab, len(layers), device,
                      idx=_i32(dads, device), n_rows=row,
                      layers=len(layers))


def _slow_plan(cc, varrs, device) -> KernelPlan:
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
                   cv=cols[("claims_v", i)] if mdb >= 0 else -1)
        keys = ((r_cur, L.bit_length, -1), (cols[("r_u", i)], bl_prev, -1),
                (cols[("r_v", i)], mdb, -1) if mdb >= 0 else None)
        tab.job([(seg, keys)], exp=(REF_COL, cols[("mid", k)], 0))
        off += L.size
    gates = (_i32(gx, device), _i32(glv, device), _i32(gsl, device),
             torch.cat(coef, dim=1) if coef else None)
    return KernelPlan("gkr_verify_slow", cols, tab, len(layers), device,
                      gates=gates if coef else None, layers=len(layers))


class VerifierPlan:
    """A circuit's verifier plan on one device: the twins' circuit and
    ``verifier_arrays``, and the two programs' kernel plans ``fast`` and
    ``slow``."""

    def __init__(self, cc, varrs, device):
        self.cc, self.varrs = cc, varrs
        self.device = torch.device(device)
        self.fast = _fast_plan(cc, varrs, self.device)
        self.slow = _slow_plan(cc, varrs, self.device)


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


_TICKETS = {}   # (device, stream) -> an entry's arrival word


def _ticket(dev) -> int:
    """Address of the arrival word of the current stream: zeroed once
    here, and zero after every launch, since the last cluster to arrive
    puts it back.  None is made inside a capture: the eager call on the
    capturing stream before it makes it (graphs.py)."""
    key = (dev, kernels.stream_ptr())
    t = _TICKETS.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gkr_verify: no arrival word on the "
                               "capturing stream; an eager call on that "
                               "stream makes it first")
        t = _TICKETS[key] = torch.zeros((1,), dtype=torch.int64, device=dev)
    return t.data_ptr()


def _launch(kp: KernelPlan, c0, polys, jobs: int, mids_out=None):
    """One launch of kp's entry over `jobs` jobs; returns ok."""
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
    kernels.check_int(kp.entry, jobs=max(jobs, 1) * kp.cluster,
                      columns=c0.shape[1], gates=kp.g_total)
    p = lambda t: None if t is None else t.data_ptr()
    T = kp.tensors
    kernels.launch(kp.entry, 1, c0.data_ptr(), c0.shape[1], p(polys),
                   *(T[k].data_ptr() for k in ("jobs", "stages", "parts",
                                               "tables", "segs", "rounds",
                                               "liu")),
                   kp.idx.data_ptr(), kp.gx.data_ptr(), kp.glv.data_ptr(),
                   kp.gsl.data_ptr(), kp.coef.data_ptr(), kp.g_total, jobs,
                   kp.cluster, kp.smem_words, p(mids_out), ok.data_ptr(),
                   _ticket(dev), kernels.stream_ptr())
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

