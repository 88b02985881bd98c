"""The GKR verifier's programs (``gkr/vchecks.py``: ``gkr_verify_fast``,
``gkr_verify_slow``) on the CPU: the plain twins against the JAX package,
and a model of the kernels' decomposition against the twins.

* The twins (``verify_fast_plain``, ``verify_slow_plain``, which a CPU
  proof reaches through ``protocol._verify_fast_all`` / ``_verify_slow_all``)
  == the JAX ``_verify_fast_all`` / ``_verify_slow_all`` run eagerly, in
  ok, mids, the final claim and the final point, with and without an
  output block, on randomize(4, 3, seed=7) and on randomize(4, 5, seed=7)
  with zero-valued assert gates on layer 2 and layer 1 without dads (the
  JAX references each in a process of their own).
* ``model``, a Python-int copy of ``csrc/gkr_verify.cu``'s schedule (its
  constants and field layouts read from the source): the flat plan's c0
  pieces, tables, stages, parts and segments as the kernel reads them; each
  stage's beta parts built entry by entry, every table's product of parts
  == ``beta.beta_table``; a segment's terms cut over a cluster's threads,
  scaled once after the sum (bsig's and each bt's init), the threads' and
  the blocks' partial sums added in a shuffled order; every round checked
  on its own against its reference; liu_sum in the twin's order; each
  job's check and mid; the jobs' verdicts ANDed.  Its ok and mids == the
  twins', on the two circuits above and randomize(3, 11, seed=2) (a
  cluster of 4 or 8 blocks a job), also with stages forced small.
* Tampers: one word changed in p1_polys, p2_polys, liu_polys, claim_u,
  claims_v, liu_claim and vres, and a wrong output block, each rejected
  by the twin and by the model, which agree on every output.
* The CUDA wrappers refuse CPU tensors, and a CPU proof counts
  ``kernels.PLAIN_CALLS``.

Inputs are canonical (the circuits' witnesses, one word bumped by one mod
p); field arithmetic is exact, so the tolerance is 0.  The kernels run
only on a card: chip_smoke.py holds them against the twins there."""

import dataclasses
import multiprocessing as mp
import random
import re
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from virgo_plus_tpu_torch import convert, driver, kernels
from virgo_plus_tpu_torch.circuits.compile import input_buffer
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import chains, gf
from virgo_plus_tpu_torch.gkr import protocol, vchecks as v
from virgo_plus_tpu_torch.gkr.beta import beta_table
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
SOURCE = (Path(v.__file__).resolve().parent.parent / "csrc"
          / "gkr_verify.cu").read_text()
JAX_CIRCUITS = ("randomize(4, 3, seed=7)", "asserts, no dads")
CIRCUITS = JAX_CIRCUITS + ("randomize(3, 11, seed=2)",)
TAMPERS = ("p1_polys", "p2_polys", "liu_polys", "claim_u", "claims_v",
           "liu_claim", "vres", "output block")


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _circuit(name):
    if name == "asserts, no dads":
        c = randomize(4, 5, seed=7)
        L, g = c.layers[2], [1, 5, 9, 12]
        L.is_assert[g] = True
        # Sub gates of a node of layer 1 and itself: zero, as an assert
        # gate of an honest proof must be
        L.ty[g], L.l[g], L.v[g] = 2, 1, L.u[g]
        c.layers[1].l[:], c.layers[1].ty[:] = -1, 11     # Copy: no dads
    else:
        n, b, seed = map(int, re.findall(r"\d+", name))
        c = randomize(n, b, seed=seed)
    subset_init(c)
    return c


def _jax_job(name, proof, block):
    """The JAX ``_verify_fast_all`` (without and with the output block) and
    ``_verify_slow_all`` run eagerly on the port's proof, in a process of
    its own: {form: numpy arrays}."""
    import jax.numpy as jnp
    from virgo_plus_tpu.circuits.compile import compile_circuit as jcompile
    from virgo_plus_tpu.gkr import protocol as jp
    from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc

    jcc = jcompile(_circuit(name))
    ch = jp.make_challenges(jcc, JGlibc(3396))
    J = lambda a: None if a is None else jnp.asarray(a)
    pf = jp.Proof(vres=J(proof["vres"]), layers=[None] + [
        jp.LayerProof(**{f: J(x) for f, x in lp.items()})
        for lp in proof["layers"][1:]])
    va = jp.verifier_arrays(jcc)
    out = {}
    for form, ob in (("no_out", None), ("out", J(block))):
        ok, mids, claim, point = jp._verify_fast_all(jcc, pf, ch, ob, va)
        out[form] = [np.asarray(x) for x in (ok, claim, point, *mids)]
    out["slow"] = np.asarray(jp._verify_slow_all(jcc, pf, ch, mids, va))
    return out


def _bump(t, idx):
    a = gf.to_numpy(t).copy()
    a[idx] = np.uint64((int(a[idx]) + 1) % M)
    return gf.tensor(a)


def _tampered(cc, proof, what):
    """The proof with one word of `what` changed (a middle layer's claims
    and phase-2 messages, the top layer's p1_polys, layer 1's liu_polys)."""
    top = cc.depth - 1
    mid = next(i for i in range(max(1, cc.depth // 2), cc.depth)
               if proof.layers[i].p2_polys is not None)
    if what == "vres":
        return protocol.Proof(vres=_bump(proof.vres, (0,)),
                              layers=proof.layers)
    i, idx = {"p1_polys": (top, (0, 0, 1)), "liu_polys": (1, (0, 1, 0)),
              "p2_polys": (mid, (0, 1, 2)), "claims_v": (mid, (0, 1)),
              "claim_u": (mid, (1,)), "liu_claim": (mid, (0,))}[what]
    layers = list(proof.layers)
    layers[i] = dataclasses.replace(
        layers[i], **{what: _bump(getattr(layers[i], what), idx)})
    return protocol.Proof(vres=proof.vres, layers=layers)


@pytest.fixture(scope="module")
def runs():
    """Each circuit's port proof, challenges, output block and verifier
    plan; the JAX references of the first two
    circuits, each in a spawned process, made meanwhile."""
    def port(name):
        cp = driver.compile_prover(_circuit(name), device="cpu",
                                   graphed=False)
        cc = cp.cc
        values = cp.evaluator(input_buffer(cc, None, "cpu"))
        ch = protocol.make_challenges(cc, GlibcRandom(3396), "cpu")
        vp = v.VerifierPlan(cc, protocol.verifier_arrays(cc, "cpu"), "cpu")
        return dict(cc=cc, ch=ch, proof=cp.prover(values, ch), vp=vp,
                    out=values[:, int(cc.value_off[cc.depth - 1]):])

    out = {name: port(name) for name in JAX_CIRCUITS}
    with ProcessPoolExecutor(len(JAX_CIRCUITS),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {name: pool.submit(_jax_job, name,
                                     convert.proof_to_numpy(r["proof"]),
                                     gf.to_numpy(r["out"]))
                   for name, r in out.items()}
        for name in CIRCUITS[len(JAX_CIRCUITS):]:
            out[name] = port(name)
        for name, f in futures.items():
            out[name]["jax"] = f.result()
    return out


# ---------------------------------------------------------------------------
# The model of csrc/gkr_verify.cu
# ---------------------------------------------------------------------------

def _el(a, i=None):
    """(re, im) Python ints of a (2,) array or of column i of a (2, n)."""
    return (int(a[0]), int(a[1])) if i is None else (int(a[0, i]),
                                                      int(a[1, i]))


def _add(x, y):
    return ((x[0] + y[0]) % M, (x[1] + y[1]) % M)


def _mul(x, y):
    return gf._py_mul(x, y)


def _sub(x, y):
    return ((x[0] - y[0]) % M, (x[1] - y[1]) % M)


ONE, ZERO = (1, 0), (0, 0)


class Model:
    """csrc/gkr_verify.cu's schedule on Python ints: one program's launch
    over `jobs` jobs of kp on c0 (numpy u64 (2, NC)) and polys ((R, 2, 3)).
    ``tables`` keeps every table the stages built, by (col, bits)."""

    def __init__(self, kp, c0, polys, jobs, seed=0):
        self.kp, self.c0, self.polys, self.h = kp, c0, polys, kp.host
        self.threads = _constant("THREADS")
        self.rng = random.Random(seed)
        self.gates = (gf.to_numpy(kp.coef), kp.gx.numpy().view(np.uint32),
                      kp.glv.numpy(), kp.gsl.numpy())
        self.idx = kp.idx.numpy()
        self.tables = {}
        self.mids = {}
        self.sums = []
        self.ok = all([self.job(j) for j in range(jobs)])

    def col(self, c):
        return _el(self.c0, c)

    def poly(self, row):
        p = self.polys[row]
        return [(int(p[0, k]), int(p[1, k])) for k in range(3)]

    def resolve(self, kind, a, b, liu):
        if kind == v.REF_EVAL:
            pa, pb, pc = self.poly(a)
            x = self.col(b)
            return _add(_mul(_add(_mul(pa, x), pb), x), pc)
        return liu if kind == v.REF_LIU else self.col(a)

    def build(self, st):
        """A stage's shared memory: each part's entries at its words."""
        sm = [None] * (2 * self.kp.smem_words)
        first = st[v.S_PART0]
        for p in self.h["parts"][first:st[v.S_PART1]]:
            for e in range(1 << p[v.P_W]):
                f = ONE if p[v.P_SCALE] < 0 else self.col(p[v.P_SCALE])
                for b in range(p[v.P_W]):
                    r = self.col(p[v.P_COL] + b)
                    f = _mul(f, r if e >> b & 1 else _sub(ONE, r))
                assert sm[p[v.P_BASE] + 2 * e] is None   # written once
                sm[p[v.P_BASE] + 2 * e:p[v.P_BASE] + 2 * e + 2] = f
        entries = sum(1 << p[v.P_W]
                      for p in self.h["parts"][first:st[v.S_PART1]])
        assert entries == st[v.S_ENTRIES]
        return sm

    def beta(self, sm, t, g):
        k, base = (int(x) for x in self.h["tables"][t][v.T_BITS:
                                                       v.T_SMEM + 1])
        out, off = None, 0
        for w in v.part_widths(k):
            e = g >> off & (1 << w) - 1
            x = tuple(sm[base + 2 * e:base + 2 * e + 2])
            out = x if out is None else _mul(out, x)
            base += 2 << w
            off += w
        return out

    def term(self, sm, seg, t):
        kind, off = seg[v.G_KIND], int(seg[v.G_OFF])
        if kind == v.SEG_PRE:
            return _mul(self.beta(sm, seg[v.G_TA], t),
                        self.beta(sm, seg[v.G_TB], t))
        if kind == v.SEG_DAD:
            return _mul(self.beta(sm, seg[v.G_TA], t),
                        self.beta(sm, seg[v.G_TB], int(self.idx[off + t])))
        if kind == v.SEG_OUT:
            return _mul(self.col(off + t), self.beta(sm, seg[v.G_TA], t))
        coef, gx, glv, gsl = self.gates
        g = off + t
        x = int(gx[g])
        w = self.beta(sm, seg[v.G_TA], t)
        if x & v.ASSERT_BIT:
            w = _mul(w, self.col(seg[v.G_ASSERT]))
        w = _mul(w, self.beta(sm, seg[v.G_TB], x & (v.ASSERT_BIT - 1)))
        if seg[v.G_TC] >= 0:
            w = _mul(w, self.beta(sm, seg[v.G_TC], int(glv[g])))
        cu = self.col(seg[v.G_CU])
        cv = self.col(seg[v.G_CV] + int(gsl[g])) if seg[v.G_CV] >= 0 else ZERO
        A, B, C, D = ((int(coef[2 * c, g]), int(coef[2 * c + 1, g]))
                      for c in range(4))
        gate = _add(_add(_mul(A, cu), _mul(B, cv)),
                    _add(_mul(C, _mul(cu, cv)), D))
        return _mul(w, gate)

    def shuffled_sum(self, xs):
        xs = list(xs)
        self.rng.shuffle(xs)
        out = ZERO
        for x in xs:
            out = _add(out, x)
        return out

    def job(self, j):
        J = self.h["jobs"][j]
        n_thr = self.kp.cluster * self.threads
        acc = [ZERO] * n_thr           # each thread of the cluster
        for st in self.h["stages"][J[v.J_STAGE0]:J[v.J_STAGE1]]:
            sm = self.build(st)
            segs = self.h["segs"][st[v.S_SEG0]:st[v.S_SEG1]]
            for t in set(segs[:, v.G_TA:v.G_TC + 1].ravel()) - {-1}:
                col, k, _, init = (int(x) for x in self.h["tables"][t])
                self.tables[(col, k, init)] = [self.beta(sm, t, g)
                                               for g in range(1 << k)]
            # the stage's segments are one range of terms: term T of the
            # stage goes to the cluster's thread T mod (C threads)
            assert (segs[:, v.G_FIRST] == np.concatenate(
                [[0], np.cumsum(segs[:-1, v.G_N])])).all()
            assert segs[:, v.G_N].sum() == st[v.S_TERMS]
            for seg in segs:
                for t in range(int(seg[v.G_N])):
                    T = int(seg[v.G_FIRST]) + t
                    acc[T % n_thr] = _add(acc[T % n_thr],
                                          self.term(sm, seg, t))
        blocks = [self.shuffled_sum(acc[b * self.threads:
                                        (b + 1) * self.threads])
                  for b in range(self.kp.cluster)]
        total = self.shuffled_sum(blocks)
        self.sums.append(total)
        liu = None
        for pair in self.h["liu"][J[v.J_LIU0]:J[v.J_LIU1]]:
            p = _mul(self.col(pair[v.L_SIG]), self.col(pair[v.L_CLAIM]))
            liu = p if liu is None else _add(liu, p)
        good = True
        for r in self.h["rounds"][J[v.J_ROUND0]:J[v.J_ROUND1]]:
            a, b, c = self.poly(r[v.R_ROW])
            s = _add(_add(a, b), _add(c, c))
            good &= s == self.resolve(*r[v.R_KIND:v.R_B + 1], liu)
        lhs = (_mul(self.col(J[v.J_MUL]), total) if J[v.J_MUL] >= 0
               else total)
        good &= lhs == self.resolve(*J[v.J_EXP:v.J_EXP_B + 1], liu)
        if J[v.J_MID] >= 0:
            assert J[v.J_MID] not in self.mids
            self.mids[int(J[v.J_MID])] = self.resolve(
                *J[v.J_MID_KIND:v.J_MID_B + 1], liu)
        return good


def _model_verify(vp, proof, ch, out=None, seed=0):
    """(ok, mids, fast model) of the two programs' models."""
    polys = gf.to_numpy(v._polys(vp.cc, proof))
    c0 = gf.to_numpy(v._c0(vp.fast, proof, ch, out))
    jobs = vp.fast.n_jobs + (out is not None)
    fast = Model(vp.fast, c0, polys, jobs, seed)
    mids = [gf.tensor(np.array(fast.mids[k], dtype=np.uint64))
            for k in range(vp.fast.layers)]
    slow = Model(vp.slow, gf.to_numpy(v._c0(vp.slow, proof, ch, mids=mids)),
                 None, vp.slow.n_jobs, seed + 1)
    return fast.ok and slow.ok, mids, fast


def _twins(vp, proof, ch, out=None):
    ok, mids, claim, point = v.verify_fast_plain(vp, proof, ch, out)
    return bool(ok) and bool(v.verify_slow_plain(vp, proof, ch, mids)), \
        mids, claim, point


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["no_out", "out"])
@pytest.mark.parametrize("name", JAX_CIRCUITS)
def test_twins_match_jax(runs, name, form):
    """verify_fast_plain and verify_slow_plain, reached through
    protocol's programs on a CPU proof, == the JAX programs."""
    r = runs[name]
    out = r["out"] if form == "out" else None
    ok, mids, claim, point = protocol._verify_fast_all(
        r["cc"], r["proof"], r["ch"], out, r["vp"].varrs)
    want = r["jax"][form]
    got = [gf.to_numpy(x) if x.dtype != torch.bool else x.numpy()
           for x in (ok, claim, point, *mids)]
    assert len(got) == len(want) and bool(ok)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    slow = protocol._verify_slow_all(r["cc"], r["proof"], r["ch"], mids,
                                     r["vp"].varrs)
    assert bool(slow) and bool(slow) == bool(r["jax"]["slow"])


@pytest.mark.parametrize("stages", ["plan", "forced"])
@pytest.mark.parametrize("name", CIRCUITS)
def test_model_matches_twins(runs, name, stages, monkeypatch):
    """The kernels' schedule == the twins on the honest proof, with and
    without the output block, at the plan's stages and at stages forced
    to the words of the largest segment's tables (a stage a segment)."""
    r = runs[name]
    vp = r["vp"]
    if stages == "forced":
        monkeypatch.setattr(v, "STAGE_WORDS", max(
            sum(v.table_words(int(kp.host["tables"][t][v.T_BITS]))
                for t in set(g[v.G_TA:v.G_TC + 1]) - {-1})
            for kp in (vp.fast, vp.slow) for g in kp.host["segs"]))
        vp = v.VerifierPlan(r["cc"], vp.varrs, "cpu")
        assert len(vp.fast.host["stages"]) > len(vp.fast.host["jobs"])
    for out in (None, r["out"]):
        ok, mids, _ = _model_verify(vp, r["proof"], r["ch"], out)
        want = _twins(vp, r["proof"], r["ch"], out)
        assert ok and want[0]
        assert all(torch.equal(a, b) for a, b in zip(mids, want[1]))
    assert (vp.slow.cluster > 1) == ("11" in name)


@pytest.mark.parametrize("name", CIRCUITS)
def test_model_parts_and_sums(runs, name):
    """Every table the stages built (the product of its parts, the first
    scaled by the table's init) == beta.beta_table of its challenges and
    init, and each layer's gr (the sum of the cluster's partial sums) ==
    the twin's sums of bsig and each bt."""
    r = runs[name]
    vp, cc, ch, proof = r["vp"], r["cc"], r["ch"], r["proof"]
    _, _, fast = _model_verify(vp, proof, ch, r["out"], seed=5)
    c0 = v._c0(vp.fast, proof, ch, r["out"])
    assert fast.tables
    for (col, k, init), entries in fast.tables.items():
        want = gf.to_numpy(beta_table(
            c0[:, col:col + k], k,
            gf.ones(()) if init < 0 else c0[:, init]))
        assert [tuple(int(x) for x in want[:, g]) for g in range(1 << k)] \
            == entries
    src = cc.source
    for job, i in enumerate(range(cc.depth - 1, 0, -1)):
        lc, bl = ch.layers[i], cc.layers[i - 1].bit_length
        pre = cc.layers[i - 1].size
        bliu = beta_table(lc.r_liu, bl, gf.ones(()))
        gr = chains.tree_sum_plain(gf.mul(
            beta_table(lc.r_u, bl, lc.sig[:, 0])[:, :pre], bliu[:, :pre]))
        for j in range(i, cc.depth):
            ds = (src.layers[j].dad_size[i - 1]
                  if i - 1 < len(src.layers[j].dad_size) else 0)
            if ds:
                bj = src.layers[j].dad_bit_length[i - 1]
                bt = beta_table(ch.layers[j].r_v, bj, lc.sig[:, j - i + 1])
                gr = gf.add(gr, chains.tree_sum_plain(gf.mul(
                    bt[:, :ds], bliu[:, vp.varrs[f"vdad{j}_{i - 1}"]])))
        assert fast.sums[job] == _el(gf.to_numpy(gr))


@pytest.mark.parametrize("what", TAMPERS)
@pytest.mark.parametrize("name", JAX_CIRCUITS)
def test_tampers_rejected(runs, name, what):
    """One word changed is rejected by the twins and by the model, which
    agree on ok and on every mid."""
    r = runs[name]
    proof, out = r["proof"], None
    if what == "output block":
        out = _bump(r["out"], (0, 0))
    else:
        proof = _tampered(r["cc"], proof, what)
    ok, mids, _claim, _point = _twins(r["vp"], proof, r["ch"], out)
    got_ok, got_mids, _ = _model_verify(r["vp"], proof, r["ch"], out, 3)
    assert not ok and not got_ok
    assert all(torch.equal(a, b) for a, b in zip(got_mids, mids))


def test_plan_layout(runs):
    """The flat plan as the kernel reads it: c0's pieces side by side, the
    polynomial rows of the rounds inside the cat, each stage's parts
    packed in its words, the segments' offsets contiguous; the source's
    constants and field enums == vchecks'."""
    for name in ("THREADS", "MAX_CLUSTER", "PART_BITS", "STAGE_WORDS"):
        assert _constant(name) == getattr(v, name), name
    for fields in (v.JOB_FIELDS, v.STAGE_FIELDS, v.PART_FIELDS,
                   v.TABLE_FIELDS, v.SEG_FIELDS, v.ROUND_FIELDS,
                   v.LIU_FIELDS):
        assert re.search(r"enum \{ " + r",\s+".join(fields) + r",\s+\w+_FIELDS",
                         SOURCE), fields
    for name in CIRCUITS:
        r = runs[name]
        vp = r["vp"]
        for kp, out in ((vp.fast, r["out"]), (vp.slow, None)):
            c0 = v._c0(kp, r["proof"], r["ch"], out, [r["proof"].vres] *
                       kp.layers)
            assert c0.shape == (2, sum(w for _, w in kp.cols.pieces))
            assert kp.cols.n == c0.shape[1] == max(
                kp.cols[k] + w for k, w in kp.cols.pieces)
            h = kp.host
            for st in h["stages"]:
                parts = h["parts"][st[v.S_PART0]:st[v.S_PART1]]
                assert (np.diff(parts[:, v.P_FIRST]) == (1 << parts[:-1, v.P_W])
                        ).all()
                words = parts[:, v.P_BASE] + (2 << parts[:, v.P_W])
                assert words.max(initial=0) <= kp.smem_words <= v.STAGE_WORDS
            offs = {}
            for g in h["segs"]:
                if g[v.G_KIND] in (v.SEG_DAD, v.SEG_GATE):
                    offs.setdefault(g[v.G_KIND], []).append(
                        (int(g[v.G_OFF]), int(g[v.G_N])))
            for runs_ in offs.values():
                assert all(a + n == b for (a, n), (b, _) in
                           zip(runs_, runs_[1:]))
        rows = v._polys(vp.cc, r["proof"]).shape[0]
        assert rows == vp.fast.n_rows == len(vp.fast.host["rounds"])


def test_entries_on_the_cpu(runs):
    """A CPU proof goes to the twins, counted in PLAIN_CALLS; the CUDA
    wrappers refuse it."""
    r = runs[JAX_CIRCUITS[0]]
    kernels.reset_counts()
    ok, mids, _, _ = v.verify_fast(r["vp"], r["proof"], r["ch"])
    assert bool(v.verify_slow(r["vp"], r["proof"], r["ch"], mids))
    assert kernels.PLAIN_CALLS["gkr_verify_fast"] == 1
    assert kernels.PLAIN_CALLS["gkr_verify_slow"] == 1
    assert kernels.LAUNCHES["gkr_verify_fast"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        v.verify_fast_cuda(r["vp"], r["proof"], r["ch"])
    with pytest.raises(ValueError, match="CUDA"):
        v.verify_slow_cuda(r["vp"], r["proof"], r["ch"], mids)
