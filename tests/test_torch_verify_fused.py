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
  pieces, jobs, items, builds, tables, stages and segments as the kernel
  reads them; each item builds the parts its segments read, each part's
  halves then its entries (each written once, only those read), every
  table's product of parts == ``beta.beta_table`` (bsig bliu the product
  of two); an item's 32-term groups over its block's warps, the table
  read in order its low part times its cached high parts; the lanes' and
  the items' partial sums added in a shuffled order, the latter by the
  job's last item; every term of a job in exactly one item; every round
  checked on its own against its reference; liu_sum in the twin's order;
  each job's check and mid; the jobs' verdicts ANDed.  A tree job (a slow
  layer, the output block) is cut into aligned subtrees of the twin's tree
  sum, folded in its order by the last item; where a claim or output word
  is not canonical its items take the plain ops' path (terms in the twins'
  order, a warp's groups through a binary counter).  Its ok and mids ==
  the twins', on the two circuits above and randomize(3, 11, seed=2)
  (several items a job), also with stages forced small and with items
  forced small (3 and more a layer).
* The plan of randomize(5, 16, seed=4) for a 132-SM card, on the host:
  every term in exactly one item, more than 4 x 8 blocks, items of a
  stage within 2x of each other's products.
* Tampers: one word changed in p1_polys, p2_polys, liu_polys, claim_u,
  claims_v, liu_claim and vres, and a wrong output block, each rejected
  by the twin and by the model, which agree on every output.  And words
  out of the canonical range (claim_u + p, claims_v + 2p or 2^63, an
  output word + p or 2^63), which the twins accept or reject as their
  plain ops fall: the model's verdict a program and mids == the twins'.
* The CUDA wrappers refuse CPU tensors, and a CPU proof counts
  ``kernels.PLAIN_CALLS``.

Inputs are the circuits' witnesses, one word bumped by one mod p or put
out of the canonical range; field arithmetic is exact, so the tolerance
is 0.  The kernels run
only on a card: chip_smoke.py holds them against the twins there."""

import collections
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
from virgo_plus_tpu_torch.circuits.compile import compile_circuit, input_buffer
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
# one word put out of the canonical range: the plain ops are not the
# field's there, and the twins accept some of these (claim_u + p) and
# reject others (2^63)
NONCANONICAL = ("claim_u + p", "claims_v + 2p", "claims_v = 2^63",
                "output block + p", "output block = 2^63")


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


def _bump(t, idx, f=lambda x: (x + 1) % M):
    a = gf.to_numpy(t).copy()
    a[idx] = np.uint64(f(int(a[idx])) % 2 ** 64)
    return gf.tensor(a)


def _tampered(cc, proof, what):
    """The proof with one word of `what` changed (a middle layer's claims
    and phase-2 messages, the top layer's p1_polys, layer 1's liu_polys):
    plus one mod p, or as NONCANONICAL names it."""
    top = cc.depth - 1
    mid = next(i for i in range(max(1, cc.depth // 2), cc.depth)
               if proof.layers[i].p2_polys is not None)
    f = {"+ p": lambda x: x + M, "+ 2p": lambda x: x + 2 * M,
         "= 2^63": lambda x: 1 << 63}.get(what.partition(" ")[2],
                                          lambda x: (x + 1) % M)
    what = what.partition(" ")[0]
    if what == "vres":
        return protocol.Proof(vres=_bump(proof.vres, (0,)),
                              layers=proof.layers)
    i, idx = {"p1_polys": (top, (0, 0, 1)), "liu_polys": (1, (0, 1, 0)),
              "p2_polys": (mid, (0, 1, 2)), "claims_v": (mid, (0, 1)),
              "claim_u": (mid, (1,)), "liu_claim": (mid, (0,))}[what]
    layers = list(proof.layers)
    layers[i] = dataclasses.replace(
        layers[i], **{what: _bump(getattr(layers[i], what), idx, f)})
    return protocol.Proof(vres=proof.vres, layers=layers)


def _tamper_block(out, what):
    """The output block with word (0, 0) changed as `what` names it."""
    f = {"output block + p": lambda x: x + M,
         "output block = 2^63": lambda x: 1 << 63}.get(what,
                                                       lambda x: (x + 1) % M)
    return _bump(out, (0, 0), f)


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


# field.cuh's steps, which the kernel takes only on canonical words
def _canon(*xs):
    assert all(0 <= w < M for x in xs for w in x), xs
    return True


def _add(x, y):
    assert _canon(x, y)
    return ((x[0] + y[0]) % M, (x[1] + y[1]) % M)


def _mul(x, y):
    assert _canon(x, y)
    return gf._py_mul(x, y)


def _sub(x, y):
    assert _canon(x, y)
    return ((x[0] - y[0]) % M, (x[1] - y[1]) % M)


# gf_int64.cuh's steps: the plain ops on u64 words (gf.mul_plain, add_plain)
W = (1 << 64) - 1


def _sra(x, k):
    return ((x - (1 << 64) if x >> 63 else x) >> k) & W


def _csp(x):
    return (x - M) & W if (x - (1 << 64) if x >> 63 else x) >= M else x


def _mymult(x, y):
    xl, xh, yl, yh = x & 0xffffffff, _sra(x, 32), y & 0xffffffff, _sra(y, 32)
    bd, ac, ad_bc = xl * yl & W, xh * yh & W, (xh * yl + xl * yh) & W
    hi = (ac + _sra((ad_bc + (bd >> 32)) & W, 32)) & W
    lo = (bd + (ad_bc << 32)) & W
    return ((hi << 3 & W | lo >> 61) + (lo & M)) & W


def _mul64(x, y):
    (a, b), (c, d) = x, y
    ap, ac, bd = _mymult((a + b) & W, (c + d) & W), _mymult(a, c), _mymult(b, d)
    nac, nbd = _csp(ac) ^ M, _csp(bd) ^ M
    t = (ap + nac + nbd) & W
    return _csp(_csp((ac + nbd) & W)), _csp((t >> 61) + (t & M))


def _add64(x, y):
    return _csp((x[0] + y[0]) & W), _csp((x[1] + y[1]) & W)


def _lane_tree(xs, lv):
    """The kernel's xor butterfly over lanes, levels 1 .. 2^(lv - 1):
    lane 0's value."""
    o = 1
    while o < 1 << lv:
        xs = [_add64(xs[i], xs[i ^ o]) for i in range(len(xs))]
        o <<= 1
    return xs[0]


def _tree_push(stack, r, x):
    """The kernel's binary counter: push the r-th subtree of a run."""
    while r & 1:
        x = _add64(stack.pop(), x)
        r >>= 1
    stack.append(x)


ONE, ZERO = (1, 0), (0, 0)


class Model:
    """csrc/gkr_verify.cu's schedule on Python ints: one program's launch
    over `jobs` jobs of kp on c0 (numpy u64 (2, NC)) and polys ((R, 2, 3)),
    item by item.  ``tables`` keeps every table an item built, by its key
    (col, bits, init, col2); ``sums`` each job's sum; ``items`` each job's
    items."""

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
        self.items = []
        self.plain_items = 0
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
            return _add64(_mul64(_add64(_mul64(pa, x), pb), x), pc)
        return liu if kind == v.REF_LIU else self.col(a)

    def bits(self, c, nb, i):
        """The product over bits b < nb of (r_{c+b} if bit b of i else
        1 - r_{c+b})."""
        f = ONE
        for b in range(nb):
            r = self.col(c + b)
            f = _mul(f, r if i >> b & 1 else _sub(ONE, r))
        return f

    def build(self, it):
        """An item's shared memory, word pair by word pair: the halves of
        the parts it builds, then each entry a low half times a high half;
        each gate segment's cu cv table."""
        sm, half = {}, {}
        builds = self.h["builds"][it[v.I_BUILD0]:it[v.I_BUILD1]]
        first = hfirst = 0
        parts = [list(p) for p in self.h["parts"]]
        for bp in builds:
            p = bp[:v.B_FIRST]         # a part's fields
            assert list(p) in parts
            w, (wl, wh) = int(p[v.B_W]), v.half_widths(int(p[v.B_W]))
            assert (bp[v.B_FIRST], bp[v.B_HFIRST]) == (first, hfirst)
            for h in range(v.half_entries(w)):
                lo = h < 1 << wl
                b0, nb, e = (0, wl, h) if lo else (wl, wh, h - (1 << wl))
                f = self.bits(p[v.B_COL] + b0, nb, e)
                if p[v.B_COL2] >= 0:
                    f = _mul(f, self.bits(p[v.B_COL2] + b0, nb, e))
                if lo and p[v.B_SCALE] >= 0:
                    f = _mul(self.col(p[v.B_SCALE]), f)
                assert hfirst + h not in half
                half[hfirst + h] = f
            for i in range(1 << w):
                x = half[hfirst + (i & (1 << wl) - 1)]
                if w > wl:
                    x = _mul(x, half[hfirst + (1 << wl) + (i >> wl)])
                word = int(p[v.B_BASE]) + 2 * i
                assert word not in sm and word + 2 <= self.kp.table_words
                sm[word] = x
            first += 1 << w
            hfirst += v.half_entries(w)
        assert (first, hfirst) == (it[v.I_ENTRIES], it[v.I_HALVES])
        assert 2 * hfirst <= self.kp.half_words
        for g in self.h["segs"][it[v.I_SEG0]:it[v.I_SEG1]]:
            for k in range(g[v.G_NCV]):
                sm[int(g[v.G_CUV]) + 2 * k] = _mul64(self.col(g[v.G_CU]),
                                                     self.col(g[v.G_CV] + k))
        return sm

    def parts_of(self, t):
        k, base = (int(x) for x in self.h["tables"][t][v.T_BITS:
                                                       v.T_SMEM + 1])
        # the segment rows carry each table's bits and words (G_KA, G_SA)
        assert any((g[v.G_TA + c], g[v.G_KA + c], g[v.G_SA + c]) == (t, k, base)
                   for g in self.h["segs"] for c in range(3))
        out = []
        for w in v.part_widths(k):
            out.append((base, w))
            base += 2 << w
        return out

    def beta(self, sm, t, g):
        out, off = None, 0
        for base, w in self.parts_of(t):
            x = sm[base + 2 * (g >> off & (1 << w) - 1)]
            out = x if out is None else _mul(out, x)
            off += w
        return out

    def seq(self, sm, t, g, cache):
        """A table read in order: part 0 at g times the higher parts'
        product, kept in the lane's cache until g's high bits change."""
        parts = self.parts_of(t)
        if len(parts) == 1:
            return sm[parts[0][0] + 2 * g]
        (base0, w0), key = parts[0], g >> parts[0][1]
        if cache.get("key") != key:
            hi, off = None, 0
            for base, w in parts[1:]:
                x = sm[base + 2 * (key >> off & (1 << w) - 1)]
                hi = x if hi is None else _mul(hi, x)
                off += w
            cache.update(key=key, hi=hi)
        return _mul(sm[base0 + 2 * (g & (1 << w0) - 1)], cache["hi"])

    def gate_beta(self, sm, seg, t, cache):
        coef, gx, glv, gsl = self.gates
        g = int(seg[v.G_OFF]) + t
        x = int(gx[g])
        w = self.seq(sm, seg[v.G_TA], t, cache)
        if x & v.ASSERT_BIT:
            w = _mul(w, self.col(seg[v.G_ASSERT]))
        w = _mul(w, self.beta(sm, seg[v.G_TB], x & (v.ASSERT_BIT - 1)))
        if seg[v.G_TC] >= 0:
            w = _mul(w, self.beta(sm, seg[v.G_TC], int(glv[g])))
        return w

    def term_exact(self, sm, seg, t, cache):
        """An OUT or GATE term on the plain ops in the twins' order."""
        off = int(seg[v.G_OFF])
        if seg[v.G_KIND] == v.SEG_OUT:
            return _mul64(self.col(off + t),
                          self.seq(sm, seg[v.G_TA], t, cache))
        coef, gx, glv, gsl = self.gates
        g = off + t
        A, B, C, D = ((int(coef[2 * c, g]), int(coef[2 * c + 1, g]))
                      for c in range(4))
        cu, cv = self.col(seg[v.G_CU]), ZERO
        cuv = _mul64(cu, ZERO)
        if seg[v.G_CV] >= 0:
            sl = int(gsl[g])
            cv, cuv = self.col(seg[v.G_CV] + sl), sm[int(seg[v.G_CUV]) + 2 * sl]
        gate = _add64(_add64(_mul64(A, cu), _mul64(B, cv)),
                      _add64(_mul64(C, cuv), D))
        return _mul64(self.gate_beta(sm, seg, t, cache), gate)

    def term(self, sm, seg, t, cache):
        kind, off = seg[v.G_KIND], int(seg[v.G_OFF])
        assert kind != v.SEG_OUT       # the output block: term_exact
        if kind == v.SEG_PRE:
            return self.seq(sm, seg[v.G_TA], t, cache)
        if kind == v.SEG_DAD:
            return _mul(self.beta(sm, seg[v.G_TB], int(self.idx[off + t])),
                        self.seq(sm, seg[v.G_TA], t, cache))
        coef, gx, glv, gsl = self.gates
        g = off + t
        w = self.gate_beta(sm, seg, t, cache)
        cu = self.col(seg[v.G_CU])
        A, B, C, D = ((int(coef[2 * c, g]), int(coef[2 * c + 1, g]))
                      for c in range(4))
        if seg[v.G_CV] < 0:
            gate = _add(_mul(A, cu), D)
        else:
            sl = int(gsl[g])
            gate = _add(_add(_mul(A, cu), _mul(B, self.col(seg[v.G_CV] + sl))),
                        _add(_mul(C, sm[int(seg[v.G_CUV]) + 2 * sl]), D))
        return _mul(w, gate)

    def shuffled_sum(self, xs):
        xs = list(xs)
        self.rng.shuffle(xs)
        out = ZERO
        for x in xs:
            out = _add(out, x)
        return out

    def exact(self, J, seg):
        """A tree job's item takes the plain ops' path: the output block,
        or a gate segment with a cu or cv word not canonical."""
        if J[v.J_TREE] < 0:
            return False
        if seg[v.G_KIND] == v.SEG_OUT:
            return True
        cols = [seg[v.G_CU]] + [seg[v.G_CV] + k for k in range(seg[v.G_NCV])]
        return not all(0 <= w < M for c in cols for w in self.col(c))

    def tree_item(self, it, sm, seg, h):
        """The plain path: the twins' tree of the item's 2^h leaves, its
        2^(h-5) groups (one for h <= 5) over the warps, each warp's run of
        groups through a binary counter, the warps' values in pairs."""
        t0, t1, G_ = int(it[v.I_T0]), int(it[v.I_T1]), v.GROUP
        groups = 1 << (h - 5) if h > 5 else 1
        wu = min(self.threads // 32, groups)
        run = groups // wu
        vals = []
        for warp in range(wu):
            stack, caches = [], [{} for _ in range(G_)]
            for r in range(run):
                base = t0 + (warp * run + r) * G_
                xs = []
                for lane in range(G_):
                    u = base - int(seg[v.G_FIRST]) + lane
                    if base < t1 and u < seg[v.G_N]:
                        self.seen[(int(it[v.I_STAGE]), int(it[v.I_SEG0]),
                                   u)] += 1
                        xs.append(self.term_exact(sm, seg, u, caches[lane]))
                    else:
                        xs.append(ZERO)
                _tree_push(stack, r, _lane_tree(xs, min(h, 5)))
            assert len(stack) == 1
            vals.append(stack[0])
        return _lane_tree(vals + [ZERO] * (G_ - wu), wu.bit_length() - 1)

    def item(self, it):
        """One block: its build, then its 32-term groups, a run of them a
        warp, each lane's terms summed; the block's sum."""
        sm = self.build(it)
        for g in self.h["segs"][it[v.I_SEG0]:it[v.I_SEG1]]:
            for t in (g[v.G_TA], g[v.G_TB], g[v.G_TC]):
                col, col2, k, _, init = (int(x) for x in self.h["tables"][t])
                if t >= 0 and (col, k, init, col2) not in self.tables:
                    self.tables[(col, k, init, col2)] = [
                        self.beta(sm, t, e) for e in range(1 << k)]
        segs = self.h["segs"][it[v.I_SEG0]:it[v.I_SEG1]]
        J = self.h["jobs"][it[v.I_JOB]]
        if self.exact(J, segs[0]):
            self.plain_items += 1
            return self.tree_item(it, sm, segs[0], int(J[v.J_TREE]))
        t0, G, warps = int(it[v.I_T0]), v.GROUP, self.threads // 32
        groups = (int(it[v.I_T1]) - t0) // G
        lanes = []
        for warp in range(warps):
            acc = [ZERO] * G
            caches = [{} for _ in range(G)]
            s = 0
            for gi in range(warp * groups // warps,
                            (warp + 1) * groups // warps):
                base = t0 + gi * G
                while base >= segs[s][v.G_FIRST] + v._spans(segs[s][v.G_N]):
                    s += 1
                    caches = [{} for _ in range(G)]
                seg = segs[s]
                for lane in range(G):
                    u = base - int(seg[v.G_FIRST]) + lane
                    if u < seg[v.G_N]:
                        self.seen[(int(it[v.I_STAGE]), s + it[v.I_SEG0],
                                   u)] += 1
                        acc[lane] = _add(acc[lane], self.term(
                            sm, seg, u, caches[lane]))
            lanes += acc
        return self.shuffled_sum(lanes)

    def job(self, j):
        J = self.h["jobs"][j]
        items = self.h["items"][J[v.J_ITEM0]:J[v.J_ITEM1]]
        assert (items[:, v.I_JOB] == j).all()
        self.seen = collections.Counter()
        # every term of the job's segments in exactly one item
        partials = [self.item(it) for it in items]
        want = {(int(st), i, u)
                for st in range(J[v.J_STAGE0], J[v.J_STAGE1])
                for i in range(*self.h["stages"][st][[v.S_SEG0, v.S_SEG1]])
                for u in range(self.h["segs"][i][v.G_N])}
        assert set(self.seen) == want and set(self.seen.values()) <= {1}
        self.items.append(len(items))
        if J[v.J_TREE] >= 0:
            # a tree job's items: aligned subtrees of 2^h terms, folded by
            # the last to arrive in the twins' tree over 2^(K-h) slots, lane
            # l a run of `per` slots through a binary counter
            h, L = int(J[v.J_TREE]), int(J[v.J_TREE_K] - J[v.J_TREE])
            assert (items[:, v.I_T0] == np.arange(len(items)) << h).all()
            assert len(items) <= 1 << L
            lanes = 1 << L if L < 5 else 32
            per = (1 << L) // lanes
            xs = []
            for lane in range(lanes):
                stack = []
                for r in range(per):
                    k = lane * per + r
                    _tree_push(stack, r, partials[k] if k < len(items)
                               else ZERO)
                xs.append(stack[0])
            total = _lane_tree(xs + [ZERO] * (32 - lanes), min(L, 5))
        else:
            # the last item to arrive adds the items' sums, in any order
            total = self.shuffled_sum(partials)
        self.sums.append(total)
        liu = None
        for pair in self.h["liu"][J[v.J_LIU0]:J[v.J_LIU1]]:
            p = _mul64(self.col(pair[v.L_SIG]), self.col(pair[v.L_CLAIM]))
            liu = p if liu is None else _add64(liu, p)
        good = True
        for r in self.h["rounds"][J[v.J_ROUND0]:J[v.J_ROUND1]]:
            a, b, c = self.poly(r[v.R_ROW])
            s = _add64(_add64(a, b), _add64(c, c))
            good &= s == self.resolve(*r[v.R_KIND:v.R_B + 1], liu)
        lhs = (_mul64(self.col(J[v.J_MUL]), total) if J[v.J_MUL] >= 0
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


@pytest.mark.parametrize("stages", ["plan", "forced", "small items"])
@pytest.mark.parametrize("name", CIRCUITS)
def test_model_matches_twins(runs, name, stages, monkeypatch):
    """The kernels' schedule == the twins on the honest proof, with and
    without the output block, at the plan's stages and items, at stages
    forced to the words of the largest segment's tables (a stage a
    segment), and at items forced small (MIN_ITEM_COST 1 on a 64-SM
    card: a layer of randomize(3, 11) over 3 items and more, its partial
    sums added by the last in a shuffled order)."""
    r = runs[name]
    vp = r["vp"]
    if stages == "forced":
        monkeypatch.setattr(v, "STAGE_WORDS", max(
            sum(v.table_words(int(kp.host["tables"][t][v.T_BITS]))
                for t in set(g[v.G_TA:v.G_TC + 1]) - {-1})
            + 2 * int(g[v.G_NCV])
            for kp in (vp.fast, vp.slow) for g in kp.host["segs"]))
        vp = v.VerifierPlan(r["cc"], vp.varrs, "cpu")
        assert len(vp.fast.host["stages"]) > len(vp.fast.host["jobs"])
    elif stages == "small items":
        monkeypatch.setattr(v, "MIN_ITEM_COST", 1)
        monkeypatch.setattr(v, "DEFAULT_SMS", 64)
        vp = v.VerifierPlan(r["cc"], vp.varrs, "cpu")
    for out in (None, r["out"]):
        ok, mids, fast = _model_verify(vp, r["proof"], r["ch"], out)
        want = _twins(vp, r["proof"], r["ch"], out)
        assert ok and want[0]
        assert all(torch.equal(a, b) for a, b in zip(mids, want[1]))
        if stages == "small items" and "11" in name:
            assert min(fast.items[:vp.fast.n_jobs]) >= 3
    assert (len(vp.slow.host["items"]) > len(vp.slow.host["jobs"])) == (
        "11" in name)


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
    for (col, k, init, col2), entries in fast.tables.items():
        want = beta_table(c0[:, col:col + k], k,
                          gf.ones(()) if init < 0 else c0[:, init])
        if col2 >= 0:     # bsig bliu: the product of two tables
            want = gf.mul(want, beta_table(c0[:, col2:col2 + k], k,
                                           gf.ones(())))
        want = gf.to_numpy(want)
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
        out = _tamper_block(r["out"], what)
    else:
        proof = _tampered(r["cc"], proof, what)
    ok, mids, _claim, _point = _twins(r["vp"], proof, r["ch"], out)
    got_ok, got_mids, _ = _model_verify(r["vp"], proof, r["ch"], out, 3)
    assert not ok and not got_ok
    assert all(torch.equal(a, b) for a, b in zip(got_mids, mids))


@pytest.mark.parametrize("what", NONCANONICAL)
@pytest.mark.parametrize("name", CIRCUITS)
def test_noncanonical_words_match_twins(runs, name, what, monkeypatch):
    """A claim or output word of p or more: each program's verdict and the
    mids of the model == the twins', and each tree job's sum == the twin's
    tree_sum_plain bits, with items forced small (MIN_ITEM_COST 1 on a
    64-SM card, so a layer of randomize(3, 11) is several subtrees); the
    plain path taken where a word is not canonical."""
    r = runs[name]
    monkeypatch.setattr(v, "MIN_ITEM_COST", 1)
    monkeypatch.setattr(v, "DEFAULT_SMS", 64)
    vp = v.VerifierPlan(r["cc"], r["vp"].varrs, "cpu")
    proof, out = r["proof"], None
    if what.startswith("output block"):
        out = _tamper_block(r["out"], what)
    else:
        proof = _tampered(r["cc"], proof, what)
    sums, tree_sum = [], chains.tree_sum_plain

    def recorded(x):
        sums.append(_el(gf.to_numpy(tree_sum(x))))
        return gf.tensor(np.array(sums[-1], dtype=np.uint64))

    monkeypatch.setattr(chains, "tree_sum_plain", recorded)
    ok, mids, _claim, _point = v.verify_fast_plain(vp, proof, r["ch"], out)
    out_sum, sums[:] = sums[:1] if out is not None else None, []
    slow_ok = v.verify_slow_plain(vp, proof, r["ch"], mids)
    monkeypatch.setattr(chains, "tree_sum_plain", tree_sum)
    polys = gf.to_numpy(v._polys(vp.cc, proof))
    c0 = gf.to_numpy(v._c0(vp.fast, proof, r["ch"], out))
    fast = Model(vp.fast, c0, polys, vp.fast.n_jobs + (out is not None), 3)
    got_mids = [gf.tensor(np.array(fast.mids[k], dtype=np.uint64))
                for k in range(vp.fast.layers)]
    assert all(torch.equal(a, b) for a, b in zip(got_mids, mids))
    assert fast.ok == bool(ok)
    slow = Model(vp.slow, gf.to_numpy(v._c0(vp.slow, proof, r["ch"],
                                            mids=mids)),
                 None, vp.slow.n_jobs, 4)
    assert slow.ok == bool(slow_ok)
    assert slow.sums == sums
    if out is not None:
        assert [fast.sums[-1]] == out_sum and fast.plain_items
    else:
        assert slow.plain_items
    if "11" in name:
        assert min(slow.items) > 1


def test_plan_layout(runs):
    """The flat plan as the kernel reads it: c0's pieces side by side, the
    polynomial rows of the rounds inside the cat, each stage's parts
    packed in its words, each item's builds packed in its entries and
    halves, the segments' offsets contiguous and their first terms whole
    groups; the source's constants and field enums == vchecks'."""
    for name in ("THREADS", "PART_BITS", "STAGE_WORDS", "HALF_WORDS",
                 "STAGE_SEGS", "STAGE_PARTS", "GROUP"):
        assert _constant(name) == getattr(v, name), name
    assert _constant("MIN_BLOCKS") == v.ITEMS_PER_SM
    assert v.BUILD_FIELDS[:len(v.PART_FIELDS)] == tuple(
        "B_" + f[2:] for f in v.PART_FIELDS)
    for fields in (v.JOB_FIELDS, v.ITEM_FIELDS, v.BUILD_FIELDS,
                   v.SEG_FIELDS, v.ROUND_FIELDS, v.LIU_FIELDS):
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
                words = parts[:, v.P_BASE] + (2 << parts[:, v.P_W])
                assert (parts[1:, v.P_BASE] == words[:-1]).all()
                assert words.max(initial=0) <= kp.table_words <= v.STAGE_WORDS
                segs = h["segs"][st[v.S_SEG0]:st[v.S_SEG1]]
                assert (segs[:, v.G_FIRST] % v.GROUP == 0).all()
            for it in h["items"]:
                b = h["builds"][it[v.I_BUILD0]:it[v.I_BUILD1]]
                w = b[:, v.B_W]
                assert (np.diff(b[:, v.B_FIRST]) == (1 << w[:-1])).all()
                assert sum(1 << w) == it[v.I_ENTRIES]
                assert 2 * it[v.I_HALVES] <= kp.half_words <= v.HALF_WORDS
                assert it[v.I_T0] % v.GROUP == it[v.I_T1] % v.GROUP == 0
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


@pytest.mark.parametrize("program", ["fast", "slow"])
def test_plan_items_over_the_card(program):
    """BASELINE scenario 4's circuit shape cut to randomize(5, 16, seed=4),
    planned for a 132-SM card on the host: every term of every job lies in
    exactly one item (the items of a stage cover its groups once, each
    item's segments those its groups meet), the grid holds more than 4 x 8
    blocks (the old design's four jobs of one 8-block cluster each), and
    the items' costs are within 2x of each other where a stage holds more
    than one."""
    c = randomize(5, 16, seed=4)
    subset_init(c)
    cc = compile_circuit(c)
    assert v.DEFAULT_SMS == 132
    kp = getattr(v.VerifierPlan(cc, protocol.verifier_arrays(cc, "cpu"),
                                "cpu"), program)
    h = kp.host
    assert len(h["items"]) > 4 * 8
    for j, job in enumerate(h["jobs"]):
        items = h["items"][job[v.J_ITEM0]:job[v.J_ITEM1]]
        assert len(items) and (items[:, v.I_JOB] == j).all()
        for s in range(job[v.J_STAGE0], job[v.J_STAGE1]):
            st = h["stages"][s]
            mine = items[items[:, v.I_STAGE] == s]
            assert mine[0, v.I_T0] == 0 and mine[-1, v.I_T1] == st[v.S_TERMS]
            assert (mine[1:, v.I_T0] == mine[:-1, v.I_T1]).all()
            segs = h["segs"][st[v.S_SEG0]:st[v.S_SEG1]]
            ends = segs[:, v.G_FIRST] + -(-segs[:, v.G_N] // v.GROUP) * v.GROUP
            assert (segs[1:, v.G_FIRST] == ends[:-1]).all()
            cost = []
            for it in mine:
                ss = np.arange(st[v.S_SEG0], st[v.S_SEG1])
                meet = ss[(segs[:, v.G_FIRST] < it[v.I_T1])
                          & (ends > it[v.I_T0])]
                assert (it[v.I_SEG0], it[v.I_SEG1]) == (meet[0], meet[-1] + 1)
                cost.append(sum(
                    v.term_cost(h["segs"][i], h["tables"])
                    * max(0, min(it[v.I_T1], h["segs"][i][v.G_FIRST]
                                 + h["segs"][i][v.G_N])
                          - max(it[v.I_T0], h["segs"][i][v.G_FIRST]))
                    for i in meet))
            if len(cost) > 1:
                assert max(cost) <= 2 * min(cost)


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
