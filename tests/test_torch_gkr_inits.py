"""The GKR init stages (``gkr/inits.py``: ``gkr_p1_inits``,
``gkr_p2_inits``) on the CPU against the JAX package, and the kernels'
plan arithmetic emulated on the host.

On a CUDA tensor ``protocol._prove_inits`` is the stage's beta tables, one
product and one sum for vres, and one ``gkr_p1_inits`` launch;
``_prove_p2_inits`` its beta tables and one ``gkr_p2_inits`` launch.  On a
CPU tensor the launches are the plain twins.  Here:

* every stacked array of both stages (the phase-1, Liu and phase-2 tables
  and their round challenges) and vres == JAX ``_prove_inits`` /
  ``_prove_p2_inits`` run eagerly, fed the same challenges, circuit values
  and phase-1 claims, on randomize(4, 3, seed=5) (bound terms below a
  layer's largest dad table), randomize(3, 7, seed=21) and a randomize
  circuit with assert gates on one layer (compiled by both packages);
* a batch (2, B, T) == one call a witness, in both stages;
* ``emulate``, a host copy of ``csrc/gkr_inits.cu``'s item arithmetic
  (the row tiles; the cooperative warps' term owners, shared words and
  passes of rows with a short last one and kept term products; the warp
  and block summers; a slot's table record, its term ranges, the packed
  beta references, the output addresses and the stacked challenges) on
  Python-int field elements, reading the tile constants from the source,
  == the twins at forced small summer thresholds (all three classes) and
  at the plan's own, at lead axes up to 17 rows, writing every output
  word exactly once;
* the twins call only ``gf``'s plain ops and ``chains.prefix_sum``, a CPU
  call counts ``kernels.PLAIN_CALLS``, and the CUDA wrappers refuse CPU
  tensors and a plan of the other stage.

Inputs are canonical, from the circuits' witnesses and numpy with a seed;
field arithmetic is exact, so the tolerance is 0.  The kernels run only on
a card: chip_smoke.py holds them against the twins there."""

import multiprocessing as mp
import re
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from virgo_plus_tpu.circuits import compile as jcompile
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.utils.glibc_rand import GlibcRandom as JGlibc
from virgo_plus_tpu_torch import convert, kernels
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import chains, gf
from virgo_plus_tpu_torch.field.ref import Fq2
from virgo_plus_tpu_torch.gkr import inits, protocol
from virgo_plus_tpu_torch.gkr.sumcheck import mle_fold

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD


def _assert_circuit():
    """randomize(3, 6, seed=7) with assert gates on layer 2 and 40 of its
    gates reading node 0 of layer 1 on the left and node 3 of layer 0 on
    the right: a phase-1 and a phase-2 segment for a warp."""
    c = randomize(3, 6, seed=7)
    L = c.layers[2]
    L.is_assert[[1, 5, 9, 12]] = True
    L.u[:40] = 0
    L.l[:40], L.v[:40] = 0, 3
    subset_init(c)
    return c


def _circuit(name):
    if name == "asserts":
        return _assert_circuit()
    layers, bits, seed = name
    c = randomize(layers, bits, seed=seed)
    subset_init(c)
    return c


CIRCUITS = [(4, 3, 5), (3, 7, 21), "asserts"]


def _stacked_np(stacked):
    return {bl: tuple(np.asarray(a) for a in job)
            for bl, job in stacked.items()}


def _port_np(stacked):
    return {bl: tuple(gf.to_numpy(a) for a in job)
            for bl, job in stacked.items()}


def _same(got, want):
    assert list(got) == list(want)
    for bl in want:
        assert len(got[bl]) == len(want[bl]) == 4
        for k, (g, w) in enumerate(zip(got[bl], want[bl])):
            assert g.shape == w.shape and np.array_equal(g, w), (bl, k)


def _port(c):
    """The port's compiled circuit, plans, tables, challenges and values,
    under the JAX package's challenge stream and evaluation."""
    jcc = jcompile.compile_circuit(c)
    jch = jprotocol.make_challenges(jcc, JGlibc(3396))
    jvalues = jcompile.evaluate(jcc, jcompile.input_buffer(jcc))
    cc = compile_circuit(c)
    plans = protocol.build_plans(cc)
    return dict(c=c, cc=cc, plans=plans,
                arrs=protocol.circuit_arrays(cc, plans, "cpu"),
                ch=convert.challenges(jch), values=convert.tensor(jvalues),
                jcc=jcc, jch=jch, jvalues=jvalues)


def _claims(s):
    """The port's phase-1 claims of a _port result."""
    p1s, lius = protocol._prove_inits(s["cc"], s["plans"], s["values"],
                                      s["ch"], s["arrs"])[1:]
    return protocol._claims(protocol._prove_folds(s["cc"], p1s, lius)[0])


def _jax_job(name, stage):
    """JAX ``_prove_inits`` (stage 1) or ``_prove_p2_inits`` (stage 2, fed
    the port's phase-1 claims) run eagerly on one circuit.  Each op
    compiles on its own (7-18 s a stage), so each stage of each circuit
    runs in a process of its own."""
    s = _port(_circuit(name))
    jplans = jprotocol.build_plans(s["jcc"])
    jarrs = jprotocol.circuit_arrays(s["jcc"], jplans)
    args = (s["jcc"], jplans, s["jvalues"], s["jch"])
    if stage == 1:
        jvres, jp1s, jlius = jprotocol._prove_inits(*args, jarrs)
        return np.asarray(jvres), _stacked_np(jp1s), _stacked_np(jlius)
    return _stacked_np(jprotocol._prove_p2_inits(
        *args, {i: jnp.asarray(gf.to_numpy(t))
                for i, t in _claims(s).items()}, jarrs))


@pytest.fixture(scope="module")
def jax_refs():
    jobs = [(name, stage) for name in CIRCUITS for stage in (1, 2)]
    with ProcessPoolExecutor(len(jobs),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = {job: pool.submit(_jax_job, *job) for job in jobs}
        yield {name: futures[(name, 1)].result()
               + (futures[(name, 2)].result(),) for name in CIRCUITS}


@pytest.fixture(scope="module", params=CIRCUITS,
                ids=lambda p: p if isinstance(p, str) else f"{p[:2]}")
def both(request, jax_refs):
    """The port's and the JAX package's init stages on one circuit under
    the same challenges, values and phase-1 claims."""
    s = _port(_circuit(request.param))
    vres, p1s, lius = protocol._prove_inits(s["cc"], s["plans"], s["values"],
                                            s["ch"], s["arrs"])
    s["claims"] = _claims(s)
    p2s = protocol._prove_p2_inits(s["cc"], s["plans"], s["values"],
                                   s["ch"], s["claims"], s["arrs"])
    s["got"] = (gf.to_numpy(vres), _port_np(p1s), _port_np(lius),
                _port_np(p2s))
    s["want"] = jax_refs[request.param]
    return s


def test_p1_inits_match_jax(both):
    (vres, p1s, lius, _), (jvres, jp1s, jlius, _) = both["got"], both["want"]
    assert np.array_equal(vres, jvres)
    _same(p1s, jp1s)
    _same(lius, jlius)


def test_p2_inits_match_jax(both):
    assert both["want"][3], "every circuit here has phase-2 tables"
    _same(both["got"][3], both["want"][3])


def test_vres_is_mle_fold(both):
    cc, values = both["cc"], both["values"]
    top = protocol._values_block(cc, values, cc.depth - 1)
    assert np.array_equal(both["got"][0],
                          gf.to_numpy(mle_fold(top, both["ch"].r_out)))


def test_assert_circuit_has_asserts_and_long_segments():
    c = _assert_circuit()
    cc = compile_circuit(c)
    assert cc.layers[2].has_assert and not cc.layers[1].has_assert
    plans = protocol.build_plans(cc)
    p1_groups, p2_groups = protocol._groups(cc)
    p1 = inits.p1_plan(cc, plans, p1_groups, "cpu")
    p2 = inits.p2_plan(cc, plans, p2_groups, "cpu")
    assert p1.classes[1] >= 1 and p2.classes[1] >= 1
    assert int((p1.gate < 0).sum()) == 4       # the assert bits
    for plan in (p1, p2):
        st = plan.starts.numpy()
        assert np.sum(st[1:] == st[:-1]) > 0     # empty segments


def _batch(both, rows):
    """values of `rows` witnesses (2, rows, T): the circuit's values plus
    canonical noise, and claims (2, rows) each."""
    rng = np.random.default_rng(11)
    v = both["values"]
    noise = gf.tensor(rng.integers(0, M, size=(2, rows, v.shape[-1]),
                                   dtype=np.uint64))
    claims = {i: gf.tensor(rng.integers(0, M, size=(2, rows),
                                        dtype=np.uint64))
              for i in both["claims"]}
    return gf.add(v[:, None], noise), claims


def test_batch_equals_single_calls(both):
    cc, plans, arrs, ch = (both[k] for k in ("cc", "plans", "arrs", "ch"))
    values, claims = _batch(both, 3)
    vres, p1s, lius = protocol._prove_inits(cc, plans, values, ch, arrs)
    p2s = protocol._prove_p2_inits(cc, plans, values, ch, claims, arrs)
    for b in range(3):
        one = values[:, b].contiguous()
        v1, p1, liu = protocol._prove_inits(cc, plans, one, ch, arrs)
        p2 = protocol._prove_p2_inits(
            cc, plans, one, ch, {i: t[:, b] for i, t in claims.items()}, arrs)
        assert torch.equal(vres[:, b], v1)
        for got, want in ((p1s, p1), (lius, liu), (p2s, p2)):
            for bl, job in want.items():
                for k in range(3):
                    assert torch.equal(got[bl][k][:, b], job[k]), (b, bl, k)
                assert torch.equal(got[bl][3], job[3])


# ---------------------------------------------------------------------------
# The kernel's plan arithmetic on the host
# ---------------------------------------------------------------------------

def _f(planes, i):
    return Fq2.raw(int(planes[0][i]), int(planes[1][i]))


def _cu_constants():
    """The constants of csrc/gkr_inits.cu that shape its grid and passes."""
    src = (Path(inits.__file__).parents[1] / "csrc" / "gkr_inits.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
            for name in ("THREADS", "P1_ROWS", "ROW_TILE_P1", "ROW_TILE_P2",
                         "KEPT")}


def _sum(xs):
    out = Fq2(0)
    for x in xs:
        out = out + x
    return out


def _owner(s0, t):
    """The kernel's ``owner``: five halving steps over the lanes' s0."""
    k = 0
    for d in (16, 8, 4, 2, 1):
        if s0[k + d] <= t:
            k += d
    return k


def emulate(plan, values, c0, betas):
    """csrc/gkr_inits.cu's ``run`` item by item on Python-int field
    elements: the grid's row tiles; the cooperative warps (32 slots by
    index, the thread slots summed: a lane a term found by ``owner``, its
    words into the shared rows, each lane summing its own slot's; phase 1
    the Liu terms and the rows' v, 0, m' first, then passes of P1_ROWS
    rows with a short last one, the first pass keeping the first KEPT
    chunks' term products for the others); the warp and block summers
    over ``lists`` (lanes take terms lane, lane + step, ..., row u of a
    pass to lane u); the table records, packed beta references, output
    addresses and stacked challenges.  Returns (out, writes per word)."""
    T = lambda t: t.numpy()
    K = _cu_constants()
    U = K["P1_ROWS"]
    tile = K["ROW_TILE_P1"] if plan.stage == 1 else K["ROW_TILE_P2"]
    rows = int(np.prod(values.shape[1:-1]))
    vals = gf.to_numpy(values).reshape(2, rows, -1)
    cz = gf.to_numpy(c0)
    bt = [gf.to_numpy(t).reshape(2, -1) for t in betas]
    tab = T(plan.tab)
    slot_tab, starts, lists = T(plan.slot_tab), T(plan.starts), T(plan.lists)
    liu_starts, liu_ref, dg = T(plan.liu_starts), T(plan.liu_ref), T(plan.dg)
    coef = T(plan.coef).view(np.uint64)
    idx, gate = T(plan.idx), T(plan.gate).view(np.uint32)
    words = inits.WORDS[plan.stage]
    out = np.zeros(plan.out_words(rows), dtype=np.uint64)
    writes = np.zeros(plan.out_words(rows), dtype=np.int64)
    liu = plan.stage == 1
    n = plan.n_slots

    def beta(ref):
        g, off = ref >> inits.REF_SHIFT, ref & ((1 << inits.REF_SHIFT) - 1)
        return _f(bt[g], off)

    def put(rec, arr, row, s, x):
        a = (2 * words * rows * rec[inits.T_GBASE]
             + (2 * arr * rows + row) * rec[inits.T_KN] + rec[inits.T_KOFF]
             + s)
        for p, w in ((0, x.real), (1, x.img)):
            out[a + p * rows * rec[inits.T_KN]] = w
            writes[a + p * rows * rec[inits.T_KN]] += 1

    def gated(rec, t):
        b = beta(rec[inits.T_BG] + int(gate[t] & 0x7FFFFFFF))
        return b * _f(cz, rec[inits.T_ASSERT]) if gate[t] >> 31 else b

    def co(t, k):
        return Fq2.raw(int(coef[2 * k, t]), int(coef[2 * k + 1, t]))

    def value(row, col):
        return _f(vals[:, row], col)

    def thread_slot(q):
        m = starts[q + 1] - starts[q]
        if liu:
            m = max(m, liu_starts[q + 1] - liu_starts[q])
        return m <= plan.thread_max

    def p2_rows(rec, q, r0, nr, x):
        s = q - rec[inits.T_SLOT]
        claim = plan.nc_static + rec[inits.T_CLAIM] * rows + r0
        for r in range(nr):
            cu = _f(cz, claim + r)
            v = value(r0 + r, dg[q]) if dg[q] >= 0 else Fq2(0)
            for arr, w in enumerate((v, x[0] * cu + x[3], x[1] + x[2] * cu)):
                put(rec, arr, r0 + r, s, w)

    def chunks(own, s0, s1, f, width):
        """The warp's walk over [first lane's s0, last lane's s1) 32 terms
        at a time: f(chunk, lane, term, owner lane) gives the term's words
        (None: not summed here); each own lane sums its own terms' words
        of every chunk.  Returns each lane's sums (None: not own)."""
        sums = [[Fq2(0)] * width if own[i] else None for i in range(32)]
        for ci, c in enumerate(range(s0[0], s1[31], 32)):
            sh = [f(ci, i, c + i, _owner(s0, c + i)) if c + i < s1[31]
                  else None for i in range(32)]
            for i in range(32):
                for p in range(max(s0[i], c), min(s1[i], c + 32)):
                    if own[i]:
                        sums[i] = [x + w for x, w in zip(sums[i], sh[p - c])]
        return sums

    def coop_warp(q0, r0, nr):
        q = [q0 + i for i in range(32)]
        live = [x < n for x in q]
        qe = [x if x < n else n for x in q]
        s0 = [starts[x] for x in qe]
        s1 = [starts[x + 1] if ok else s for x, ok, s in zip(q, live, s0)]
        own = [ok and thread_slot(x) for x, ok in zip(q, live)]
        rec = [tab[slot_tab[x if ok else q0]] for x, ok in zip(q, live)]
        if not liu:
            def term(ci, i, t, o):
                if not own[o]:
                    return None
                tmp = gated(rec[o], t) * beta(rec[o][inits.T_B2] + int(idx[t]))
                return [tmp * co(t, j) for j in range(4)]
            for i, x in enumerate(chunks(own, s0, s1, term, 4)):
                if x is not None:
                    p2_rows(rec[i], q[i], r0, nr, x)
            return
        l0 = [liu_starts[x] for x in qe]
        l1 = [liu_starts[x + 1] if ok else s for x, ok, s in zip(q, live, l0)]
        lsum = chunks(own, l0, l1, lambda ci, i, t, o: [beta(int(liu_ref[t]))]
                      if own[o] else None, 1)
        for i in range(32):
            if not own[i]:
                continue
            s = q[i] - rec[i][inits.T_SLOT]
            bsig = (beta(rec[i][inits.T_B2] + s) if s < rec[i][inits.T_SIZE]
                    else Fq2(0))
            for r in range(nr):
                v = value(r0 + r, rec[i][inits.T_VOFF] + s)
                for arr, x in ((0, v), (3, v), (4, Fq2(0)),
                               (5, bsig + lsum[i][0])):
                    put(rec[i], arr, r0 + r, s, x)
        kept, consts = {}, {}
        for p0 in range(0, nr, U):
            rws = range(p0, min(p0 + U, nr))

            def term(ci, i, t, o):
                cst = []
                if p0 == 0 or ci >= K["KEPT"]:
                    bB = bC = col = None
                    if own[o]:
                        b = gated(rec[o], t)
                        bB, bC, col = b * co(t, 1), b * co(t, 2), idx[t]
                        cst = [b * co(t, 3), b * co(t, 0)]
                    if p0 == 0 and ci < K["KEPT"]:
                        kept[ci, i] = (bB, bC, col)
                else:
                    bB, bC, col = kept[ci, i]
                if col is None:
                    return None
                ys = [value(r0 + u, col) for u in rws]
                return ([bB * y for y in ys] + [bC * y for y in ys]
                        + (cst if p0 == 0 else []))
            width = 2 * len(rws) + (2 if p0 == 0 else 0)
            for i, x in enumerate(chunks(own, s0, s1, term, width)):
                if x is None:
                    continue
                if p0 == 0:
                    consts[i] = x[-2:]
                ca, cm = consts[i]
                s = q[i] - rec[i][inits.T_SLOT]
                for k, u in enumerate(rws):
                    put(rec[i], 1, r0 + u, s, x[k] + ca)
                    put(rec[i], 2, r0 + u, s, cm + x[len(rws) + k])

    def summer(q, r0, nr, step):
        rec = tab[slot_tab[q]]
        terms = range(starts[q], starts[q + 1])
        lane_terms = [terms[k::step] for k in range(step)]
        part = lambda f: _sum(_sum(f(t) for t in lt) for lt in lane_terms)
        if not liu:
            p2_rows(rec, q, r0, nr, [
                part(lambda t: gated(rec, t) * beta(rec[inits.T_B2]
                                                    + int(idx[t])) * co(t, j))
                for j in range(4)])
            return
        s = q - rec[inits.T_SLOT]
        for p0 in range(0, nr, U):
            rws = range(p0, min(p0 + U, nr))
            a = [part(lambda t: gated(rec, t) * co(t, 1)
                      * value(r0 + u, idx[t])) for u in rws]
            m = [part(lambda t: gated(rec, t) * co(t, 2)
                      * value(r0 + u, idx[t])) for u in rws]
            if p0 == 0:
                ca = part(lambda t: gated(rec, t) * co(t, 3))
                cm = part(lambda t: gated(rec, t) * co(t, 0))
                ml = _sum(beta(int(liu_ref[t]))
                          for t in range(liu_starts[q], liu_starts[q + 1]))
                if s < rec[inits.T_SIZE]:
                    ml = ml + beta(rec[inits.T_B2] + s)
            for u, ar, mr in zip(rws, a, m):
                v = value(r0 + u, rec[inits.T_VOFF] + s)
                for arr, x in enumerate((v, ar + ca, cm + mr, v, Fq2(0), ml)):
                    put(rec, arr, r0 + u, s, x)

    _nt, nw, nb = plan.classes
    rs = T(plan.rs)
    rs_base = 2 * words * rows * plan.w_total
    for it in range(rs.shape[1]):          # tile 0's first threads
        src, dst, stride = rs[:, it]
        for p in range(2):
            out[rs_base + dst + p * stride] = cz[p, src]
            writes[rs_base + dst + p * stride] += 1
    for r0 in range(0, rows, tile):
        nr = min(tile, rows - r0)
        for q0 in range(0, n, 32):
            coop_warp(q0, r0, nr)
        for w in range(nw):
            summer(lists[w], r0, nr, 32)
        for b in range(nb):
            summer(lists[nw + b], r0, nr, K["THREADS"])
    return out, writes


@pytest.mark.parametrize("lead", [(), (2,), (2, 2), (5,)])
def test_emulated_kernel_matches_twins(both, lead, monkeypatch):
    cc, plans = both["cc"], both["plans"]
    rows = int(np.prod(lead))
    values, claims = _batch(both, rows)
    values = values.reshape((2,) + lead + (values.shape[-1],))
    claims = {i: t.reshape((2,) + lead) for i, t in claims.items()}
    p1_groups, p2_groups = protocol._groups(cc)
    # empty segments in the cooperative warps, one term a warp, longer
    # ones a block
    monkeypatch.setattr(inits, "THREAD_MAX", 0)
    monkeypatch.setattr(inits, "WARP_MAX", 1)
    seen = set()
    for plan, twin, cl in (
            (inits.p1_plan(cc, plans, p1_groups, "cpu"),
             inits.p1_inits_plain, None),
            (inits.p2_plan(cc, plans, p2_groups, "cpu"),
             inits.p2_inits_plain, claims)):
        c0 = inits.challenge_buffer(plan, both["ch"], cl)
        betas = [t.contiguous() for t in inits.beta_tables(plan, c0)]
        want = gf.to_numpy(twin(plan, values, c0, betas))
        got, writes = emulate(plan, values, c0, betas)
        assert np.array_equal(got, want), plan.stage
        assert (writes == 1).all(), plan.stage
        seen |= {k for k, n in enumerate(plan.classes) if n}
    assert seen == {inits.THREAD, inits.WARP, inits.BLOCK}


@pytest.mark.parametrize("lead", [(17,)])
def test_emulated_warps_match_twins(both, lead):
    """The cooperative warps at the plan's own thresholds (every slot of
    the small circuits a thread slot but the assert circuit's long ones),
    over more rows than a tile of either phase."""
    rows = int(np.prod(lead))
    values, claims = _batch(both, rows)
    values = values.reshape((2,) + lead + (values.shape[-1],))
    claims = {i: t.reshape((2,) + lead) for i, t in claims.items()}
    for plan, twin, cl in ((both["arrs"]["p1I"], inits.p1_inits_plain, None),
                           (both["arrs"]["p2I"], inits.p2_inits_plain,
                            claims)):
        c0 = inits.challenge_buffer(plan, both["ch"], cl)
        betas = [t.contiguous() for t in inits.beta_tables(plan, c0)]
        got, writes = emulate(plan, values, c0, betas)
        assert np.array_equal(got, gf.to_numpy(twin(plan, values, c0, betas)))
        assert (writes == 1).all() and plan.classes[0]


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _raise(*args, **kwargs):
    raise AssertionError("a twin called a dispatching chain or field op")


def _stage_inputs(both):
    p1, p2 = both["arrs"]["p1I"], both["arrs"]["p2I"]
    out = []
    for plan, cl in ((p1, None), (p2, both["claims"])):
        c0 = inits.challenge_buffer(plan, both["ch"], cl)
        out.append((plan, both["values"], c0, inits.beta_tables(plan, c0)))
    return out


def test_twins_use_only_the_plain_ops(both, monkeypatch):
    (p1_in, p2_in) = _stage_inputs(both)
    want = [inits.p1_inits_plain(*p1_in), inits.p2_inits_plain(*p2_in)]
    for name in ("mul", "add", "sub", "neg", "reduce_lazy"):
        monkeypatch.setattr(gf, name, _raise)
    for name in ("table", "segsum"):
        monkeypatch.setattr(chains, name, _raise)
    got = [inits.p1_inits_plain(*p1_in), inits.p2_inits_plain(*p2_in)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_dispatch_counts_plain_calls(both):
    p1_in, p2_in = _stage_inputs(both)
    kernels.reset_counts()
    inits.p1_inits(*p1_in)
    inits.p2_inits(*p2_in)
    assert kernels.PLAIN_CALLS["gkr_p1_inits"] == 1
    assert kernels.PLAIN_CALLS["gkr_p2_inits"] == 1
    assert kernels.LAUNCHES["gkr_p1_inits"] == 0
    assert kernels.LAUNCHES["gkr_p2_inits"] == 0


def test_cuda_wrappers_refuse_cpu_tensors_and_other_plans(both):
    p1_in, p2_in = _stage_inputs(both)
    for fn, ins in ((inits.p1_inits_cuda, p1_in), (inits.p2_inits_cuda, p2_in),
                    (inits.p1_inits_cuda, p2_in)):
        with pytest.raises(ValueError):
            fn(*ins)
