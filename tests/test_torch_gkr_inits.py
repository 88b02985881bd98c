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
  (the grid's three sections, a slot's table record, its term ranges, the
  packed beta references, the output addresses and the stacked
  challenges) on Python-int field elements, == the twins at forced small
  summer thresholds (all three classes) and lead axes, writing every
  output word exactly once;
* the twins call only ``gf``'s plain ops and ``chains.prefix_sum``, a CPU
  call counts ``kernels.PLAIN_CALLS``, and the CUDA wrappers refuse CPU
  tensors and a plan of the other stage.

Inputs are canonical, from the circuits' witnesses and numpy with a seed;
field arithmetic is exact, so the tolerance is 0.  The kernels run only on
a card: chip_smoke.py holds them against the twins there."""

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

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


def emulate(plan, values, c0, betas):
    """csrc/gkr_inits.cu's ``run`` item by item: the grid's thread, warp
    and block sections over the plan's class lists, each slot's table
    record and term ranges (a lane's terms lane, lane + step, ...), the
    packed beta references, the output addresses and the stacked
    challenges.  Returns (out, writes per word)."""
    T = lambda t: t.numpy()
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

    def slot(q, row, step):
        rec = tab[slot_tab[q]]
        s = q - rec[inits.T_SLOT]
        ar = (_f(cz, rec[inits.T_ASSERT]) if rec[inits.T_ASSERT] >= 0
              else Fq2(1))
        cu = (_f(cz, rec[inits.T_CLAIM] * rows + row + plan.nc_static)
              if plan.stage == 2 else None)
        sums = [Fq2(0)] * 3
        for lane in range(step):
            for t in range(starts[q] + lane, starts[q + 1], step):
                b = beta(rec[inits.T_BG] + int(gate[t] & 0x7FFFFFFF))
                if gate[t] >> 31:
                    b = b * ar
                A, B, C, D = (Fq2.raw(int(coef[2 * k, t]),
                                      int(coef[2 * k + 1, t]))
                              for k in range(4))
                if plan.stage == 1:
                    y = _f(vals[:, row], idx[t])
                    sums[0] = sums[0] + b * (B * y + D)
                    sums[1] = sums[1] + b * (A + C * y)
                else:
                    tmp = b * beta(rec[inits.T_B2] + int(idx[t]))
                    sums[0] = sums[0] + tmp * (A * cu + D)
                    sums[1] = sums[1] + tmp * (B + C * cu)
            if plan.stage == 1:
                for t in range(liu_starts[q] + lane, liu_starts[q + 1], step):
                    sums[2] = sums[2] + beta(int(liu_ref[t]))
        if plan.stage == 1:
            v = _f(vals[:, row], rec[inits.T_VOFF] + s)
            bsig = (beta(rec[inits.T_B2] + s) if s < rec[inits.T_SIZE]
                    else Fq2(0))
            for arr, x in enumerate((v, sums[0], sums[1], v, Fq2(0),
                                     bsig + sums[2])):
                put(rec, arr, row, s, x)
        else:
            v = _f(vals[:, row], dg[q]) if dg[q] >= 0 else Fq2(0)
            for arr, x in enumerate((v, sums[0], sums[1])):
                put(rec, arr, row, s, x)

    nt, nw, nb = plan.classes
    rs = T(plan.rs)
    rs_base = 2 * words * rows * plan.w_total
    for it in range(max(nt * rows, rs.shape[1])):
        if it < rs.shape[1]:
            src, dst, stride = rs[:, it]
            for p in range(2):
                out[rs_base + dst + p * stride] = cz[p, src]
                writes[rs_base + dst + p * stride] += 1
        if it < nt * rows:
            slot(lists[it % nt], it // nt, 1)
    for w in range(nw * rows):
        slot(lists[nt + w % nw], w // nw, 32)
    for b in range(nb * rows):
        slot(lists[nt + nw + b % nb], b // nb, 256)
    return out, writes


@pytest.mark.parametrize("lead", [(), (2,), (2, 2)])
def test_emulated_kernel_matches_twins(both, lead, monkeypatch):
    cc, plans = both["cc"], both["plans"]
    rows = int(np.prod(lead))
    values, claims = _batch(both, rows)
    values = values.reshape((2,) + lead + (values.shape[-1],))
    claims = {i: t.reshape((2,) + lead) for i, t in claims.items()}
    p1_groups, p2_groups = protocol._groups(cc)
    # empty segments a thread, one term a warp, longer ones a block
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
