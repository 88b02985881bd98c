"""The field chains (``field/chains.py``: ``gf_table``, ``gf_segsum``) and
their call sites, on the CPU against the JAX package.

``chains.table`` builds beta and power tables, ``chains.segsum`` sums
segments of the last axis; on a CUDA tensor each is one launch of
``csrc/gf_chains.cu``, on a CPU tensor the plain twin.  Here:

* the port's ``beta_table`` / ``beta_tables_batched`` (k = 0, 1, 5, 9;
  K = 3; a strided r), ``fft.powers`` (n a power of two and not) and
  ``chains.table`` of tensor bases == the JAX functions (``fft.powers``,
  ``fft_gkr.powers_el``);
* ``tree_sum`` (lengths 0, 1, 7, 64, 1000, rank 3) and
  ``apply_scatter_arrays`` on a random ``ScatterPlan`` with empty segments
  == JAX;
* the restated phase-2 combine ``protocol._prove_p2_combine`` == JAX
  ``_prove_p2_combine`` on the phase-2 fold results of small ``randomize``
  circuits (one with bound terms below a layer's largest dad table, one
  without), and with a batch lead (3,) == three single calls;
* ``emulate_gf_table``, a host copy of ``gf_table``'s blocks (the task
  size rule with the constants read from the source; the block's
  factors: beta r_j and 1 - r_j, a by-value base's host squarings from
  ``chains.power_factors``, a tensor base's squarings; the four groups of
  bits a lane, chunk, warp and block; one product an entry) on ``gf``'s
  plain ops, == ``table_plain`` and the JAX functions for beta and power
  tables at k = 0, 1, 2, 5, 8, 9, 13, at forced small tasks and at 40
  bits;
* ``emulate_cluster_segsum``, a host copy of ``gf_segsum``'s cluster
  route (an output's chunks over a cluster's blocks, LAZY loads a fold,
  the leader's sum of the partials), == ``segsum_plain`` at N = 1, 7,
  2^10 + 3 and 2^14, and ``seg_cluster``'s rule;
* the twins run with the dispatching chains and field ops patched to
  raise, so on the card they launch no kernel of X1;
* the CPU dispatch counts ``kernels.PLAIN_CALLS`` and launches nothing;
  the card wrappers raise on CPU tensors, another device raises.

Inputs are canonical, from numpy with a seed; field arithmetic is exact,
so the tolerance is 0.  The kernels run only on a card: chip_smoke.py holds
them against the twins there."""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from virgo_plus_tpu.gkr import beta as jbeta
from virgo_plus_tpu.gkr import protocol as jprotocol
from virgo_plus_tpu.gkr import sumcheck as jsumcheck
from virgo_plus_tpu.pc import fft as jfft
from virgo_plus_tpu.pc import fft_gkr as jfft_gkr
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.circuits.compile import (compile_circuit,
                                                   eval_arrays, evaluate,
                                                   input_buffer)
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.field import chains, gf
from virgo_plus_tpu_torch.gkr import beta, protocol, sumcheck
from virgo_plus_tpu_torch.pc import fft
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
BITS = (0, 1, 5, 9)
POWERS = (1, 7, 64, 100)
LENGTHS = (0, 1, 7, 64, 1000)


def _canon(rng, *shape):
    return rng.integers(0, M, size=shape, dtype=np.uint64)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def tables():
    """Inputs and the JAX package's tables: {k: (init, r, inits, rs,
    want_one, want_batched)}, powers {n: (base, els, want, want_els)}."""
    rng = np.random.default_rng(11)
    betas = {}
    for k in BITS:
        init, r = _canon(rng, 2), _canon(rng, 2, k + 2)
        inits, rs = _canon(rng, 2, 3), _canon(rng, 2, 3, 2 * k + 1)[..., ::2]
        J = jnp.asarray
        betas[k] = (init, r, inits, rs,
                    _np(jbeta.beta_table(J(r), k, J(init))),
                    _np(jbeta.beta_tables_batched(J(rs), k, J(inits))))
    powers = {}
    for n in POWERS:
        base = tuple(int(v) for v in _canon(rng, 2))
        els = _canon(rng, 2, 3)
        powers[n] = (base, els, _np(jfft.powers(base, n)),
                     [_np(jfft_gkr.powers_el(jnp.asarray(els[:, c]), n))
                      for c in range(3)])
    return betas, powers


@pytest.mark.parametrize("k", BITS)
def test_beta_tables_match_jax(tables, k):
    init, r, inits, rs, want, want_b = tables[0][k]
    got = beta.beta_table(gf.tensor(r), k, gf.tensor(init))
    assert np.array_equal(gf.to_numpy(got), want)
    # rs is a strided view (every other bit): read in place
    rs_t = gf.tensor(np.ascontiguousarray(rs.base))[..., ::2]
    assert not rs_t.is_contiguous() or k == 0
    got = beta.beta_tables_batched(rs_t, k, gf.tensor(inits))
    assert np.array_equal(gf.to_numpy(got), want_b)


@pytest.mark.parametrize("n", POWERS)
def test_power_tables_match_jax(tables, n):
    base, els, want, want_els = tables[1][n]
    assert np.array_equal(gf.to_numpy(fft.powers(base, n, "cpu")), want)
    got = gf.to_numpy(chains.table(chains.POWER, gf.tensor(els), None, n,
                                   "cpu"))
    assert got.shape == (2, 3, n)
    for c in range(3):
        assert np.array_equal(got[:, c], want_els[c])


@pytest.fixture(scope="module")
def sums():
    """Tree sums {N: (x (2, 3, N), JAX sums (2, 3))} and a scatter with
    empty segments (values, plan, JAX result)."""
    rng = np.random.default_rng(12)
    trees = {}
    for n in LENGTHS:
        x = _canon(rng, 2, 3, n)
        trees[n] = (x, np.stack([_np(jsumcheck.tree_sum(jnp.asarray(x[:, c])))
                                 for c in range(3)], axis=1))
    # destinations 0..39 of 64, every fifth left empty, the last ones too
    idx = rng.integers(0, 40, 600)
    idx = idx[idx % 5 != 0]
    plan = sumcheck.ScatterPlan.build(idx, 64)
    values = _canon(rng, 2, len(idx))
    jarrs = tuple(jnp.asarray(a) for a in (plan.perm, plan.starts, plan.ends))
    want = _np(jsumcheck.apply_scatter_arrays(jnp.asarray(values), jarrs))
    return trees, (values, plan, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_tree_sum_matches_jax(sums, n):
    x, want = sums[0][n]
    got = sumcheck.tree_sum(gf.tensor(x))
    assert np.array_equal(gf.to_numpy(got), want)


def test_scatter_matches_jax(sums):
    values, plan, want = sums[1]
    assert np.sum(plan.starts == plan.ends) >= 8     # empty segments
    got = sumcheck.apply_scatter_arrays(gf.tensor(values),
                                        plan.arrays("cpu"))
    assert np.array_equal(gf.to_numpy(got), want)


def _p2_results(cc, seed):
    """The phase-2 fold results {(i, li): (polys (bl, 2, 3), (vb, ab, mb))}
    of a prove of cc's default witness under GlibcRandom(seed)."""
    plans = protocol.build_plans(cc)
    arrs = protocol.circuit_arrays(cc, plans, "cpu")
    ch = protocol.make_challenges(cc, GlibcRandom(seed), "cpu")
    values = evaluate(cc, input_buffer(cc, None, "cpu"),
                      eval_arrays(cc, "cpu"))
    _, p1s, lius = protocol._prove_inits(cc, plans, values, ch, arrs)
    p1_res, _ = protocol._prove_folds(cc, p1s, lius)
    p2s = protocol._prove_p2_inits(cc, plans, values, ch,
                                   protocol._claims(p1_res), arrs)
    _, groups = protocol._groups(cc)
    res = {}
    for bl, job in sorted(p2s.items()):
        polys, bounds = protocol._fold_stacked(*job)
        for k, tag in enumerate(groups[bl]):
            res[tag] = (polys[..., k, :], tuple(b[..., k] for b in bounds))
    return ch, res


# randomize(4, 3): layers whose smaller dad tables add bound terms below
# their max_dad_bit_length; randomize(3, 7): none
CIRCUITS = [(4, 3, 5), (3, 7, 21)]


@pytest.fixture(scope="module", params=CIRCUITS, ids=lambda p: f"{p[:2]}")
def combine(request):
    layers, bits, seed = request.param
    c = randomize(layers, bits, seed=seed)
    subset_init(c)
    cc = compile_circuit(c)
    ch, res = _p2_results(cc, 3396)
    J = lambda t: jnp.asarray(gf.to_numpy(t))
    jch = SimpleNamespace(layers=[
        None if lc is None else SimpleNamespace(
            r_v=None if lc.r_v is None else J(lc.r_v)) for lc in ch.layers])
    want = jprotocol._prove_p2_combine(
        cc, jch, {t: (J(p), tuple(J(b) for b in bs))
                  for t, (p, bs) in res.items()})
    return cc, ch, res, {i: tuple(_np(a) for a in v) for i, v in want.items()}


def test_p2_combine_matches_jax(combine):
    cc, ch, res, want = combine
    got = protocol._prove_p2_combine(cc, ch, res, ())
    assert got.keys() == want.keys()
    for i, (polys, claims) in got.items():
        assert np.array_equal(gf.to_numpy(polys), want[i][0]), i
        assert np.array_equal(gf.to_numpy(claims), want[i][1]), i


def test_p2_combine_batch_equals_single_calls(combine):
    cc, ch, res, _ = combine
    rng = np.random.default_rng(13)
    # two more instances: the fold results with canonical noise added
    runs = [res] + [{t: (gf.add(p, gf.tensor(_canon(rng, *p.shape))),
                         tuple(gf.add(b, gf.tensor(_canon(rng, *b.shape)))
                               for b in bs))
                     for t, (p, bs) in res.items()} for _ in range(2)]
    batch = {t: (torch.stack([r[t][0] for r in runs], dim=2),
                 tuple(torch.stack([r[t][1][k] for r in runs], dim=1)
                       for k in range(3))) for t in res}
    got = protocol._prove_p2_combine(cc, ch, batch, (3,))
    for b, r in enumerate(runs):
        single = protocol._prove_p2_combine(cc, ch, r, ())
        for i, (polys, claims) in single.items():
            assert torch.equal(got[i][0][:, :, b], polys), (b, i)
            assert torch.equal(got[i][1][:, :, b], claims), (b, i)


# ---------------------------------------------------------------------------
# gf_table's warp tasks on the host
# ---------------------------------------------------------------------------

def _table_constants(*names):
    """constexpr int constants of csrc/gf_chains.cu."""
    src = (kernels.CSRC / "gf_chains.cu").read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names]


TASK_LOG, MIN_TASK_LOG, TABLE_BLOCKS = _table_constants(
    "TASK_LOG", "MIN_TASK_LOG", "TABLE_BLOCKS")


def emulate_gf_table(op, a, r, n, task_log=TASK_LOG,
                     min_task_log=MIN_TASK_LOG, table_blocks=TABLE_BLOCKS,
                     only=None):
    """vpt_gf_table and gf_table with every thread of every block side by
    side: the same task size rule, the block's factors (beta r_j and
    1 - r_j, a by-value base's host squarings from ``chains.power_factors``,
    a tensor base's squarings), the four groups of bits (lo over a lane's
    five bits, mid over a chunk's with the init, wrp over a warp's three,
    blk over a block's, each the product of its factors) and one product
    hb[chunk] lo[lane] an entry, on gf's plain ops.  Returns (tables,
    task_log); with `only` (block indices, one table) the (2, blocks,
    2^(task_log + 3)) entries of those blocks instead of the tables."""
    mul = gf.mul_plain
    one = lambda *s: gf.ones(s, "cpu")
    tensor = isinstance(a, torch.Tensor)
    k = max(n - 1, 0).bit_length()
    lead = a.shape[1] if tensor and a.dim() == 2 else 1
    blocks = lambda log: -(-n >> (log + 3))
    while task_log > min_task_log and blocks(task_log) * lead < table_blocks:
        task_log -= 1
    tl, nblk = task_log, blocks(task_log)
    assert nblk * lead < 1 << 31
    out = []
    for t in range(lead):
        f1, f0 = one(64), one(64)
        init = one(1)[:, 0]
        if op == chains.BETA:
            rt = r[:, t] if r.dim() == 3 else r
            f1[:, :k] = rt[:, :k]
            f0[:, :k] = gf.sub_plain(one(k), rt[:, :k])
            init = a[:, t] if a.dim() == 2 else a
        elif tensor:
            x = a[:, t] if a.dim() == 2 else a
            for j in range(k):
                f1[:, j] = x
                x = mul(x, x)
        else:
            words = list(chains.power_factors(tuple(a), k))[:2 * k]
            f1[:, :k] = torch.tensor(words, dtype=torch.int64).reshape(
                -1, 2).T

        def group(j0, bits, limit, sel):
            """prod_{b < bits, j0 + b < limit} (bit b of sel ? f1 : f0)
            [j0 + b], for each value of the tensor sel."""
            x = one(*sel.shape)
            for b in range(bits):
                if j0 + b < limit:
                    x = mul(x, torch.where(((sel >> b) & 1).bool(),
                                           f1[:, j0 + b, None],
                                           f0[:, j0 + b, None]))
            return x

        idx = torch.arange(32)
        lo = group(0, 5, k, idx)
        mid = mul(init[:, None], group(5, 5, min(tl, k), idx))
        wrp = group(tl, 3, k, torch.arange(8))
        bt = torch.arange(nblk) if only is None else only
        blk = group(tl + 3, max(k - tl - 3, 0), k, bt)    # (2, blocks)
        hb = mul(mul(blk[:, :, None], wrp[:, None, :])[..., None],
                 mid[:, None, None, :])                   # (2, blk, warp, lane)
        ent = mul(hb[..., :1 << (tl - 5), None], lo[:, None, None, None, :])
        ent = ent.reshape(2, bt.shape[0], -1)
        if only is not None:
            return ent, tl
        out.append(ent.reshape(2, -1)[:, :n])
    got = torch.stack(out, 1)
    return (got if tensor and a.dim() == 2 else got[:, 0]), tl


EMU_BITS = (0, 1, 2, 5, 8, 9, 13)


@pytest.mark.parametrize("k", EMU_BITS)
def test_table_tasks_match_the_twin_and_jax(tables, k):
    """Beta tables (one, and three batched over strided rs) and power
    tables (a by-value base, n not a power of two past k = 1; two tensor
    bases) at 2^k entries == table_plain, and == JAX where the module's
    fixture holds k (BITS)."""
    rng = np.random.default_rng(16 + k)
    T = gf.tensor
    if k in BITS:
        init, r, inits, rs, want, want_b = tables[0][k]
        rs_t = T(np.ascontiguousarray(rs.base))[..., ::2]
    else:
        init, r, inits = _canon(rng, 2), _canon(rng, 2, k), _canon(rng, 2, 3)
        rs_t, want, want_b = T(_canon(rng, 2, 3, k)), None, None
    n = 1 << k
    base = tuple(int(v) for v in _canon(rng, 2))
    cases = [(chains.BETA, T(init), T(r)[:, :k], n, want),
             (chains.BETA, T(inits), rs_t[..., :k], n, want_b),
             (chains.POWER, base, None, n - (k > 1), None),
             (chains.POWER, T(_canon(rng, 2, 2)), None, n, None)]
    for op, a, r_, m, w in cases:
        got, _ = emulate_gf_table(op, a, r_, m)
        if w is not None:
            assert np.array_equal(gf.to_numpy(got), w), (op, m)
        assert torch.equal(got, chains.table_plain(op, a, r_, m, "cpu"))


@pytest.mark.parametrize("n", POWERS)
def test_power_table_tasks_match_jax(tables, n):
    base, els, want, want_els = tables[1][n]
    got, _ = emulate_gf_table(chains.POWER, base, None, n)
    assert np.array_equal(gf.to_numpy(got), want)
    got, _ = emulate_gf_table(chains.POWER, gf.tensor(els), None, n)
    for c in range(3):
        assert np.array_equal(gf.to_numpy(got[:, c]), want_els[c])


# (op, k, task_log, least task_log): a by-value power table of 40 bits
# (2^26 blocks, their bits past 32 tested), beta and power at a forced
# small task (several warps and blocks a table, one and two chunks a warp)
@pytest.mark.parametrize("op, k, task_log, min_log", [
    (chains.POWER, 40, 10, 10), (chains.BETA, 12, 7, 5),
    (chains.POWER, 11, 6, 6)])
def test_table_tasks_at_forced_sizes(op, k, task_log, min_log):
    rng = np.random.default_rng(17 + k)
    T = gf.tensor
    if op == chains.BETA:
        a, r, n = T(_canon(rng, 2, 2)), T(_canon(rng, 2, 2, k)), 1 << k
    else:
        a, r = tuple(int(v) for v in _canon(rng, 2)), None
        n = (1 << (k - 1)) + 77
    if k > 32:
        # 2^39 + 77 entries: a few blocks (the first, ones with high bits
        # set, the last) against pow_int
        only = torch.tensor([0, 1, (1 << 25) + 5, (1 << 26) - 1,
                             (n - 1) >> (min_log + 3)])
        got, log = emulate_gf_table(op, a, r, n, task_log, min_log, 1 << 30,
                                    only)
        assert log == min_log
        for i, q in enumerate(only.tolist()):
            for e in (0, 1, 31, 4095, 8191):
                want = gf.pow_int(a, (q << (log + 3)) + e)
                assert tuple(got[:, i, e].tolist()) == want, (q, e)
        return
    got, log = emulate_gf_table(op, a, r, n, task_log, min_log, 1 << 30)
    assert log == min_log
    assert torch.equal(got, chains.table_plain(op, a, r, n, "cpu"))


# ---------------------------------------------------------------------------
# gf_segsum's cluster route on the host
# ---------------------------------------------------------------------------

def test_segsum_constants_match_the_source():
    assert _table_constants("THREADS", "LAZY", "SEG_CLUSTER") == [
        chains.SEG_THREADS, chains.LAZY, chains.SEG_CLUSTER]


def emulate_cluster_segsum(x, plan, cs):
    """csrc/gf_chains.cu's gf_segsum<SEG_BLOCK> with clusters of `cs`
    blocks on Python ints: block `rank` of an output's cluster sums the
    rank-th chunk of its segment, each thread LAZY loads at a time (those
    past the chunk predicated off) then one fold (the lazy sum checked
    below 2^64); the warp and block sums, the partials in the leader's
    shared memory and its sum of them.  Returns (*rows, G)."""
    T, LAZY, P = chains.SEG_THREADS, chains.LAZY, M
    words = x.reshape(-1, x.shape[-1]).numpy().view(np.uint64)
    idx, starts, ends = plan if plan is not None else (None, None, None)
    segs = ([(0, x.shape[-1])] if starts is None
            else list(zip(starts.tolist(), ends.tolist())))
    take = (lambda t: t) if idx is None else idx.tolist().__getitem__

    def fold(s):
        assert s < 2 ** 64
        t = (s >> 61) + (s & P)
        return t - P if t >= P else t

    out = np.zeros((len(words), len(segs)), dtype=np.uint64)
    for o in range(out.size):
        row, (lo, hi) = words[o // len(segs)], segs[o % len(segs)]
        chunk = -(-(hi - lo) // cs)
        parts = []
        for rank in range(cs):
            clo = min(hi, lo + rank * chunk)
            chi = min(hi, clo + chunk)
            block = 0
            for tid in range(T):
                s = 0
                for t in range(clo + tid, chi, LAZY * T):
                    s = fold(s + sum(int(row[take(k)]) for k in range(
                        t, min(chi, t + LAZY * T), T)))
                block = (block + s) % P
            parts.append(block)
        out.flat[o] = sum(parts) % P
    return torch.from_numpy(out.view(np.int64).reshape(
        tuple(x.shape[:-1]) + (len(segs),)))


@pytest.mark.parametrize("n", [1, 7, (1 << 10) + 3, 1 << 14])
def test_emulated_cluster_segsum_matches_twin(n):
    rng = np.random.default_rng(n)
    x = gf.tensor(_canon(rng, 2, n))
    plans = [None]
    if n > 7:      # three segments, one empty, over a permutation
        cut = n // 3
        plans.append((torch.from_numpy(rng.permutation(n)),
                      torch.tensor([0, cut, cut]),
                      torch.tensor([cut, cut, n])))
    for plan in plans:
        want = chains.segsum_plain(x, *(plan or (None, None, None)))
        mine = chains.seg_cluster(want.numel())
        for cs in sorted({1, 3, mine, chains.SEG_CLUSTER}):
            got = emulate_cluster_segsum(x, plan, cs)
            assert torch.equal(got, want), (cs, plan is None)


def test_seg_cluster_rule():
    """vres (2 outputs) and the fft_gkr tape's sums take SEG_CLUSTER = 8
    blocks an output; 3 rows of 2 planes 8; 44 outputs 3; B = 64's 128
    rows one (the block route)."""
    assert chains.seg_cluster(2) == chains.SEG_CLUSTER == 8
    assert chains.seg_cluster(6) == 8
    assert chains.seg_cluster(44) == 3
    assert chains.seg_cluster(128) == 1


def _raise(*args):
    raise AssertionError("a twin called a dispatching chain or field op")


def test_twins_use_only_the_plain_ops(monkeypatch):
    rng = np.random.default_rng(14)
    inits, rs = gf.tensor(_canon(rng, 2, 3)), gf.tensor(_canon(rng, 2, 3, 6))
    base = gf.tensor(_canon(rng, 2, 3))
    x = gf.tensor(_canon(rng, 2, 3, 50))
    plan = sumcheck.ScatterPlan.build(rng.integers(0, 9, 50), 12).arrays("cpu")
    v, a, m = (gf.tensor(_canon(rng, 2, 3, 16)) for _ in range(3))
    twins = [lambda: chains.table_plain(chains.BETA, inits, rs, 64, "cpu"),
             lambda: chains.table_plain(chains.POWER, base, None, 37, "cpu"),
             lambda: chains.table_plain(chains.POWER, (5, 7), None, 9, "cpu"),
             lambda: chains.segsum_plain(x, None, None, None),
             lambda: chains.segsum_plain(x, *plan),
             lambda: sumcheck.fold_plain(v, a, m, rs[..., :4])]
    want = [twin() for twin in twins]
    for name in ("table", "segsum", "table_cuda", "segsum_cuda"):
        monkeypatch.setattr(chains, name, _raise)
    for name in ("mul", "add", "sub", "neg", "reduce_lazy", "mul_cuda",
                 "lin_cuda"):
        monkeypatch.setattr(gf, name, _raise)
    for twin, w in zip(twins, want):
        got = twin()
        got, w = ((got[0], w[0]) if isinstance(got, tuple) else (got, w))
        assert torch.equal(got, w)


def test_cpu_dispatch_counts_plain_calls_and_cuda_wrappers_raise():
    rng = np.random.default_rng(15)
    init, r = gf.tensor(_canon(rng, 2)), gf.tensor(_canon(rng, 2, 4))
    x = gf.tensor(_canon(rng, 2, 10))
    for entry, call in (
            ("gf_table", lambda: chains.table(chains.BETA, init, r, 16,
                                              "cpu")),
            ("gf_table", lambda: chains.table(chains.POWER, (3, 4), None, 5,
                                              "cpu")),
            ("gf_segsum", lambda: chains.segsum(x))):
        plain, launches = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
        call()
        assert kernels.PLAIN_CALLS[entry] == plain[entry] + 1
        assert kernels.LAUNCHES == launches
    with pytest.raises(ValueError, match="CUDA"):
        chains.table_cuda(chains.BETA, init, r, 16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        chains.table_cuda(chains.POWER, (3, 4), None, 5, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        chains.segsum_cuda(x, None, None, None)
    meta = torch.empty((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        chains.segsum(meta)
    with pytest.raises(ValueError, match="meta"):
        chains.table(chains.POWER, meta[:, 0], None, 4, meta.device)
