"""The FFT and the FRI fold (``pc/fft.py``: ``gf_fft``; ``pc/virgo_pc.py``:
``gf_fri_fold``) on the CPU against the JAX package, and the kernels'
schedule emulated on the host.

On a CUDA tensor ``fft`` / ``ifft`` are ``fft.launches(lg_coef)``
launches of ``csrc/gf_fft.cu`` off a cached twiddle table, and
``fold_step`` one ``gf_fri_fold`` launch (``fold_levels``' one level, off
the cached table of the inverse root); on a CPU tensor they run the plain
twins (``fft_plain``, ``ifft_plain``, ``fold_levels_plain``).  Here:

* ``fft`` and ``ifft`` == the JAX functions (vmapped over the rows) for
  2^lg_coef coefficients onto 2^log_order points up to 2^10, lead axes
  (), (64,) and (4, 64), and strided input rows;
* ``fold_step`` == JAX ``fold_step`` at small N, and a batch of codewords
  == one call a codeword;
* ``emulate_gf_fft``, a host copy of ``gf_fft_tile``'s passes (the
  launch split and block rule, with the constants read from the source;
  which four slots a thread holds in each pass, the radix-2 and radix-4
  passes with the fourth root +-i, the twiddles' 32-bit indices into
  ``fft.stage_tables``, the stores) run with ``gf``'s plain ops, ==
  ``fft_plain`` at stage counts 0-13 (odd and even), at the timed prove's
  (lg_coef, order) pairs and on the multi-launch route, natural and at a
  forced small tile, each pass holding every slot once and each launch
  writing every output once; and == the JAX functions on the module's
  FFT and IFFT cases;
* ``kernels.row_layout`` (the rows the kernels read in place);
* the twins call only ``gf``'s plain ops, a CPU call counts
  ``kernels.PLAIN_CALLS`` and launches nothing, a CUDA tensor reaches the
  CUDA wrappers, and the wrappers refuse CPU tensors.

Inputs are canonical, from numpy with a seed; field arithmetic is exact,
so the tolerance is 0 everywhere.  The kernels run only on a card:
chip_smoke.py holds them against the twins there."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virgo_plus_tpu.pc import fft as jfft
from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import chains, gf
from virgo_plus_tpu_torch.pc import fft, virgo_pc

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD


def _source_constants(*names):
    """constexpr int constants of csrc/gf_fft.cu."""
    src = (kernels.CSRC / "gf_fft.cu").read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names]


# csrc/gf_fft.cu: entries a block (log2), the grid's least blocks before a
# block takes fewer columns, the threads at four slots below which a
# thread takes two, the most stages a launch
BLOCK_LOG, FFT_BLOCKS, FFT_PAIRS_BELOW, TILE_LOG = _source_constants(
    "BLOCK_LOG", "FFT_BLOCKS", "FFT_PAIRS_BELOW", "TILE_LOG")
# (lg_coef, log_order, lead): the paths' shapes (the slice IFFTs at 2^7 and
# 2^8, 128 coefficients onto 2^10 points) and edges (one coefficient, one
# point, short rows several to a block)
FFT_CASES = [(0, 0, ()), (0, 3, ()), (1, 1, ()), (3, 5, ()), (7, 7, (64,)),
             (7, 10, (64,)), (8, 8, (4, 64)), (2, 9, (4, 64)), (10, 10, ())]
IFFT_CASES = [(0, ()), (3, ()), (7, (64,)), (8, (4, 64))]
FOLD_N = (2, 8, 64)


def _canon(rng, *shape):
    return rng.integers(0, M, size=shape, dtype=np.uint64)


def _jax_rows(fn, x):
    """fn (2, n) -> (2, m) of the JAX package over every row of x (2,
    *lead, n), vmapped and jitted."""
    rows = x.reshape(2, -1, x.shape[-1])
    out = jax.jit(jax.vmap(fn, in_axes=1, out_axes=1))(jnp.asarray(rows))
    return np.asarray(out).reshape(x.shape[:-1] + (-1,))


@pytest.fixture(scope="module")
def refs():
    """{case: (coefficients, JAX evaluations)} for FFT_CASES,
    ("ifft", lg, lead) for IFFT_CASES and ("fold", N) for FOLD_N: ((cw,
    r), JAX fold_step)."""
    rng = np.random.default_rng(31)
    out = {}
    for lg_coef, log_order, lead in FFT_CASES:
        x = _canon(rng, 2, *lead, 1 << lg_coef)
        rou = gf.root_of_unity_int(log_order)
        out[(lg_coef, log_order, lead)] = (x, _jax_rows(
            lambda r: jfft.fft(r, log_order, rou), x))
    for lg, lead in IFFT_CASES:
        x = _canon(rng, 2, *lead, 1 << lg)
        rou = gf.root_of_unity_int(lg)
        out[("ifft", lg, lead)] = (x, _jax_rows(lambda r: jfft.ifft(r, rou),
                                                x))
    fold = jax.jit(jvpc.fold_step, static_argnums=2)
    for n in FOLD_N:
        cw, r = _canon(rng, 2, 65, n), _canon(rng, 2)
        out[("fold", n)] = ((cw, r), np.asarray(fold(
            jnp.asarray(cw), jnp.asarray(r), n.bit_length() - 1)))
    return out


@pytest.mark.parametrize("case", FFT_CASES, ids=str)
def test_fft_matches_jax(refs, case):
    x, want = refs[case]
    lg_coef, log_order, _ = case
    got = fft.fft(gf.tensor(x), log_order, gf.root_of_unity_int(log_order))
    assert np.array_equal(gf.to_numpy(got), want)


@pytest.mark.parametrize("case", IFFT_CASES, ids=str)
def test_ifft_matches_jax(refs, case):
    x, want = refs[("ifft",) + case]
    rou = gf.root_of_unity_int(case[0])
    assert np.array_equal(gf.to_numpy(fft.ifft(gf.tensor(x), rou)), want)
    assert np.array_equal(gf.to_numpy(fft.ifft_plain(gf.tensor(x), rou)),
                          want)


def test_strided_rows_match_jax(refs):
    """h_coef = lq_coef[..., srec:] and a transposed lead: views, not
    copies."""
    x, want = refs[(7, 10, (64,))]
    wide = np.concatenate([_canon(np.random.default_rng(32), 2, 64, 128), x],
                          axis=-1)
    view = gf.tensor(wide)[..., 128:]
    assert not view.is_contiguous()
    rou = gf.root_of_unity_int(10)
    assert np.array_equal(gf.to_numpy(fft.fft(view, 10, rou)), want)
    x, want = refs[(8, 8, (4, 64))]
    view = gf.tensor(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    view = view.transpose(1, 2)
    assert not view.is_contiguous()
    assert np.array_equal(gf.to_numpy(fft.fft(view, 8,
                                              gf.root_of_unity_int(8))),
                          want)


@pytest.mark.parametrize("n", FOLD_N)
def test_fold_step_matches_jax(refs, n):
    (cw, r), want = refs[("fold", n)]
    got = virgo_pc.fold_step(gf.tensor(cw), gf.tensor(r), n.bit_length() - 1)
    assert np.array_equal(gf.to_numpy(got), want)


def test_fold_step_batch_equals_single_calls():
    rng = np.random.default_rng(34)
    cws, r = gf.tensor(_canon(rng, 2, 3, 65, 32)), gf.tensor(_canon(rng, 2))
    got = virgo_pc.fold_step(cws, r, 5)
    assert got.shape == (2, 3, 65, 16)
    for b in range(3):
        assert torch.equal(got[:, b], virgo_pc.fold_step(cws[:, b], r, 5))


# ---------------------------------------------------------------------------
# gf_fft_tile's passes on the host
# ---------------------------------------------------------------------------

def _bitrev(t, k):
    out = np.zeros_like(t)
    for q in range(k):
        out |= ((t >> q) & 1) << (k - 1 - q)
    return out


def _insert0(b, pos):
    return ((b >> pos) << (pos + 1)) | (b & ((1 << pos) - 1))


def _pass_of(k, g, i, V=4):
    """pass_of<V>: (first stage r, radix 4, hi, lo)."""
    if V == 2:
        return (i, False, k - 1 - i + g, 0) if k else (0, False, 0, 0)
    if k == 0:
        return 0, False, 1, 0
    if k & 1:
        if i == 0:
            return 0, False, k - 1 + g, k - 2 + g if k >= 3 else g - 1
        r = 2 * i - 1
    else:
        r = 2 * i
    return r, True, k - 1 - r + g, k - 2 - r + g


def _at(tw, idx):
    """tw (N, 2) rows at idx -> (2, *idx.shape)."""
    return tw[torch.from_numpy(idx)].movedim(-1, 0)


def emulate_gf_fft(coeffs, log_order, rou_int, scale=None,
                   tile_log=TILE_LOG, block_log=BLOCK_LOG,
                   fft_blocks=FFT_BLOCKS, pairs_below=FFT_PAIRS_BELOW):
    """vpt_gf_fft and gf_fft_tile with every thread of every block of a
    launch side by side: the same launch split, choice of two or four
    slots a thread, block rule, slot groups, twiddle indices and radix-2 /
    radix-4 arithmetic, on gf's plain ops.  Asserts that each pass's
    groups hold every slot of a block once and that each launch writes
    every output once.  Returns (evaluations, launches, the slots a thread
    of each launch)."""
    lg_coef = coeffs.shape[-1].bit_length() - 1
    L, order = log_order, 1 << log_order
    lead = tuple(coeffs.shape[1:-1])
    R = math.prod(lead)
    src = coeffs.reshape(2, R, -1)
    tw = fft.stage_tables(chains.table_plain(chains.POWER, rou_int, None,
                                             order // 2, "cpu"))
    i_neg = L >= 2 and gf.pow_int(rou_int, 1 << (L - 2)) == (0, M - 1)
    neg = lambda v: gf.neg_plain(v)
    n = max(1, -(-lg_coef // tile_log))
    D, in_log, Vs = lg_coef - 1, lg_coef, []
    for i in range(n):
        k = lg_coef // n + (i < lg_coef % n)
        cols_log = L - k
        cols = R << cols_log
        V = 2 if k <= block_log and cols << k < 4 * pairs_below else 4
        v_log = V.bit_length() - 1
        g_min = v_log - k if k < v_log else 0
        g = block_log - k if k < block_log else 0
        blocks = lambda g: -(-cols // (1 << g))
        while g > g_min and blocks(g) < fft_blocks:
            g -= 1
        E = 1 << (k + g)
        C0 = (np.arange(blocks(g), dtype=np.int64) << g)[:, None]
        b = np.arange(E >> v_log, dtype=np.int64)[None, :]
        low, gmask, cmask = D - k + 1, (1 << g) - 1, (1 << cols_log) - 1
        col = lambda s: C0 + (s & gmask)

        def slots(P):
            _, _, hi, lo = P
            if V == 2:
                s0 = _insert0(b, hi)
                ss = [s0, s0 | (1 << hi)]
            else:
                s0 = _insert0(_insert0(b, lo), hi)
                ss = [s0 | ((e & 1) << lo) | ((e >> 1) << hi)
                      for e in range(4)]
            assert np.array_equal(np.sort(np.concatenate(ss, 1)[0]),
                                  np.arange(E))
            return ss

        def twiddles(P, s0):
            r, radix4, _, lo = P
            dep = D - r
            base = order - (order >> dep)
            high = lambda s: (col(s) & cmask) >> low
            top = _bitrev((s0 >> g) >> (k - r), r) if r else 0 * s0
            j = high(s0) | (top << (L - 1 - D))
            if V == 2:
                return [_at(tw, base + j)]
            if not radix4:
                return [_at(tw, base + high(s0)),
                        _at(tw, base + high(s0 | (1 << lo)))]
            below, half = order - (order >> (dep - 1)), order >> dep
            assert j.max() < half // 2
            j3 = 3 * j
            w_c = _at(tw, below + np.where(j3 < half, j3, j3 - half))
            w_c = torch.where(torch.from_numpy(j3 >= half), neg(w_c), w_c)
            return [_at(tw, base + j), _at(tw, below + j), w_c]

        def run(P, w, x):
            mul, add, sub = gf.mul_plain, gf.add_plain, gf.sub_plain
            if V == 2:
                t = mul(w[0], x[1])
                return [add(x[0], t), sub(x[0], t)]
            if not P[1]:
                t0, t1 = mul(w[0], x[2]), mul(w[1], x[3])
                return [add(x[0], t0), add(x[1], t1), sub(x[0], t0),
                        sub(x[1], t1)]
            c, bb, d = mul(w[0], x[2]), mul(w[1], x[1]), mul(w[2], x[3])
            u, v, sp, dm = add(x[0], c), sub(x[0], c), add(bb, d), sub(bb, d)
            idm = (torch.stack([dm[1], neg(dm[0])]) if i_neg
                   else torch.stack([neg(dm[1]), dm[0]]))
            return [add(u, sp), sub(u, sp), add(v, idm), sub(v, idm)]

        P = _pass_of(k, g, 0, V)
        ss, x = slots(P), []
        for s in ss:
            C = col(s)
            row = np.minimum(C >> cols_log, R - 1)
            c = C & cmask
            xi = ((c & ((1 << low) - 1)) | ((s >> g) << low)
                  | ((c >> low) << (D + 1)))
            v = src[:, torch.from_numpy(row),
                    torch.from_numpy(xi & ((1 << in_log) - 1))]
            x.append(torch.where(torch.from_numpy(C < cols), v, 0))
        passes = k if V == 2 else (k + 1) // 2
        for pi in range(passes):
            x = run(P, twiddles(P, ss[0]), x)
            if pi + 1 == passes:
                break
            sm = torch.zeros((2, C0.shape[0], E), dtype=torch.int64)
            blk = torch.arange(C0.shape[0])[:, None]
            for s, v in zip(ss, x):
                sm[:, blk, torch.from_numpy(s)] = v
            P = _pass_of(k, g, pi + 1, V)
            ss = slots(P)
            x = [sm[:, blk, torch.from_numpy(s)] for s in ss]
        dst = torch.zeros((2, R * order), dtype=torch.int64)
        outs = []
        for s, v in zip(ss, x):
            if scale is not None and i == n - 1:
                v = gf.mul_plain(v, gf.full((1,), scale[0], scale[1]))
            C = col(s)
            valid = C < cols
            o = (((C >> cols_log) << L) + (C & cmask)
                 + (_bitrev(np.broadcast_to(s >> g, C.shape), k) << cols_log))
            dst[:, torch.from_numpy(o[valid])] = v[:, torch.from_numpy(valid)]
            outs.append(o[valid])
        assert np.array_equal(np.sort(np.concatenate(outs)),
                              np.arange(R * order))
        src = dst.reshape(2, R, order)
        D, in_log = D - k, L
        Vs.append(V)
    return src.reshape((2,) + lead + (order,)), n, Vs


# (lg_coef, log_order, lead, tile_log, block_log, pairs_below, launches,
# slots a thread of each launch): stage counts 0-13, odd and even, one
# coefficient onto many points, a one-stage tile (its radix-2 pass pairs
# two columns), the timed prove's pairs (128 coefficients onto 2^12 at 64
# rows, the IFFTs at 2^7 and 2^8 over 64 rows: two slots a thread), short
# rows several to a block; 2^13 (two launches); then a forced small tile
# (2 and 3 launches, the ping-pong through the scratch buffer, blocks that
# hold several tiles and several rows), four slots forced where two would
# be taken and two forced where four would
P2 = FFT_PAIRS_BELOW
EMULATED = [(7, 12, (64,), TILE_LOG, BLOCK_LOG, P2, 1, [4]),
            (7, 7, (64,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (8, 8, (64,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (8, 8, (2, 3), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (11, 11, (), TILE_LOG, BLOCK_LOG, P2, 1, [4]),
            (0, 4, (3,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (0, 0, (), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (1, 1, (), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (1, 3, (3,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (2, 2, (3,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (3, 3, (5,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (5, 9, (2,), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (9, 9, (), TILE_LOG, BLOCK_LOG, P2, 1, [2]),
            (13, 13, (), TILE_LOG, BLOCK_LOG, P2, 2, [2, 2]),
            (7, 7, (64,), TILE_LOG, BLOCK_LOG, 0, 1, [4]),
            (0, 4, (3,), TILE_LOG, BLOCK_LOG, 0, 1, [4]),
            (1, 3, (3,), TILE_LOG, BLOCK_LOG, 0, 1, [4]),
            (3, 3, (5,), TILE_LOG, BLOCK_LOG, 0, 1, [4]),
            (5, 9, (2,), TILE_LOG, BLOCK_LOG, 0, 1, [4]),
            (13, 13, (), TILE_LOG, BLOCK_LOG, 0, 2, [4, 4]),
            (7, 12, (64,), TILE_LOG, BLOCK_LOG, 1 << 20, 1, [2]),
            (10, 10, (2,), 5, 6, P2, 2, [2, 2]),
            (7, 9, (3,), 4, 5, 0, 2, [4, 4]),
            (9, 9, (), 3, 4, P2, 3, [2, 2, 2]),
            (8, 11, (2,), 3, 2, 0, 3, [4, 4, 4])]


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_kernel_schedule_matches_the_twin(case):
    (lg_coef, log_order, lead, tile_log, block_log, pairs_below, launches,
     slots) = case
    rng = np.random.default_rng(35 + lg_coef)
    x = gf.tensor(_canon(rng, 2, *lead, 1 << lg_coef))
    rou = gf.root_of_unity_int(log_order)
    scale = tuple(int(v) for v in _canon(rng, 2))
    got, n, Vs = emulate_gf_fft(x, log_order, rou, scale, tile_log,
                                block_log, pairs_below=pairs_below)
    assert n == launches and Vs == slots
    if tile_log == TILE_LOG:
        assert TILE_LOG == fft.TILE_LOG and n == fft.launches(lg_coef)
    assert torch.equal(got, fft.fft_plain(x, log_order, rou, scale))


@pytest.mark.parametrize("case", FFT_CASES + [("ifft",) + c
                                              for c in IFFT_CASES], ids=str)
def test_kernel_schedule_matches_jax(refs, case):
    """The emulated passes on the module's inputs == the JAX functions
    (an IFFT at the inverse root with 1/n in the last store)."""
    x, want = refs[case]
    if case[0] == "ifft":
        args = fft._inverse(x.shape[-1], gf.root_of_unity_int(case[1]))
    else:
        args = (case[1], gf.root_of_unity_int(case[1]))
    for pairs_below in (FFT_PAIRS_BELOW, 0):      # as the kernel, four slots
        got, _, _ = emulate_gf_fft(gf.tensor(x), *args,
                                   pairs_below=pairs_below)
        assert np.array_equal(gf.to_numpy(got), want)


# ---------------------------------------------------------------------------
# rows, routing and counts
# ---------------------------------------------------------------------------

def test_row_layout():
    x = torch.zeros((2, 4, 64, 16), dtype=torch.int64)
    assert kernels.row_layout("t", x, 3) == ([1, 1, 256], [0, 0, 16])
    assert kernels.row_layout("t", x[..., 8:], 3) == ([1, 1, 256],
                                                      [0, 0, 16])
    assert kernels.row_layout("t", x.transpose(1, 2), 3) == (
        [1, 64, 4], [0, 16, 1024])
    assert kernels.row_layout("t", x[:, :, None, ::3], 3) == (
        [1, 4, 22], [0, 1024, 48])
    assert kernels.row_layout("t", x[:, 0, 0], 3) == ([1, 1, 1], [0, 0, 0])
    y = torch.zeros((2, 3, 5, 7, 2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="more than 3"):
        kernels.row_layout("t", y.permute(0, 4, 3, 2, 1, 5), 3)


def _raise(*args):
    raise AssertionError("a twin called a dispatching op or a kernel")


def test_twins_use_only_the_plain_ops(monkeypatch):
    rng = np.random.default_rng(36)
    x = gf.tensor(_canon(rng, 2, 4, 16))
    cw, w, r = (gf.tensor(_canon(rng, *s)) for s in ((2, 65, 8), (2, 4),
                                                      (2,)))
    rou = gf.root_of_unity_int(6)
    twins = [lambda: fft.fft_plain(x, 6, rou),
             lambda: fft.fft_plain(x, 4, gf.root_of_unity_int(4), (3, 5)),
             lambda: fft.ifft_plain(x, gf.root_of_unity_int(4)),
             lambda: virgo_pc.fold_step_plain(cw, w, r),
             lambda: torch.cat(virgo_pc.fold_levels_plain(cw, [r, r], 3),
                               dim=-1)]
    want = [twin() for twin in twins]
    for name in ("table", "segsum", "table_cuda", "segsum_cuda"):
        monkeypatch.setattr(chains, name, _raise)
    for name in ("mul", "add", "sub", "neg", "reduce_lazy", "mul_cuda",
                 "lin_cuda"):
        monkeypatch.setattr(gf, name, _raise)
    monkeypatch.setattr(fft, "fft_cuda", _raise)
    monkeypatch.setattr(virgo_pc, "fold_step_cuda", _raise)
    for twin, w_ in zip(twins, want):
        assert torch.equal(twin(), w_)


def test_cpu_dispatch_counts_plain_calls_and_cuda_wrappers_raise():
    rng = np.random.default_rng(37)
    x = gf.tensor(_canon(rng, 2, 3, 8))
    cw, r = gf.tensor(_canon(rng, 2, 65, 16)), gf.tensor(_canon(rng, 2))
    for entry, call in (
            ("gf_fft", lambda: fft.fft(x, 5, gf.root_of_unity_int(5))),
            ("gf_fft", lambda: fft.ifft(x, gf.root_of_unity_int(3))),
            ("gf_fri_fold", lambda: virgo_pc.fold_step(cw, r, 4))):
        plain, launches = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
        call()
        assert kernels.PLAIN_CALLS[entry] == plain[entry] + 1
        assert kernels.LAUNCHES == launches
    w = gf.tensor(_canon(rng, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fft.fft_cuda(x, 5, gf.root_of_unity_int(5))
    with pytest.raises(ValueError, match="CUDA"):
        virgo_pc.fold_step_cuda(cw, [r], 4)
    meta = torch.empty((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fft.fft(meta, 2, gf.root_of_unity_int(2))


def test_cuda_tensors_reach_the_kernel_wrappers(monkeypatch):
    """The dispatch hands a CUDA tensor (here: any tensor, the device test
    patched) to fft_cuda with the IFFT's inverse root and 1/n, and to
    fold_step_cuda as one level at fold_step's order on one device (the
    kernel takes its twiddles from fft.twiddles' cache)."""
    calls = []
    monkeypatch.setattr(gf, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fft, "fft_cuda", lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(virgo_pc, "fold_step_cuda",
                        lambda *a: calls.append(a) or [a[0]])
    monkeypatch.setattr(chains, "table", chains.table_plain)
    rng = np.random.default_rng(38)
    x = gf.tensor(_canon(rng, 2, 8))
    rou = gf.root_of_unity_int(3)
    fft.fft(x, 5, rou)
    fft.ifft(x, rou)
    cw, r = gf.tensor(_canon(rng, 2, 65, 16)), gf.tensor(_canon(rng, 2))
    virgo_pc.fold_step(cw, r, 4)
    assert calls[0][1:] == (5, rou)
    assert calls[1][1:] == (3, gf.pow_int(rou, 7),
                            gf.pow_int((8, 0), M - 2))
    assert calls[2][0] is cw and len(calls[2][1]) == 1
    assert calls[2][1][0] is r and calls[2][2:] == (4, (1, 0))
