"""The FFT and the FRI fold (``pc/fft.py``: ``gf_fft``; ``pc/virgo_pc.py``:
``gf_fri_fold``) on the CPU against the JAX package, and the kernels'
schedule emulated on the host.

On a CUDA tensor ``fft`` / ``ifft`` are one twiddle table and
``fft.launches(lg_coef)`` launches of ``csrc/gf_fft.cu``, and ``fold_step``
a twiddle table and one ``gf_fri_fold`` launch; on a CPU tensor they run the
plain twins (``fft_plain``, ``ifft_plain``, ``fold_step_plain``).  Here:

* ``fft`` and ``ifft`` == the JAX functions (vmapped over the rows) for
  2^lg_coef coefficients onto 2^log_order points up to 2^10, lead axes
  (), (64,) and (4, 64), and strided input rows;
* ``fold_step`` == JAX ``fold_step`` at small N, and a batch of codewords
  == one call a codeword;
* ``emulate_gf_fft``, a line-by-line host copy of ``gf_fft_tile``'s
  index arithmetic (which tile slot a thread loads, pairs, twiddles and
  stores) run with ``gf``'s plain ops, == ``fft_plain`` on the
  shared-memory route (one launch) and on the multi-launch route at a
  forced small tile, writing every output exactly once;
* ``kernels.row_layout`` (the rows the kernels read in place);
* the twins call only ``gf``'s plain ops, a CPU call counts
  ``kernels.PLAIN_CALLS`` and launches nothing, a CUDA tensor reaches the
  CUDA wrappers, and the wrappers refuse CPU tensors.

Inputs are canonical, from numpy with a seed; field arithmetic is exact,
so the tolerance is 0 everywhere.  The kernels run only on a card:
chip_smoke.py holds them against the twins there."""

import math

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

M = gf.MOD
BLOCK_LOG = 9    # csrc/gf_fft.cu: least entries a block holds
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
# gf_fft_tile's schedule on the host
# ---------------------------------------------------------------------------

def _bitrev(t, k):
    out = np.zeros_like(t)
    for q in range(k):
        out |= ((t >> q) & 1) << (k - 1 - q)
    return out


def emulate_gf_fft(coeffs, log_order, rou_int, scale=None,
                   tile_log=fft.TILE_LOG, block_log=BLOCK_LOG):
    """vpt_gf_fft and gf_fft_tile with every block of a launch side by
    side: the same launch split, tile and block sizes, and the same index
    formulas for loads, butterfly slots, twiddle exponents and stores, on
    gf's plain ops.  Asserts that each launch writes every output once."""
    lg_coef = coeffs.shape[-1].bit_length() - 1
    L, order = log_order, 1 << log_order
    lead = tuple(coeffs.shape[1:-1])
    R = math.prod(lead)
    src = coeffs.reshape(2, R, -1)
    tw = chains.table_plain(chains.POWER, rou_int, None, order // 2, "cpu")
    n = max(1, -(-lg_coef // tile_log))
    D, in_log = lg_coef - 1, lg_coef
    for i in range(n):
        k = lg_coef // n + (i < lg_coef % n)
        cols_log = L - k
        cols = R << cols_log
        g = max(block_log - k, 0)
        while g > 0 and (1 << (g - 1)) >= cols:
            g -= 1
        E = 1 << (k + g)
        gmask, cmask, low = (1 << g) - 1, (1 << cols_log) - 1, D - k + 1
        C0 = np.arange(-(-cols // (1 << g)), dtype=np.int64)[:, None] << g
        s = np.arange(E, dtype=np.int64)[None, :]
        C = C0 + (s & gmask)                              # (blocks, E)
        valid = C < cols
        c, row = C & cmask, np.minimum(C >> cols_log, R - 1)
        x = (c & ((1 << low) - 1)) | ((s >> g) << low) | ((c >> low)
                                                          << (D + 1))
        sm = src[:, torch.from_numpy(row), torch.from_numpy(
            x & ((1 << in_log) - 1))]                     # (2, blocks, E)
        for r in range(k):
            dep, p = D - r, k - 1 - r
            b = np.arange(E // 2, dtype=np.int64)[None, :]
            cc, tb = b & gmask, b >> g
            te = ((tb >> p) << (p + 1)) | (tb & ((1 << p) - 1))
            j = ((C0 + cc) & cmask) >> low
            for q in range(r):
                j = j | (((te >> (k - r + q)) & 1) << (L - D - 2 + r - q))
            e = j << dep
            assert e.max() < order // 2
            se = (te << g) | cc
            so = se + (1 << (p + g))
            se, so = (torch.from_numpy(np.broadcast_to(a, e.shape).copy())
                      for a in (se, so))
            blk = torch.arange(e.shape[0])[:, None]
            t = gf.mul_plain(tw[:, torch.from_numpy(e)], sm[:, blk, so])
            ev = sm[:, blk, se]
            sm = sm.clone()
            sm[:, blk, se] = gf.add_plain(ev, t)
            sm[:, blk, so] = gf.sub_plain(ev, t)
        if scale is not None and i == n - 1:
            sm = gf.mul_plain(sm, gf.full((1,), scale[0], scale[1]))
        o = ((C >> cols_log) * order + c
             + (_bitrev(np.broadcast_to(s >> g, C.shape), k) << cols_log))
        o = o[valid]
        assert np.array_equal(np.sort(o), np.arange(R * order))
        dst = torch.zeros((2, R * order), dtype=torch.int64)
        dst[:, torch.from_numpy(o)] = sm[:, torch.from_numpy(valid)]
        src = dst.reshape(2, R, order)
        D, in_log = D - k, L
    return src.reshape((2,) + lead + (order,)), n


# (lg_coef, log_order, lead, tile_log, block_log, launches): the paths'
# shapes on the one-launch route, then a forced small tile (2 and 3
# launches, the ping-pong through the scratch buffer, blocks that hold
# several tiles and several rows)
EMULATED = [(7, 12, (64,), fft.TILE_LOG, BLOCK_LOG, 1),
            (7, 7, (64,), fft.TILE_LOG, BLOCK_LOG, 1),
            (8, 8, (2, 3), fft.TILE_LOG, BLOCK_LOG, 1),
            (11, 11, (), fft.TILE_LOG, BLOCK_LOG, 1),
            (0, 4, (3,), fft.TILE_LOG, BLOCK_LOG, 1),
            (3, 3, (5,), fft.TILE_LOG, BLOCK_LOG, 1),
            (10, 10, (2,), 5, 6, 2), (7, 9, (3,), 4, 5, 2),
            (9, 9, (), 3, 4, 3), (8, 11, (2,), 3, 2, 3)]


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_kernel_schedule_matches_the_twin(case):
    lg_coef, log_order, lead, tile_log, block_log, launches = case
    rng = np.random.default_rng(35 + lg_coef)
    x = gf.tensor(_canon(rng, 2, *lead, 1 << lg_coef))
    rou = gf.root_of_unity_int(log_order)
    scale = tuple(int(v) for v in _canon(rng, 2))
    got, n = emulate_gf_fft(x, log_order, rou, scale, tile_log, block_log)
    assert n == launches
    if tile_log == fft.TILE_LOG:
        assert n == fft.launches(lg_coef)
    assert torch.equal(got, fft.fft_plain(x, log_order, rou, scale))


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
             lambda: virgo_pc.fold_step_plain(cw, w, r)]
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
        virgo_pc.fold_step_cuda(cw, w, r)
    meta = torch.empty((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fft.fft(meta, 2, gf.root_of_unity_int(2))


def test_cuda_tensors_reach_the_kernel_wrappers(monkeypatch):
    """The dispatch hands a CUDA tensor (here: any tensor, the device test
    patched) to fft_cuda with the IFFT's inverse root and 1/n, and to
    fold_step_cuda with fold_step's twiddles."""
    calls = []
    monkeypatch.setattr(gf, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fft, "fft_cuda", lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(virgo_pc, "fold_step_cuda",
                        lambda *a: calls.append(a) or a[0])
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
    inv_mu = chains.table_plain(chains.POWER, gf.inv_int(
        gf.root_of_unity_int(4)), None, 8, "cpu")
    assert calls[2][0] is cw and torch.equal(calls[2][1], inv_mu)
    assert calls[2][2] is r
