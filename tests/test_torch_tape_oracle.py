"""The fft_gkr circuit (``pc/fft_gkr.py``: ``fg_build_circuit``) and the
public commit's virtual oracle (``pc/virgo_pc.py``: ``pc_virtual_oracle``)
on the CPU against the JAX package, and both kernels' schedules emulated on
the host.

On a CUDA tensor ``build_circuit`` is one ``fg_build_circuit`` launch up to
lg = 12 (``circuit_launches(lg)`` above it) and the public commit's virtual
oracle and h codeword one ``pc_virtual_oracle`` launch; on a CPU tensor the
plain twins run (``build_circuit_plain``, ``virtual_oracle_plain``).  Here:

* ``build_circuit_plain`` == JAX ``build_circuit`` in every layer at lg =
  0, 1, 3 and 7, and its power table == Python-int powers of the points;
* the port's ``commit_public_eval`` (through ``virtual_oracle_plain``) ==
  JAX ``commit_public_eval`` in every output at bl = 7 and 9, with no batch
  axis and with a batch of 3 (each instance against JAX);
* a sharded rank's local form (its columns of l, q and h, its own
  ``oracle_tables``) == the whole codeword's columns, S = 2 and 4;
* ``emulate_build_circuit`` and ``emulate_virtual_oracle``, host copies of
  the kernels' schedules on Python-int field elements (which block
  computes and writes which words, the trees' pairs, the multi-launch
  split, the grid-stride items), == the twins, every output word written
  exactly once;
* a CPU call counts ``kernels.PLAIN_CALLS`` and launches nothing; the CUDA
  wrappers refuse CPU tensors; ``circuit_launches`` and the Python
  constants match ``csrc/fft_gkr.cu``.

Inputs are canonical, from numpy with a seed; field arithmetic is exact, so
the tolerance is 0.  The JAX references run in spawned processes (module
fixture, tests/torch_tape_oracle_refs.py).  The kernels run only on a card: chip_smoke.py holds them
against the twins there."""

import multiprocessing as mp
import re
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from torch_tape_oracle_refs import (BATCH, build_inputs as _build_inputs,
                                    canon as _canon, jax_jobs,
                                    oracle_inputs as _oracle_inputs)
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.field.ref import Fq2
from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
BUILD_LGS = (0, 1, 3, 7)
ORACLE_BLS = (7, 9)


def _source_constants(name, *consts):
    """constexpr int constants of csrc/<name>.cu, a number or a product."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    return [int(np.prod([int(f) for f in re.search(
        rf"constexpr int {c} = ([\d *]+);", src).group(1).split("*")]))
        for c in consts]


# csrc/fft_gkr.cu: a block's threads, the largest lg of one launch, a
# chunk's words (log2) and the most partial sums a point (log2) above it
BUILD_THREADS, ONE_LAUNCH_LOG, CHUNK_LOG, PARTS_LOG = _source_constants(
    "fft_gkr", "BUILD_THREADS", "ONE_LAUNCH_LOG", "CHUNK_LOG", "PARTS_LOG")
# csrc/virgo_pc.cu: a block's threads, the grid's most blocks
VO_THREADS, VO_MAX_BLOCKS = _source_constants("virgo_pc", "THREADS",
                                              "MAX_BLOCKS")


@pytest.fixture(scope="module")
def refs():
    """{("build", lg): JAX layers, ("oracle", bl): [JAX outputs a
    instance]}: three groups of about equal time, the first in this
    process and the others in two spawned processes meanwhile
    (tests/torch_tape_oracle_refs.py)."""
    here, *groups = [[("oracle", 9), ("build", (0, 1))],
                     [("oracle", 7), ("build", (3,))], [("build", (7,))]]
    with ProcessPoolExecutor(len(groups),
                             mp_context=mp.get_context("spawn")) as pool:
        futures = [pool.submit(jax_jobs, jobs) for jobs in groups]
        done = jax_jobs(here)
        for f in futures:
            done.update(f.result())
    assert set(done) == {("build", lg) for lg in BUILD_LGS} | {
        ("oracle", bl) for bl in ORACLE_BLS}
    return done


def _eq(t, ref):
    return np.array_equal(gf.to_numpy(t), np.asarray(ref))


def _els(t):
    """A (2, ...) tensor -> its elements as Fq2, in row-major order."""
    a = gf.to_numpy(t).reshape(2, -1)
    return [Fq2.raw(int(x), int(y)) for x, y in zip(a[0], a[1])]


def _fq(a, i):
    return Fq2.raw(int(a[0, i]), int(a[1, i]))


# ---------------------------------------------------------------------------
# the twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lg", BUILD_LGS)
def test_build_circuit_twin_matches_jax(refs, lg):
    r, ep = _build_inputs(lg)
    kernels.reset_counts()
    layers, pw = fft_gkr.build_circuit(lg, gf.tensor(r), gf.tensor(ep))
    assert kernels.PLAIN_CALLS["fg_build_circuit"] == 1
    assert not any(kernels.LAUNCHES.values())
    want = refs[("build", lg)]
    assert len(layers) == len(want) == len(fft_gkr.circuit_sizes(lg))
    for k, (got, w) in enumerate(zip(layers, want)):
        assert got.shape == (2, fft_gkr.circuit_sizes(lg)[k]), k
        assert _eq(got, w), k
    n = 1 << lg
    assert pw.shape == (2, 64, n)
    p = gf.to_numpy(pw)
    for b in range(64):
        x, cur = _fq(ep, b), Fq2.raw(1, 0)
        for j in range(n):
            assert _fq(p[:, b], j) == cur, (b, j)
            cur = cur * x


@pytest.mark.parametrize("bl", ORACLE_BLS)
def test_virtual_oracle_twin_matches_jax(refs, bl):
    l_eval, q = _oracle_inputs(bl)
    want = refs[("oracle", bl)]
    kernels.reset_counts()
    batch = virgo_pc.commit_public_eval(gf.tensor(l_eval), gf.tensor(q), bl)
    single = virgo_pc.commit_public_eval(gf.tensor(l_eval[:, 0]),
                                         gf.tensor(q), bl)
    assert kernels.PLAIN_CALLS["pc_virtual_oracle"] == 2
    assert not any(kernels.LAUNCHES.values())
    h_full, _q_eval, _q_coefs, all_sum, vo = batch
    for b in range(BATCH):
        assert _eq(vo[:, b], want[b][4]), b
        assert _eq(h_full[:, b], want[b][0]), b
        assert _eq(all_sum[:, b], want[b][3]), b
    for got, w in zip(single, want[0]):
        assert _eq(got, w)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_rank_oracle_matches_whole_columns(shards):
    lg_ss, srec = 6, 4
    L = 1 << lg_ss
    rng = np.random.default_rng(300 + shards)
    l_eval, q_eval, h_eval, c0 = (gf.tensor(_canon(rng, *s)) for s in
                                  ((65, L), (65, L), (64, L), (64,)))
    xn1, inv_x = virgo_pc.oracle_tables(lg_ss, srec, L, "cpu")
    rou = Fq2.raw(*gf.root_of_unity_int(lg_ss))
    for p in (0, 1, L - 1):
        x = rou.pow(p)
        assert _fq(gf.to_numpy(xn1), p) == x.pow(srec) - Fq2.raw(1, 0)
        assert _fq(gf.to_numpy(inv_x), p) * x == Fq2.raw(1, 0)
    vo, h_full = virgo_pc.virtual_oracle(l_eval, q_eval, h_eval, c0, srec,
                                         xn1, inv_x)
    for rank in range(shards):
        cols = slice(rank, None, shards)
        t_xn1, t_inv = virgo_pc.oracle_tables(lg_ss, srec, L // shards,
                                              "cpu", shards, rank)
        assert torch.equal(t_xn1, xn1[:, cols])
        assert torch.equal(t_inv, inv_x[:, cols])
        got = virgo_pc.virtual_oracle(
            l_eval[..., cols].contiguous(),
            q_eval[:, :64, cols].contiguous(),
            h_eval[..., cols].contiguous(), c0, srec, t_xn1, t_inv)
        assert torch.equal(got[0], vo[..., cols])
        assert torch.equal(got[1], h_full[..., cols])


# ---------------------------------------------------------------------------
# the kernels' schedules, emulated on the host
# ---------------------------------------------------------------------------

class _Out:
    """The output buffer by element (both planes at once), counting the
    writes of each element."""

    def __init__(self, size):
        self.val = [None] * size
        self.writes = [0] * size

    def put(self, i, x):
        self.val[i] = x
        self.writes[i] += 1


def _layout(lg):
    """csrc/fft_gkr.cu's element offsets: tensor_at, ifft_at, sums_at."""
    n = 1 << lg
    tensor_at = lambda layer: (1 << layer) - 1
    ifft_at = lambda d: 2 * n - 1 + d * n
    return tensor_at, ifft_at, ifft_at(lg + 1 + 64)


def emulate_build_circuit(lg, r, ep, xp, inv_n, one_launch_log=ONE_LAUNCH_LOG,
                          chunk_log=CHUNK_LOG):
    """fg_build_circuit's schedule on Python-int elements: the one-launch
    route (a block a point, shared buffers, block 0 writing the layers) up
    to one_launch_log, else the tensor, stage, expand and sum launches.
    Returns (the output buffer, the launches)."""
    n = 1 << lg
    one = Fq2.raw(1, 0)
    tensor_at, ifft_at, sums_at = _layout(lg)
    scale_at, expn_at, pw_at = ifft_at(lg), ifft_at(lg + 1), sums_at + 64
    out = _Out(pw_at + 64 * n)
    ri = [_fq(r, i) for i in range(lg)]
    tw = lambda dep, k: _fq(xp, n - (n >> dep) + k)

    def butterfly(src, d, u):
        dep = lg - 1 - d
        m, k = 1 << dep, u >> dep
        e_at = (k << (dep + 1)) + (u & (m - 1))
        t = tw(dep, k) * src[e_at + m]
        return src[e_at] + t, src[e_at] - t

    def tree(xs):
        """The log tree, pairs (2i, 2i + 1) a level (a barrier a level)."""
        while len(xs) > 1:
            xs = [xs[2 * i] + xs[2 * i + 1] for i in range(len(xs) // 2)]
        return xs[0]

    if lg <= one_launch_log:
        for b in range(64):
            writer = b == 0
            cur, pw = [one], [one] + [None] * (n - 1)
            if writer:
                out.put(tensor_at(0), one)
            sq = _fq(ep, b)
            for i in range(lg):
                width, nxt = 1 << i, [None] * (2 << i)
                for j in range(width):      # a thread each, BUILD_THREADS
                    hi, lo = cur[j] * ri[i], cur[j] * (one - ri[i])
                    nxt[2 * j], nxt[2 * j + 1] = hi, lo
                    if writer:
                        out.put(tensor_at(i + 1) + 2 * j, hi)
                        out.put(tensor_at(i + 1) + 2 * j + 1, lo)
                    pw[width + j] = pw[j] * sq
                sq = sq * sq
                cur = nxt
            for d in range(lg):
                nxt = [None] * n
                for u in range(n // 2):
                    nxt[u], nxt[n // 2 + u] = butterfly(cur, d, u)
                    if writer:
                        out.put(ifft_at(d) + u, nxt[u])
                        out.put(ifft_at(d) + n // 2 + u, nxt[n // 2 + u])
                cur = nxt
            xs = []
            for j in range(n):
                s = cur[j] * inv_n
                if writer:
                    out.put(scale_at + j, s)
                out.put(pw_at + b * n + j, pw[j])
                xs.append(s * pw[j])
                out.put(expn_at + b * n + j, xs[-1])
            out.put(sums_at + b, tree(xs))
        return out, 1
    # tensor layers: element j of the last runs its chain
    launches = 1
    for j in range(n):
        if j == 0:
            out.put(tensor_at(0), one)
        v = one
        for i in range(lg):
            low = lg - 1 - i
            idx = j >> low
            v = v * ((one - ri[i]) if idx & 1 else ri[i])
            if j & ((1 << low) - 1) == 0:
                out.put(tensor_at(i + 1) + idx, v)
    # one launch an ifft stage, through the buffer
    src = out.val[tensor_at(lg):tensor_at(lg) + n]
    for d in range(lg):
        launches += 1
        for u in range(n // 2):
            s, df = butterfly(src, d, u)
            out.put(ifft_at(d) + u, s)
            out.put(ifft_at(d) + n // 2 + u, df)
        src = out.val[ifft_at(d):ifft_at(d) + n]
    # expansion: block (c, b) a chunk of a point, to a partial sum
    launches += 1
    ch = 1 << chunk_log
    chunks = n >> chunk_log
    parts = [[None] * chunks for _ in range(64)]
    for b in range(64):
        for c in range(chunks):
            pw, sq = [one] + [None] * (ch - 1), _fq(ep, b)
            for i in range(chunk_log):
                for j in range(1 << i):
                    pw[(1 << i) + j] = pw[j] * sq
                sq = sq * sq
            for i in range(chunk_log, lg):     # the chunk's high bits
                if (c >> (i - chunk_log)) & 1:
                    pw = [p * sq for p in pw]
                sq = sq * sq
            xs = []
            for l in range(ch):
                j = c * ch + l
                out.put(pw_at + b * n + j, pw[l])
                s = src[j] * inv_n
                if b == 0:
                    out.put(scale_at + j, s)
                xs.append(s * pw[l])
                out.put(expn_at + b * n + j, xs[-1])
            parts[b][c] = tree(xs)
    # the partial sums' tree, a block a point
    launches += 1
    assert chunks <= 1 << PARTS_LOG
    for b in range(64):
        out.put(sums_at + b, tree(parts[b]))
    return out, launches


@pytest.mark.parametrize("lg,one_launch_log,chunk_log", [
    (0, ONE_LAUNCH_LOG, CHUNK_LOG), (3, ONE_LAUNCH_LOG, CHUNK_LOG),
    (6, ONE_LAUNCH_LOG, CHUNK_LOG), (5, 3, 2), (6, 4, 3)])
def test_build_circuit_schedule_emulation(lg, one_launch_log, chunk_log):
    """The emulated kernel == the twin in every layer and the power table,
    each word written once; its launches == the rule (``circuit_launches``
    for the source's constants, small constants to reach the multi-launch
    route at small lg)."""
    r, ep = _build_inputs(lg)
    layers, pw = fft_gkr.build_circuit_plain(lg, gf.tensor(r),
                                             gf.tensor(ep))
    n = 1 << lg
    inv_n = Fq2.raw(*gf.pow_int((n % M, 0), M - 2))
    xp = gf.to_numpy(fft_gkr.stage_powers(lg, "cpu"))
    out, launches = emulate_build_circuit(lg, r, ep, xp, inv_n,
                                          one_launch_log, chunk_log)
    assert launches == (1 if lg <= one_launch_log else lg + 3)
    if one_launch_log == ONE_LAUNCH_LOG:
        assert launches == fft_gkr.circuit_launches(lg)
    assert out.writes == [1] * len(out.writes)
    want = [x for t in layers + [pw] for x in _els(t)]
    assert out.val == want


def emulate_virtual_oracle(lead, cols, l_eval, q_eval, h_eval, c0, srec,
                           xn1, inv_x):
    """pc_virtual_oracle's grid-stride loop on Python-int elements: item i
    of the (2, *lead, 65, cols) outputs, its instance, slice and column
    from i, the mask slice written as zeros.  Returns (vo, h_full) as
    element lists and each item's writes."""
    items = int(np.prod(lead, dtype=np.int64)) * 65 * cols
    blocks = min(-(-items // VO_THREADS), VO_MAX_BLOCKS)
    lg_len = cols.bit_length() - 1
    l, q, h = (gf.to_numpy(t).reshape(2, -1) for t in (l_eval, q_eval,
                                                       h_eval))
    c, t1, t2 = (gf.to_numpy(t).reshape(2, -1) for t in (c0, xn1, inv_x))
    vo, hf, writes = [None] * items, [None] * items, [0] * items
    srec_el, zero = Fq2.raw(srec % M, 0), Fq2.raw(0, 0)
    for thread in range(blocks * VO_THREADS):
        for i in range(thread, items, blocks * VO_THREADS):
            j, row = i & (cols - 1), i >> lg_len
            inst, s = divmod(row, 65)
            writes[i] += 1
            if s == 64:
                vo[i] = hf[i] = zero
                continue
            hrow = inst * 64 + s
            hv = _fq(h, (hrow << lg_len) + j)
            g = _fq(l, i) * _fq(q, (s << lg_len) + j) - _fq(t1, j) * hv
            vo[i] = (g - _fq(c, hrow)) * srec_el * _fq(t2, j)
            hf[i] = hv
    return vo, hf, writes


@pytest.mark.parametrize("lead,cols,q_slices", [((), 8, 65), ((2,), 4, 64),
                                                ((2, 3), 2, 65)])
def test_virtual_oracle_schedule_emulation(lead, cols, q_slices):
    rng = np.random.default_rng(400 + cols)
    l_eval, h_eval, c0 = (gf.tensor(_canon(rng, *lead, *s)) for s in
                          ((65, cols), (64, cols), (64,)))
    q_eval, xn1, inv_x = (gf.tensor(_canon(rng, *s)) for s in
                          ((q_slices, cols), (cols,), (cols,)))
    want = virgo_pc.virtual_oracle_plain(l_eval, q_eval, h_eval, c0, 32, xn1,
                                         inv_x)
    vo, hf, writes = emulate_virtual_oracle(lead, cols, l_eval, q_eval,
                                            h_eval, c0, 32, xn1, inv_x)
    assert writes == [1] * len(writes)
    assert vo == _els(want[0]) and hf == _els(want[1])
    assert want[0].shape == want[1].shape == (2, *lead, 65, cols)


# ---------------------------------------------------------------------------
# counts, refusals and constants
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    r, ep = (gf.tensor(x) for x in _build_inputs(3))
    with pytest.raises(ValueError):
        fft_gkr.build_circuit_cuda(3, r, ep)
    with pytest.raises(ValueError):
        fft_gkr.build_circuit_cuda(fft_gkr.MAX_BUILD_LOG + 1, r, ep)
    rng = np.random.default_rng(7)
    args = [gf.tensor(_canon(rng, *s)) for s in
            ((65, 8), (65, 8), (64, 8), (64,), (8,), (8,))]
    with pytest.raises(ValueError):
        virgo_pc.virtual_oracle_cuda(*args[:4], 2, *args[4:])


def test_circuit_constants_match_the_source():
    assert (fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG) == (ONE_LAUNCH_LOG,
                                                           CHUNK_LOG)
    assert fft_gkr.MAX_BUILD_LOG == CHUNK_LOG + PARTS_LOG
    assert [fft_gkr.circuit_launches(lg) for lg in range(22)] == [
        1 if lg <= ONE_LAUNCH_LOG else lg + 3 for lg in range(22)]
    for lg in (0, 5):
        n = 1 << lg
        sizes = fft_gkr.circuit_sizes(lg)
        tensor_at, ifft_at, sums_at = _layout(lg)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        assert list(offs[:lg + 1]) == [tensor_at(k) for k in range(lg + 1)]
        assert list(offs[lg + 1:2 * lg + 3]) == [ifft_at(d)
                                                for d in range(lg + 2)]
        assert offs[-2] == sums_at and sizes[-2:] == [64 * n, 64]
