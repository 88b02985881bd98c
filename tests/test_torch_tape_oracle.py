"""The fft_gkr circuit (``pc/fft_gkr.py``: ``fg_build_circuit``) and the
public commit's virtual oracle (``pc/virgo_pc.py``: ``pc_virtual_oracle``)
on the CPU against the JAX package, and both kernels' schedules emulated on
the host.

On a CUDA tensor ``build_circuit`` is one ``fg_build_circuit`` launch up to
lg = ONE_LAUNCH_LOG (a warp a point up to WARP_LOG; ``circuit_launches(lg)``
above it) and the public commit's virtual
oracle and h codeword one ``pc_virtual_oracle`` launch; on a CPU tensor the
plain twins run (``build_circuit_plain``, ``virtual_oracle_plain``).  Here:

* ``build_circuit_plain`` == JAX ``build_circuit`` in every layer at lg =
  0, 1, 3 and 7, and its power table == Python-int powers of the points;
* the port's ``commit_public_eval`` (through ``virtual_oracle_plain``) ==
  JAX ``commit_public_eval`` in every output at bl = 7 and 9, with no batch
  axis and with a batch of 3 (each instance against JAX);
* a sharded rank's local form (its columns of l, q and h, its own
  ``oracle_tables``) == the whole codeword's columns, S = 2 and 4;
* ``emulate_build_circuit`` (on gf's plain ops: on canonical inputs the
  field values, as the kernel's field.cuh ops give) and
  ``emulate_virtual_oracle`` (on Python-int field elements), host copies
  of the kernels' schedules (the warp route's lane slots, exchanges,
  in-lane butterflies and lane-local powers; which block computes and
  writes which words, the trees' pairs, the multi-launch split, the
  grid-stride items), == the twins, every output word written exactly
  once: the circuit at lg 0-9 and either side of ONE_LAUNCH_LOG;
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


# csrc/fft_gkr.cu: a block's threads, the largest lg of the register
# route and its most warps a point (log2), the largest lg of one launch, a
# chunk's words (log2) and the most partial sums a point (log2) above it
(BUILD_THREADS, WARP_LOG, POINT_WARPS_LOG, ONE_LAUNCH_LOG, CHUNK_LOG,
 PARTS_LOG) = _source_constants("fft_gkr", "BUILD_THREADS", "WARP_LOG",
                                "POINT_WARPS_LOG", "ONE_LAUNCH_LOG",
                                "CHUNK_LOG", "PARTS_LOG")
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
    """The output buffer by element, (2, size) words, counting the writes
    of each element."""

    def __init__(self, size):
        self.val = torch.zeros((2, size), dtype=torch.int64)
        self.writes = torch.zeros(size, dtype=torch.int64)

    def put(self, idx, x):
        idx = torch.as_tensor(idx, dtype=torch.int64).reshape(-1)
        self.val[:, idx] = x.reshape(2, -1)
        self.writes.index_put_((idx,), torch.ones_like(idx), accumulate=True)


def _layout(lg):
    """csrc/fft_gkr.cu's element offsets: tensor_at, ifft_at, sums_at."""
    n = 1 << lg
    tensor_at = lambda layer: (1 << layer) - 1
    ifft_at = lambda d: 2 * n - 1 + d * n
    return tensor_at, ifft_at, ifft_at(lg + 1 + 64)


def _rev(t, k):
    """The low k bits of t (a tensor or an int) reversed."""
    y = t * 0
    for i in range(k):
        y = y | (((t >> i) & 1) << (k - 1 - i))
    return y


def _tree(xs):
    """The log tree over the last axis, pairs (2i, 2i + 1) a level."""
    while xs.shape[-1] > 1:
        xs = gf.add_plain(xs[..., 0::2], xs[..., 1::2])
    return xs[..., 0]


def emulate_build_circuit(lg, r, ep, xp, inv_n, one_launch_log=ONE_LAUNCH_LOG,
                          chunk_log=CHUNK_LOG, warp_log=WARP_LOG,
                          point_warps_log=POINT_WARPS_LOG):
    """fg_build_circuit's schedule on gf's plain ops (on canonical inputs
    the canonical field values, as field.cuh's ops give), every point, lane
    and thread side by side: the warp route (a warp a point: each lane's
    slots, its tensor chain, the ifft stages as exchanges between lanes
    and butterflies within one, the lane-local powers, the in-lane and
    shuffle sums) up to warp_log, the block route (a block a point, shared
    buffers, block 0 writing the layers) up to one_launch_log, else the
    tensor, stage, expand and sum launches.  inv_n: a Python-int pair.
    Returns (the output buffer, the launches)."""
    mul, add, sub = gf.mul_plain, gf.add_plain, gf.sub_plain
    n, P = 1 << lg, 64
    tensor_at, ifft_at, sums_at = _layout(lg)
    scale_at, expn_at, pw_at = ifft_at(lg), ifft_at(lg + 1), sums_at + P
    out = _Out(pw_at + P * n)
    rt, ept, tw = gf.tensor(r), gf.tensor(ep), gf.tensor(xp)
    one = gf.ones((1,), "cpu")
    inv = gf.full((1,), inv_n[0], inv_n[1], "cpu")
    ri = lambda i: rt[:, i:i + 1]
    b_idx = torch.arange(P)[:, None] * n

    def butterfly(src, d):
        """Every butterfly u < n/2 of ifft stage d on the layer src (2,
        n): (e + w o, e - w o)."""
        dep = lg - 1 - d
        u = torch.arange(n // 2)
        m, k = 1 << dep, u >> dep
        e_at = (k << (dep + 1)) + (u & (m - 1))
        t = mul(tw[:, n - (n >> dep) + k], src[:, e_at + m])
        return torch.cat([add(src[:, e_at], t), sub(src[:, e_at], t)], 1)

    if lg <= warp_log:
        wlog = 0 if lg <= 5 else min(lg - 5, point_warps_log)
        vlog = max(lg - 5 - wlog, 0)
        V, T, U = 1 << vlog, 32 << wlog, lg - vlog
        h = torch.arange(T)                    # the block's threads
        live = h < (1 << U)
        out.put(tensor_at(0), one)             # block 0's thread 0
        fa = [torch.where(((h >> (U - 1 - i)) & 1).bool(),
                          sub(one, ri(i)), ri(i)) for i in range(U)]
        pre = fa[:1]                           # the thread's prefixes
        if U > 1:
            pre.append(mul(fa[0], fa[1]))
        if U > 2:
            pre.append(mul(pre[1], fa[2]))
        if U > 3:
            pre.append(mul(pre[1], mul(fa[2], fa[3])))
        if U > 4:
            pre.append(mul(pre[3], fa[4]))
        if U > 5:
            pre.append(mul(pre[3], mul(fa[4], fa[5])))
        for i in range(6, U):
            pre.append(mul(pre[i - 1], fa[i]))
        for i, x in enumerate(pre):
            sh = U - 1 - i
            m = live & ((h & ((1 << sh) - 1)) == 0)
            out.put(tensor_at(i + 1) + (h[m] >> sh), x[:, m])
        x = pre[-1] if U else one.expand(2, T)
        xs = [x]
        for s_ in range(vlog):                 # the slots by doubling
            r1, r0 = sub(one, ri(U + s_)), ri(U + s_)
            xs = [mul(xs[e >> 1], r1 if e & 1 else r0)
                  for e in range(2 << s_)]
            for e, v in enumerate(xs):
                out.put(tensor_at(U + s_ + 1) + (h << (s_ + 1)) + e, v)
        X = torch.stack(xs, -1)                # (2, threads, V)
        slots = (h[:, None] << vlog) | torch.arange(V)[None, :]
        for s_ in range(lg):                   # stage s_ pairs bit p
            p = lg - 1 - s_
            kb = n - (n >> p)
            if p >= vlog:                      # a thread bit: an exchange
                hb = p - vlog                  # (a shuffle or, a warp bit,
                w = tw[:, kb + _rev(h >> (hb + 1), s_)][:, :, None]
                hi = ((h >> hb) & 1).bool()[:, None]   # shared memory)
                prod = mul(w, X)
                got = torch.where(hi, prod, X)[:, h ^ (1 << hb)]
                X = torch.where(hi, sub(got, prod), add(X, got))
            else:                              # a register bit
                X = X.clone()
                for e in range(V):
                    if e & (1 << p):
                        continue
                    k = _rev((h << (vlog - p - 1)) | (e >> (p + 1)), s_)
                    t = mul(tw[:, kb + k], X[..., e | (1 << p)])
                    X[..., e | (1 << p)] = sub(X[..., e], t)
                    X[..., e] = add(X[..., e], t)
            pos = (slots & ((1 << p) - 1)) | (_rev(slots >> p, s_ + 1) << p)
            out.put(ifft_at(s_) + pos[live], X[:, live])
        sq = [ept]
        for i in range(1, lg):
            sq.append(mul(sq[-1], sq[-1]))
        # slot e's entry j = bitrev_U(h) + bitrev_VLOG(e) 2^U: its power
        # in slot order, bit i of e a factor ep^(2^(U + VLOG - 1 - i))
        jl = _rev(h, U)
        pw = [one.expand(2, T)[:, None, :].expand(2, P, T)]
        for i in range(U):
            pw[0] = torch.where(((jl >> i) & 1).bool(),
                                mul(pw[0], sq[i][:, :, None]), pw[0])
        for i in range(vlog):
            pw += [mul(f, sq[U + vlog - 1 - i][:, :, None]) for f in pw]
        acc = torch.zeros((2, P, T), dtype=torch.int64)
        for e in range(V):
            j = jl + (_rev(e, vlog) << U)
            sc = mul(X[..., e], inv)
            v = mul(sc[:, None, :], pw[e])
            out.put(scale_at + j[live], sc[:, live])
            out.put(pw_at + b_idx + j[live], pw[e][:, :, live])
            out.put(expn_at + b_idx + j[live], v[:, :, live])
            acc = add(acc, torch.where(live, v, 0))
        lane = h & 31                          # five shuffles, then the
        for o in (16, 8, 4, 2, 1):             # warps' sums
            acc = add(acc, acc[:, :, (h - lane) + (lane ^ o)])
        tot = acc[:, :, 0]
        for w_ in range(1, T // 32):
            tot = add(tot, acc[:, :, 32 * w_])
        out.put(sums_at + torch.arange(P), tot)
        return out, 1
    if lg <= one_launch_log:
        out.put(tensor_at(0), one)             # block 0
        cur, pw, sq = one, one.expand(2, P)[:, :, None], ept
        for i in range(lg):
            cur = torch.stack([mul(cur, ri(i)), mul(cur, sub(one, ri(i)))],
                              -1).reshape(2, -1)
            out.put(tensor_at(i + 1) + torch.arange(2 << i), cur)
            pw = torch.cat([pw, mul(pw, sq[:, :, None])], -1)
            sq = mul(sq, sq)
        for d in range(lg):
            cur = butterfly(cur, d)
            out.put(ifft_at(d) + torch.arange(n), cur)
        sc = mul(cur, inv)
        out.put(scale_at + torch.arange(n), sc)
        out.put(pw_at + b_idx + torch.arange(n), pw)
        v = mul(sc[:, None, :], pw)
        out.put(expn_at + b_idx + torch.arange(n), v)
        out.put(sums_at + torch.arange(P), _tree(v))
        return out, 1
    # tensor layers: element j of the last runs its chain
    j = torch.arange(n)
    out.put(tensor_at(0), one)
    v = one.expand(2, n)
    for i in range(lg):
        low = lg - 1 - i
        idx = j >> low
        v = mul(v, torch.where((idx & 1).bool(), sub(one, ri(i)), ri(i)))
        m = (j & ((1 << low) - 1)) == 0
        out.put(tensor_at(i + 1) + idx[m], v[:, m])
    launches = 1
    src = out.val[:, tensor_at(lg):tensor_at(lg) + n]
    for d in range(lg):                        # a launch a stage
        launches += 1
        src = butterfly(src, d)
        out.put(ifft_at(d) + torch.arange(n), src)
    # expansion: block (c, b) a chunk of a point, to a partial sum
    launches += 1
    ch, chunks = 1 << chunk_log, n >> chunk_log
    sq = ept[:, :, None, None]
    pw = one.reshape(2, 1, 1, 1).expand(2, P, chunks, 1)
    for i in range(chunk_log):
        pw = torch.cat([pw, mul(pw, sq)], -1)
        sq = mul(sq, sq)
    c = torch.arange(chunks)[:, None]
    for i in range(chunk_log, lg):             # the chunk's high bits
        pw = torch.where(((c >> (i - chunk_log)) & 1).bool(), mul(pw, sq),
                         pw)
        sq = mul(sq, sq)
    jj = (c * ch + torch.arange(ch)).reshape(-1)
    pw = pw.reshape(2, P, n)
    out.put(pw_at + b_idx + jj, pw)
    sc = mul(src[:, jj], inv)
    out.put(scale_at + jj, sc)                 # point 0's blocks
    v = mul(sc[:, None, :], pw)
    out.put(expn_at + b_idx + jj, v)
    parts = _tree(v.reshape(2, P, chunks, ch))
    # the partial sums' tree, a block a point
    launches += 1
    assert chunks <= 1 << PARTS_LOG
    out.put(sums_at + torch.arange(P), _tree(parts))
    return out, launches


# (lg, one_launch_log, chunk_log, warp_log, point_warps_log): lg 0-9 (the
# register route to WARP_LOG: a slot a thread up to 2^(5 +
# POINT_WARPS_LOG) slots, then 2 a thread; the block route above), one
# warp a point and 2^4 warps at lg 7 and 9, the block route either side
# of ONE_LAUNCH_LOG and the multi-launch route above it; at small forced
# constants the block route at lg 0, 3 and 6 and the multi-launch route
# at lg 5 and 6
P_W = POINT_WARPS_LOG
BUILD_EMULATED = (
    [(lg, ONE_LAUNCH_LOG, CHUNK_LOG, WARP_LOG, P_W) for lg in range(10)]
    + [(lg, ONE_LAUNCH_LOG, CHUNK_LOG, 9, w) for lg in (7, 9)
       for w in (0, 4)]
    + [(lg, ONE_LAUNCH_LOG, CHUNK_LOG, WARP_LOG, P_W)
       for lg in (ONE_LAUNCH_LOG - 1, ONE_LAUNCH_LOG, ONE_LAUNCH_LOG + 1)]
    + [(0, ONE_LAUNCH_LOG, CHUNK_LOG, -1, P_W),
       (3, ONE_LAUNCH_LOG, CHUNK_LOG, 2, P_W),
       (6, ONE_LAUNCH_LOG, CHUNK_LOG, 5, P_W), (5, 3, 2, 2, P_W),
       (6, 4, 3, 3, P_W)])


@pytest.mark.parametrize("lg,one_launch_log,chunk_log,warp_log,warps",
                         BUILD_EMULATED)
def test_build_circuit_schedule_emulation(lg, one_launch_log, chunk_log,
                                          warp_log, warps):
    """The emulated kernel == the twin on canonical inputs in every layer
    and the power table, each word written once; its launches == the rule
    (``circuit_launches`` for the source's constants, small constants to
    reach the block and multi-launch routes at small lg)."""
    r, ep = _build_inputs(lg)
    layers, pw = fft_gkr.build_circuit_plain(lg, gf.tensor(r),
                                             gf.tensor(ep))
    n = 1 << lg
    inv_n = gf.pow_int((n % M, 0), M - 2)
    xp = gf.to_numpy(fft_gkr.stage_powers(lg, "cpu"))
    out, launches = emulate_build_circuit(lg, r, ep, xp, inv_n,
                                          one_launch_log, chunk_log, warp_log,
                                          warps)
    assert launches == (1 if lg <= one_launch_log else lg + 3)
    if (one_launch_log, warp_log) == (ONE_LAUNCH_LOG, WARP_LOG):
        assert launches == fft_gkr.circuit_launches(lg)
    assert torch.equal(out.writes, torch.ones_like(out.writes))
    want = torch.cat([t.reshape(2, -1) for t in layers + [pw]], 1)
    assert torch.equal(out.val, want)


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
    assert (fft_gkr.WARP_LOG, fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG) == (
        WARP_LOG, ONE_LAUNCH_LOG, CHUNK_LOG)
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
