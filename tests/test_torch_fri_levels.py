"""Every FRI fold level in one call (``pc/virgo_pc.py``: ``fold_levels``,
``gf_fri_fold``) on the CPU against the JAX package, and the kernel's
schedule emulated on the host.

On a CUDA tensor ``fold_levels`` is ``virgo_pc.fold_launches(L)``
launches of ``csrc/gf_fft.cu``'s ``gf_fri_fold`` (one up to
LAUNCH_LEVELS levels) off ``fft.twiddles``' table of the inverse root of
the top order; on a CPU tensor it runs the plain twin
``fold_levels_plain`` (the JAX package's loop, a plain power table a
level).  Here:

* ``fold_levels`` == JAX ``fold_codewords`` at (2, 65, 256) with 3 levels,
  and each instance of a lead batch (2, 3, 65, 64) == JAX ``fold_step``
  level by level; ``fold_codewords`` and ``fold_step`` are its calls;
* ``emulate_gf_fri_fold``, a host copy of the kernel's schedule (the
  launch split, the tile rule with the constants read from the source,
  the persistent grid's tiles, each tile's closed column set loaded
  once, its columns' twiddle products w_k[i]·r_k (entry i·S + q of stage
  k of the top table) made once a block, every level folded in place, the
  halving, every word of every level written once) ==
  the per-level plain folds at S = 1, 2, 4 (every q) and L = 1..7, at the
  main path's (2, 65, 4096), at forced small tiles and grids, and on the
  multi-launch route;
* the strided-table identity: stage k of the top table == entry 2^k i of
  its stage 0 == level k's own power table, for lg up to 12;
* a rank's ``fold_levels`` at (S, q) == its loop of
  ``pc_sharded.sharded_fold_step`` == the whole codeword's levels at its
  columns, S = 2 and 4;
* the twin calls only the plain ops and counts one plain call, and the
  CUDA wrapper refuses CPU tensors.

Inputs are canonical, from numpy with a seed; field arithmetic is exact,
so the tolerance is 0 everywhere.  The kernel runs only on a card:
chip_smoke.py holds it against the twin there."""

import math
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virgo_plus_tpu.pc import virgo_pc as jvpc
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import chains, gf
from virgo_plus_tpu_torch.parallel import pc_sharded
from virgo_plus_tpu_torch.pc import fft, virgo_pc

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
INV2 = (M + 1) // 2


def _source_constants(*names):
    """constexpr int constants of csrc/gf_fft.cu, a number or a product."""
    src = (kernels.CSRC / "gf_fft.cu").read_text()
    return [math.prod(int(f) for f in re.search(
        rf"constexpr int {n} = ([\d *]+);", src).group(1).split("*"))
        for n in names]


# csrc/gf_fft.cu: entries a tile (log2), most levels a launch, least
# columns a tile (log2), the tiles below which a tile takes fewer columns,
# the persistent grid's most blocks
FOLD_TILE_LOG, LAUNCH_LEVELS, MIN_COLS_LOG, FOLD_SMS, FOLD_BLOCKS = \
    _source_constants("FOLD_TILE_LOG", "LAUNCH_LEVELS", "MIN_COLS_LOG",
                      "FOLD_SMS", "FOLD_BLOCKS")


def _canon(rng, *shape):
    return rng.integers(0, M, size=shape, dtype=np.uint64)


def _rs(rng, levels):
    return [gf.tensor(_canon(rng, 2)) for _ in range(levels)]


@pytest.fixture(scope="module")
def refs():
    """JAX fold_codewords of a (2, 65, 256) codeword at bl = 9 (3 levels),
    and JAX fold_step level by level of each instance of a (2, 3, 65, 64)
    batch (lg 6, 5, 4)."""
    rng = np.random.default_rng(61)
    cw, rs = _canon(rng, 2, 65, 256), _canon(rng, 3, 2)
    whole = jax.jit(lambda c, r: jvpc.fold_codewords(c, 9, list(r)))(
        jnp.asarray(cw), jnp.asarray(rs))
    batch, brs = _canon(rng, 2, 3, 65, 64), _canon(rng, 3, 2)

    def chain(c, r):
        out = []
        for k in range(3):
            c = jvpc.fold_step(c, r[k], 6 - k)
            out.append(c)
        return out

    per = jax.jit(jax.vmap(chain, in_axes=(1, None), out_axes=1))(
        jnp.asarray(batch), jnp.asarray(brs))
    return dict(whole=(cw, rs, [np.asarray(x) for x in whole]),
                batch=(batch, brs, [np.asarray(x) for x in per]))


def test_fold_levels_match_jax_fold_codewords(refs):
    cw, rs, want = refs["whole"]
    t_rs = [gf.tensor(r) for r in rs]
    got = virgo_pc.fold_levels(gf.tensor(cw), t_rs, 8)
    assert [gf.to_numpy(g).tolist() for g in got] == [w.tolist()
                                                      for w in want]
    got = virgo_pc.fold_codewords(gf.tensor(cw), 9, t_rs)
    assert all(np.array_equal(gf.to_numpy(g), w) for g, w in zip(got, want))


def test_fold_levels_batch_match_jax_per_instance(refs):
    batch, rs, want = refs["batch"]
    t_rs = [gf.tensor(r) for r in rs]
    got = virgo_pc.fold_levels(gf.tensor(batch), t_rs, 6)
    assert [g.shape for g in got] == [(2, 3, 65, 32 >> k) for k in range(3)]
    assert all(np.array_equal(gf.to_numpy(g), w) for g, w in zip(got, want))
    # fold_step is the one-level case
    one = virgo_pc.fold_step(gf.tensor(batch), t_rs[0], 6)
    assert np.array_equal(gf.to_numpy(one), want[0])


# ---------------------------------------------------------------------------
# gf_fri_fold's schedule on the host
# ---------------------------------------------------------------------------

def _halve(x):
    """x / 2 mod p of canonical words: the kernel's halving."""
    return (x >> 1) + (x & 1) * INV2


def emulate_gf_fri_fold(cw, rs, lg, shards=(1, 0), tile_log=FOLD_TILE_LOG,
                        launch_levels=LAUNCH_LEVELS, sms=FOLD_SMS,
                        blocks=FOLD_BLOCKS):
    """vpt_gf_fri_fold and gf_fri_fold with every tile side by side: the
    same launch split, tile rule (columns a tile, tiles, the persistent
    grid's tiles a block, a multiple of the tiles a row where it can be),
    loads of each tile's closed column set, the twiddle products w_k[i]
    r_k of its columns (stage k of the top table at entry i·S + q, level
    k's item it at E - E/2^k + it), levels folded in place in the tile's
    buffer, one product an element, the halving, and the stores into one
    buffer.  Asserts that the grid takes every tile once (each block's at
    one column set where the grid allows), that the products fill their
    part of the buffer once, and that every word of every level is
    written once.  Returns (the levels, the launches, each
    launch's (levels, columns a tile (log2), tiles, blocks))."""
    S, q = shards
    lead = tuple(cw.shape[1:-1])
    R, n = math.prod(lead), cw.shape[-1]
    n_log, L = n.bit_length() - 1, len(rs)
    tw = fft.stage_tables(chains.table_plain(
        chains.POWER, gf.inv_int(gf.root_of_unity_int(lg)), None,
        1 << (lg - 1), "cpu"))
    out = torch.zeros(2 * R * (n - (n >> L)), dtype=torch.int64)
    writes = torch.zeros_like(out)
    src = cw.reshape(2, R, n)
    launches = -(-L // launch_levels)
    first, base, shapes = 0, 0, []
    for li in range(launches):
        lc = L // launches + (li < L % launches)
        free_log = n_log - lc
        c_log = min(free_log, tile_log - lc)
        while c_log > MIN_COLS_LOG and R << (free_log - c_log) < sms:
            c_log -= 1
        tiles = R << (free_log - c_log)
        per_row = 1 << (free_log - c_log)
        cap = blocks - blocks % per_row if blocks >= per_row else blocks
        grid = min(tiles, cap)
        taken = sorted(t for b in range(grid) for t in range(b, tiles, grid))
        assert taken == list(range(tiles))
        shapes.append((lc, c_log, tiles, grid))
        t = torch.arange(tiles)
        row, j0 = t // per_row, (t % per_row) << c_log
        if grid % per_row == 0:           # a block keeps its columns
            assert all(len({int(j0[t_]) for t_ in range(b, tiles, grid)})
                       == 1 for b in range(grid))
        cmask, cols = (1 << c_log) - 1, 1 << free_log
        E = 1 << (c_log + lc)
        e = torch.arange(E)
        buf = src[:, row[:, None], j0[:, None] + (e & cmask)
                  + (e >> c_log) * cols]              # (2, tiles, E)
        # the block's twiddle products w_k[i]·r_k (entry i·S + q of stage
        # k of the top table): level k's item it at E - E/2^k + it
        wr = torch.zeros((2, tiles, E), dtype=torch.int64)
        filled = torch.zeros(E, dtype=torch.int64)
        for k in range(lc):
            it = torch.arange(E >> (k + 1))
            i = j0[:, None] + (it & cmask) + (it >> c_log) * cols
            stage = (1 << lg) - ((1 << lg) >> (first + k))
            wr[:, :, E - (E >> k) + it] = gf.mul_plain(
                tw[stage + i * S + q].movedim(-1, 0),
                rs[first + k][:, None, None])
            filled[E - (E >> k) + it] += 1
        assert torch.equal(filled, (e < E - (1 << c_log)).long())
        for k in range(lc):
            items = E >> (k + 1)
            it = torch.arange(items)
            a, b = buf[:, :, :items], buf[:, :, items:2 * items]
            i = j0[:, None] + (it & cmask) + (it >> c_log) * cols
            d = gf.mul_plain(gf.sub_plain(a, b), wr[:, :, E - (E >> k) + it])
            v = _halve(gf.add_plain(gf.add_plain(a, b), d))
            n_out = n >> (k + 1)
            at = base + 2 * R * (n - (n >> k)) + row[:, None] * n_out + i
            for p in range(2):
                out[at + p * R * n_out] = v[p]
                writes[at + p * R * n_out] += 1
            buf = buf.clone()
            buf[:, :, :items] = v
        last = n >> lc
        src = out[base + 2 * R * (n - 2 * last):
                  base + 2 * R * (n - last)].view(2, R, last)
        base += 2 * R * (n - last)
        first += lc
        n, n_log = last, n_log - lc
    assert torch.equal(writes, torch.ones_like(writes))
    levels, n = [], cw.shape[-1]
    for k in range(L):
        off, half = 2 * R * (n - (n >> k)), n >> (k + 1)
        levels.append(out[off:off + 2 * R * half].view((2,) + lead
                                                       + (half,)))
    return levels, launches, shapes


# (S, L): every q of S; a 2^9-entry top codeword over three rows, S = 4
# down to 2^7 entries a rank, so 7 levels leave one column set a tile
EMULATED = [(S, L) for S in (1, 2, 4) for L in range(1, 8)]


@pytest.mark.parametrize("S,L", EMULATED, ids=str)
def test_kernel_schedule_matches_the_plain_levels(S, L):
    rng = np.random.default_rng(70 + 8 * S + L)
    lg = 9
    for q in range(S):
        cw = gf.tensor(_canon(rng, 2, 3, 1 << lg) if S == 1
                       else _canon(rng, 2, 3, (1 << lg) // S))
        rs = _rs(rng, L)
        got, launches, shapes = emulate_gf_fri_fold(cw, rs, lg, (S, q))
        assert launches == virgo_pc.fold_launches(L) == 1
        want = virgo_pc.fold_levels_plain(cw, rs, lg, (S, q))
        assert len(got) == len(want) == L
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# (what, codeword shape, lg, levels, tile_log, launch_levels, blocks,
# expected (levels, columns log, tiles, blocks) a launch): the main path's
# codeword (65 rows: 260 tiles of 2^10 entries), the FS path's one level
# (2^9 columns a tile), a persistent grid of several tiles a block, a
# forced small tile (four columns: no fewer), and the multi-launch route
# (three rows: the fewest columns a tile, 32 bytes, keep SMs busy)
SCHEDULES = [
    ("timed prove", (2, 65, 4096), 12, 7, FOLD_TILE_LOG, LAUNCH_LEVELS,
     FOLD_BLOCKS, [(7, 3, 260, 260)]),
    ("FS level", (2, 65, 4096), 12, 1, FOLD_TILE_LOG, LAUNCH_LEVELS,
     FOLD_BLOCKS, [(1, 9, 260, 260)]),
    ("a batch, persistent", (2, 4, 65, 256), 8, 3, FOLD_TILE_LOG,
     LAUNCH_LEVELS, 7, [(3, 5, 260, 7)]),
    ("forced small tiles", (2, 5, 512), 9, 4, 6, LAUNCH_LEVELS, 3,
     [(4, 2, 40, 3)]),
    ("three launches", (2, 3, 1024), 10, 7, FOLD_TILE_LOG, 3, FOLD_BLOCKS,
     [(3, 2, 96, 96), (2, 2, 24, 24), (2, 2, 6, 6)]),
    ("two launches of a whole row", (2, 2, 64), 6, 6, 4, 4, 2,
     [(3, 1, 8, 2), (3, 0, 2, 2)])]


@pytest.mark.parametrize("case", SCHEDULES, ids=lambda c: c[0])
def test_kernel_schedule_shapes(case):
    what, shape, lg, L, tile_log, launch_levels, blocks, want = case
    rng = np.random.default_rng(90 + L)
    cw, rs = gf.tensor(_canon(rng, *shape)), _rs(rng, L)
    got, launches, shapes = emulate_gf_fri_fold(
        cw, rs, lg, tile_log=tile_log, launch_levels=launch_levels,
        blocks=blocks)
    assert shapes == want and launches == len(want)
    assert all(torch.equal(g, w) for g, w in
               zip(got, virgo_pc.fold_levels_plain(cw, rs, lg)))


def test_strided_table_identity():
    """Level k's twiddles are stage k of the top table: entry i of stage
    k == entry 2^k i of stage 0 == the power table of the inverse root of
    order 2^(lg - k) (the root squared k times)."""
    for lg in range(1, 13):
        inv = gf.inv_int(gf.root_of_unity_int(lg))
        top = chains.table_plain(chains.POWER, inv, None, 1 << (lg - 1),
                                 "cpu")
        tw = fft.stage_tables(top)
        for k in range(lg):
            own = chains.table_plain(
                chains.POWER, gf.inv_int(gf.root_of_unity_int(lg - k)), None,
                1 << (lg - 1 - k), "cpu")
            stage = (1 << lg) - ((1 << lg) >> k)
            assert torch.equal(top[:, ::1 << k], own)
            assert torch.equal(tw[stage:stage + own.shape[1]].T, own)


@pytest.mark.parametrize("S", [2, 4])
def test_rank_levels_match_its_fold_steps_and_the_whole(S):
    rng = np.random.default_rng(80 + S)
    lg, L = 8, 4
    whole = gf.tensor(_canon(rng, 2, 65, 1 << lg))
    rs = _rs(rng, L)
    want = virgo_pc.fold_levels(whole, rs, lg)
    for q in range(S):
        local = whole[..., q::S]
        got = virgo_pc.fold_levels(local, rs, lg, (S, q))
        mesh = SimpleNamespace(sp=S, sp_rank=q)
        cur = local
        for k in range(L):
            cur = pc_sharded.sharded_fold_step(cur, rs[k], lg - k, mesh)
            assert torch.equal(got[k], cur)
            assert torch.equal(got[k], want[k][..., q::S])


def test_twin_uses_only_the_plain_ops_and_wrapper_refuses_cpu(monkeypatch):
    rng = np.random.default_rng(99)
    cw, rs = gf.tensor(_canon(rng, 2, 65, 32)), _rs(rng, 3)
    want = virgo_pc.fold_levels_plain(cw, rs, 6, (2, 1))
    for name in ("table", "table_cuda"):
        monkeypatch.setattr(chains, name, None)
    for name in ("mul", "add", "sub", "mul_cuda", "lin_cuda"):
        monkeypatch.setattr(gf, name, None)
    monkeypatch.setattr(virgo_pc, "fold_step_cuda", None)
    plain, launches = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
    got = virgo_pc.fold_levels(cw, rs, 6, (2, 1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.PLAIN_CALLS["gf_fri_fold"] == plain["gf_fri_fold"] + 1
    assert kernels.LAUNCHES == launches
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        virgo_pc.fold_step_cuda(cw, rs, 5)
    assert [virgo_pc.fold_launches(L) for L in range(1, 20)] == [
        -(-L // LAUNCH_LEVELS) for L in range(1, 20)]
    assert virgo_pc.LAUNCH_LEVELS == LAUNCH_LEVELS
