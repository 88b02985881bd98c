"""The port's field-op dispatch and the layout its CUDA kernels read.

``gf.mul``, ``add``, ``sub``, ``neg`` and ``reduce_lazy`` send a CUDA
tensor to ``csrc/gf_ops.cu`` (``gf_mul``, ``gf_lin``) and a CPU tensor to
the plain versions.  Here, on the CPU:

* the dispatch: CPU tensors run the plain versions and count
  ``kernels.PLAIN_CALLS``, launch nothing, and the card wrappers raise on
  them; another device raises;
* the public ops == the JAX package's ``gf`` functions, bit for bit, at the
  call patterns of the prove, verify and FS paths: same shape, a (2, K, 1)
  challenge against (2, K, n), strided ``x[..., 0::2]``, a scalar (2,),
  rank 5 and empty;
* the size and stride descriptor the wrappers hand the kernels
  (``kernels.gf_layout``): each input rebuilt from its storage with
  ``torch.as_strided`` at the descriptor's sizes and strides, then the
  plain op, == the plain op on the original tensors, on non-canonical
  int64 inputs too;
* K1's twin ``fold_plain`` and the K2 twins run with the dispatching ops
  patched to raise: the twins use the plain versions only, so on the card
  they launch no field kernel.

Inputs come from numpy with a seed; field arithmetic is exact, so the
tolerance is 0.  The kernels themselves run only on a card: chip_smoke.py
holds them against the plain versions there."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from virgo_plus_tpu.field import gf as jgf
from virgo_plus_tpu_torch import kernels
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import sumcheck
from virgo_plus_tpu_torch.pc import keccak, merkle

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD
BINARY = ("add", "sub", "mul")
UNARY = ("neg", "reduce_lazy")

# (label, x's shape, y's shape, x strided along its last axis)
PATTERNS = [
    ("same shape", (2, 37), (2, 37), False),
    ("challenge (2, K, 1) against (2, K, n)", (2, 5, 1), (2, 5, 16), False),
    ("tables against a challenge", (2, 5, 16), (2, 5, 1), False),
    ("strided x[..., 0::2]", (2, 3, 8), (2, 3, 8), True),
    ("scalar (2,) against (2, K, n)", (2,), (2, 4, 6), False),
    ("rank 5", (2, 2, 3, 4, 5), (2, 2, 3, 4, 5), False),
    ("rank 5, broadcast", (2, 2, 1, 4, 1), (2, 1, 3, 1, 5), True),
    ("empty", (2, 0), (2, 0), False),
    # a mesh's field_sum reduces (bl, K, 2, 3) round polynomials: the sums
    # are elementwise, the first axis need not be the plane axis
    ("(bl, K, 2, 3) polynomials, sums only", (6, 5, 2, 3), (6, 5, 2, 3),
     False),
]
IDS = [p[0] for p in PATTERNS]


def _values(rng, shape, high):
    return rng.integers(0, high, size=shape, dtype=np.uint64)


def _inputs(seed, sx, sy, strided, high=M):
    """numpy uint64 x and y; x is a strided view when asked."""
    rng = np.random.default_rng(seed)
    if strided:
        x = _values(rng, sx[:-1] + (2 * sx[-1],), high)[..., 0::2]
    else:
        x = _values(rng, sx, high)
    return x, _values(rng, sy, high)


def _torch(a):
    """A port tensor with a's bits and a's strides (a strided numpy view
    becomes a strided tensor view)."""
    if a.flags.c_contiguous:
        return gf.tensor(a)
    base = a.base if a.base is not None else a
    return gf.tensor(base)[..., 0::2]


def _port(op, x, y):
    return getattr(gf, op)(x, y) if op in BINARY else getattr(gf, op)(x)


def _jax(op, x, y):
    f = getattr(jgf, op)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(y)) if op in BINARY
                      else f(jnp.asarray(x)))


@pytest.mark.parametrize("op", BINARY + UNARY)
def test_cpu_tensors_run_the_plain_versions(op):
    x, y = (gf.tensor(a) for a in _inputs(1, (2, 9), (2, 9), False))
    before = dict(kernels.PLAIN_CALLS), dict(kernels.LAUNCHES)
    out = _port(op, x, y)
    entry = "gf_mul" if op == "mul" else "gf_lin"
    want = dict(before[0])
    want[entry] += 1
    assert kernels.PLAIN_CALLS == want
    assert kernels.LAUNCHES == before[1]
    plain = (getattr(gf, f"{op}_plain")(x, y) if op in BINARY
             else getattr(gf, f"{op}_plain")(x))
    assert torch.equal(out, plain)


def test_card_wrappers_and_other_devices_raise():
    x = gf.tensor(np.zeros((2, 3), dtype=np.uint64))
    with pytest.raises(ValueError, match="CUDA"):
        gf.mul_cuda(x, x)
    for op in range(len(gf.LIN_OPS)):
        with pytest.raises(ValueError, match="CUDA"):
            gf.lin_cuda(op, x, x)
    meta = torch.empty((2, 3), dtype=torch.int64, device="meta")
    for op in BINARY + UNARY:
        with pytest.raises(ValueError, match="meta"):
            _port(op, meta, meta)


@pytest.mark.parametrize("label,sx,sy,strided", PATTERNS, ids=IDS)
def test_public_ops_match_jax(label, sx, sy, strided):
    x, y = _inputs(2, sx, sy, strided)
    for op in BINARY + UNARY:
        if op != "mul" and op in BINARY and len(sx) != len(sy):
            continue          # add and sub broadcast whole shapes
        if op == "mul" and sx[0] != 2:
            continue          # the product needs the plane axis first
        want = _jax(op, x, y)
        got = gf.to_numpy(_port(op, _torch(x), _torch(y)))
        assert got.shape == want.shape, (op, label)
        assert np.array_equal(got, want), (op, label)


def _rebuilt(t, shape, sizes, descriptor):
    """t read as the kernel reads it: index k of the first axis (a plane
    for the product) at t's storage offset plus k first-axis strides, each
    at the descriptor's sizes and element strides; the result has the
    output's shape."""
    first, *strides = descriptor
    views = [torch.as_strided(t, sizes, strides,
                              t.storage_offset() + k * first)
             for k in range(shape[0])]
    return torch.stack(views).reshape(shape)


@pytest.mark.parametrize("high", [M, 2 ** 63, 2 ** 64],
                         ids=["canonical", "below 2^63", "any int64"])
@pytest.mark.parametrize("label,sx,sy,strided", PATTERNS +
                         [("transposed", (2, 6, 7), (2, 6, 7), False)],
                         ids=IDS + ["transposed"])
def test_layout_descriptor_reads_the_inputs(label, sx, sy, strided, high):
    x, y = (_torch(a) for a in _inputs(3, sx, sy, strided, high))
    if label == "transposed":
        x = gf.tensor(_values(np.random.default_rng(4), (2, 7, 6),
                              high)).transpose(1, 2)
    # (op, x, y, output shape): unary ops read x alone, at x's shape
    cases = [("mul", x, y, (2,) + gf._broadcast(x.shape[1:], y.shape[1:]))
             ] if sx[0] == 2 else []
    if len(sx) == len(sy):
        cases += [(op, x, y, gf._broadcast(x.shape, y.shape))
                  for op in ("add", "sub")]
    cases += [(op, x, x, tuple(x.shape)) for op in UNARY]
    for op, a, b, shape in cases:
        mul = op == "mul"
        sizes, xs, ys = kernels.gf_layout(shape, a, b, mul=mul)
        assert len(sizes) == kernels.GF_AXES
        assert int(np.prod(sizes)) * shape[0] == int(np.prod(shape))
        ar, br = (_rebuilt(t, shape, sizes, st) for t, st in ((a, xs), (b, ys)))
        if mul:
            assert torch.equal(gf.mul_plain(ar, br), gf.mul_plain(a, b))
        else:
            code = gf.LIN_OPS.index(op)
            assert torch.equal(gf.lin_plain(code, ar, br),
                               gf.lin_plain(code, a, b)), (op, label)


@pytest.mark.parametrize("p,q", [((5, 1), (5, 16)), ((), (4, 6)),
                                 ((2, 1, 4, 1), (1, 3, 1, 5)), ((0,), (1,)),
                                 ((3,), (4,)), ((2, 3), (3, 3))])
def test_broadcast_matches_torch(p, q):
    try:
        want = tuple(torch.broadcast_shapes(p, q))
    except RuntimeError:
        with pytest.raises(ValueError):
            gf._broadcast(p, q)
        return
    assert gf._broadcast(p, q) == want


def _raise(*args):
    raise AssertionError("a twin called a dispatching field op")


def _flat(r):
    if isinstance(r, (tuple, list)):
        return [t for part in r for t in _flat(part)]
    return [r]


def test_twins_use_only_the_plain_field_ops(monkeypatch):
    rng = np.random.default_rng(5)
    v, a, m = (gf.tensor(_values(rng, (2, 3, 16), M)) for _ in range(3))
    rs = gf.tensor(_values(rng, (2, 3, 4), M))
    words = gf.tensor(_values(rng, (8, 6), 2 ** 64))
    chain = gf.tensor(_values(rng, (3, 4, 5), 2 ** 64))
    leaves = gf.tensor(_values(rng, (4, 12), 2 ** 64))
    twins = [lambda: sumcheck.fold_plain(v, a, m, rs),
             lambda: keccak.sha3_256_x64_plain(words),
             lambda: keccak.sha3_chain_x64_plain(chain),
             lambda: merkle.forest_plain(leaves, [8, 4])]
    want = [_flat(twin()) for twin in twins]
    for op in BINARY + UNARY:
        monkeypatch.setattr(gf, op, _raise)
    for twin, w in zip(twins, want):
        got = _flat(twin())
        assert len(got) == len(w)
        assert all(torch.equal(g, e) for g, e in zip(got, w))
