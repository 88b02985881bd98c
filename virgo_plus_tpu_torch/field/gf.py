"""GF((2^61-1)^2) batched arithmetic on int64 tensors.

Counterpart of ``virgo_plus_tpu/field/gf.py``.  An array of N field elements
is an ``int64[2, N]`` tensor: plane 0 real parts, plane 1 imaginary parts,
each canonical in ``[0, 2^61-1)``.  The planes hold the same bit patterns as
the JAX package's ``uint64`` planes; PyTorch has almost no ``uint64``
arithmetic, so three rules keep int64 exact:

* right shifts are logical: an arithmetic ``>>`` followed by a mask (``_srl``);
* int64 ``*``, ``+`` and ``<<`` wrap modulo 2^64 exactly like u64, which the
  four-partial product ``_mymult`` relies on;
* only values below 2^63 are ever compared.  ``_mymult`` of two inputs below
  2^62 (the Karatsuba ``all_prod``) and the lazy ``t_img`` sum can reach 2^63
  and read as negative; they go through the Mersenne fold before any
  comparison.

Multiplication is the reference's 3-mult Karatsuba over four 32x32->64
partials (fieldElement.cpp:49-78, 466-487), so canonical outputs are
bit-identical to the JAX package and to the reference.

The public ``mul``, ``add``, ``sub``, ``neg`` and ``reduce_lazy`` dispatch
on the device of their first argument: a CUDA tensor goes to a kernel of
``csrc/gf_ops.cu`` (``gf_mul``, or ``gf_lin`` with an op code), one launch
a call, which reads broadcast and strided inputs in place; a CPU tensor to
the plain version (``mul_plain``, ...), which counts
``kernels.PLAIN_CALLS``.  The kernels repeat the plain versions' int64
steps, so the two give the same bits on every input.  The sum family is
elementwise, so its first axis need not be the plane axis (a mesh reduces
(bl, K, 2, 3) round polynomials).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

MOD = (1 << 61) - 1  # the Mersenne prime 2^61-1
MAX_ORDER = 62  # multiplicative group of GF(p^2) has order p^2-1 = 2^62*m

# Generator of the order-2^62 subgroup (fieldElement.cpp:237-249).
ROU_MAX_REAL = 2147483648
ROU_MAX_IMG = 1033321771269002680

_LO32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def zeros(shape=(), device="cpu"):
    return torch.zeros((2,) + tuple(shape), dtype=torch.int64, device=device)


def ones(shape=(), device="cpu"):
    return full(shape, 1, 0, device)


def full(shape, real, img=0, device="cpu"):
    """Python-int planes written as fills: a CUDA graph captures a fill,
    but not the host copy that item assignment makes."""
    e = torch.empty((2,) + tuple(shape), dtype=torch.int64, device=device)
    e[0].fill_(real)
    e[1].fill_(img)
    return e


def tensor(x, device="cpu"):
    """numpy uint64 (or any integer array of canonical values) -> int64."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def from_u64(real, img=None, device="cpu"):
    real = np.asarray(real, dtype=np.uint64)
    if img is None:
        img = np.zeros_like(real)
    return tensor(np.stack([real, np.asarray(img, dtype=np.uint64)]), device)


def to_numpy(x) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bit patterns."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def to_u64(x):
    x = to_numpy(x)
    return x[0], x[1]


def from_int(x, img=0, device="cpu"):
    if x < 0:
        x = MOD + x
    if img < 0:
        img = MOD + img
    return full((), x, img, device)


# ---------------------------------------------------------------------------
# Base-field primitives on int64 planes
# ---------------------------------------------------------------------------

def _srl(x, s: int):
    """Logical right shift of the u64 bit pattern by a constant 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _cond_sub_p(x):
    # x must be below 2^63 (non-negative as int64)
    return torch.where(x >= MOD, x - MOD, x)


def _mymult(x, y):
    """floor(x*y / 2^61) + (x*y & p) for x, y < 2^62, as a u64 bit pattern
    (< 2^63 + 2^61, so it may read negative).  Exact 128-bit product from
    four 32x32->64 partials (fieldElement.cpp:466-487)."""
    xl = x & _LO32
    xh = x >> 32          # x < 2^62: arithmetic == logical
    yl = y & _LO32
    yh = y >> 32
    bd = xl * yl          # < 2^64, wraps into the sign bit
    ac = xh * yh
    ad_bc = xh * yl + xl * yh   # < 2^63
    hi = ac + ((ad_bc + _srl(bd, 32)) >> 32)
    lo = bd + (ad_bc << 32)
    return ((hi << 3) | _srl(lo, 61)) + (lo & MOD)


def _base_neg(x):
    # x ^ p == p - x for canonical x (fieldElement.cpp:86-87)
    return x ^ MOD


# ---------------------------------------------------------------------------
# Extension-field ops: the plain versions
# ---------------------------------------------------------------------------

def add_plain(x, y):
    kernels.PLAIN_CALLS["gf_lin"] += 1
    return _cond_sub_p(x + y)


def reduce_lazy_plain(x):
    """Reduce a lazy sum of up to 8 canonical elements (< 2^64 as u64, so
    possibly negative as int64) to canonical [0, p): Mersenne fold with a
    logical shift, then one conditional subtract."""
    kernels.PLAIN_CALLS["gf_lin"] += 1
    return _cond_sub_p(_srl(x, 61) + (x & MOD))


def sub_plain(x, y):
    kernels.PLAIN_CALLS["gf_lin"] += 1
    return _cond_sub_p(x + (y ^ MOD))


def neg_plain(x):
    kernels.PLAIN_CALLS["gf_lin"] += 1
    return _cond_sub_p(x ^ MOD)


def mul_plain(x, y):
    """(a+bi)(c+di): 3-mult Karatsuba (fieldElement.cpp:49-78)."""
    kernels.PLAIN_CALLS["gf_mul"] += 1
    a, b = x[0], x[1]
    c, d = y[0], y[1]
    all_prod = _mymult(a + b, c + d)        # may read negative
    ac = _mymult(a, c)                      # < 2p
    bd = _mymult(b, d)                      # < 2p
    nac = _base_neg(_cond_sub_p(ac))
    nbd = _base_neg(_cond_sub_p(bd))
    t_img = all_prod + nac + nbd            # < 8p as u64
    t_img = _cond_sub_p(_srl(t_img, 61) + (t_img & MOD))
    t_real = _cond_sub_p(_cond_sub_p(ac + nbd))
    return torch.stack([t_real, t_img])


# gf_lin's op codes (csrc/gf_ops.cu)
LIN_OPS = ("add", "sub", "neg", "reduce_lazy")
ADD, SUB, NEG, REDUCE_LAZY = range(len(LIN_OPS))
_LIN_PLAIN = (add_plain, sub_plain, lambda x, y: neg_plain(x),
              lambda x, y: reduce_lazy_plain(x))


def lin_plain(op: int, x, y=None):
    """Plain twin of gf_lin: LIN_OPS[op] of x (and y for add and sub)."""
    return _LIN_PLAIN[op](x, y)


# ---------------------------------------------------------------------------
# Extension-field ops on the card: one kernel launch a call
# ---------------------------------------------------------------------------

def _broadcast(p, q) -> tuple:
    """torch.broadcast_shapes of two sizes, at a fraction of its host
    time (0.47 against 8.0 us a call on an H100 machine's host, timed by
    chip_smoke.py's phase 3)."""
    if p == q:
        return tuple(p)
    n = max(len(p), len(q))
    p = (1,) * (n - len(p)) + tuple(p)
    q = (1,) * (n - len(q)) + tuple(q)
    out = []
    for i, j in zip(p, q):
        if i != j and i != 1 and j != 1:
            raise ValueError(f"gf: shapes {p} and {q} do not broadcast")
        out.append(j if i == 1 else i)
    return tuple(out)


def _launch(entry, op, shape, x, y):
    """Output (shape, contiguous) of gf_mul or gf_lin over x and y (y is x
    for a unary op), checked and launched on the current stream.  gf_mul
    takes the output's elements (a plane's words), gf_lin all its words."""
    mul = op is None
    kernels.check_gf(entry, shape, x, y, mul)
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    n = out.numel() // 2 if mul else out.numel()
    if n:
        kernels.check_int(entry, words=out.numel())
        sizes, xs, ys = kernels.gf_layout(shape, x, y, mul)
        args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), n, *sizes, *xs,
                *ys, kernels.stream_ptr())
        kernels.launch(entry, 1, *(args if mul else (op,) + args))
    return out


def mul_cuda(x, y):
    """gf_mul on the card: same signature and bits as mul_plain."""
    return _launch("gf_mul", None, (2,) + _broadcast(x.shape[1:], y.shape[1:]),
                   x, y)


def lin_cuda(op: int, x, y=None):
    """gf_lin on the card: same bits as lin_plain(op, x, y)."""
    if y is None:
        return _launch("gf_lin", op, tuple(x.shape), x, x)
    return _launch("gf_lin", op, _broadcast(x.shape, y.shape), x, y)


# ---------------------------------------------------------------------------
# Extension-field public ops
# ---------------------------------------------------------------------------

def _on_cuda(x) -> bool:
    """Whether x goes to the kernels: a CUDA tensor does, a CPU tensor goes
    to the plain versions, any other raises."""
    t = x.device.type
    if t == "cuda":
        return True
    if t == "cpu":
        return False
    raise ValueError(f"gf: no field kernels for device {x.device}")


def add(x, y):
    return lin_cuda(ADD, x, y) if _on_cuda(x) else add_plain(x, y)


def reduce_lazy(x):
    """See reduce_lazy_plain."""
    return lin_cuda(REDUCE_LAZY, x) if _on_cuda(x) else reduce_lazy_plain(x)


def sub(x, y):
    return lin_cuda(SUB, x, y) if _on_cuda(x) else sub_plain(x, y)


def neg(x):
    return lin_cuda(NEG, x) if _on_cuda(x) else neg_plain(x)


def mul(x, y):
    """(a+bi)(c+di), elementwise over the broadcast shape."""
    return mul_cuda(x, y) if _on_cuda(x) else mul_plain(x, y)


def eq(x, y):
    return torch.all(x == y, dim=0)


def is_zero(x):
    return torch.all(x == 0, dim=0)


# ---------------------------------------------------------------------------
# Powers / inverses (static python-int exponents)
# ---------------------------------------------------------------------------

def pow_static(x, e: int):
    acc = None
    base = x
    while e:
        if e & 1:
            acc = base if acc is None else mul(acc, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if acc is None:
        return ones(x.shape[1:], x.device)
    return acc


_INV_EXP = MOD * MOD - 2


def inv(x):
    """x^(p^2-2), batched square-and-multiply over the 122 exponent bits."""
    acc = ones(x.shape[1:], x.device)
    base = x
    e = _INV_EXP
    while e:
        if e & 1:
            acc = mul(acc, base)
        base = mul(base, base)
        e >>= 1
    return acc


# ---------------------------------------------------------------------------
# Roots of unity (host-side python-int computation)
# ---------------------------------------------------------------------------

def _py_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c % MOD
    bd = b * d % MOD
    ad_bc = ((a + b) * (c + d) - ac - bd) % MOD
    return ((ac - bd) % MOD, ad_bc)


def _py_pow(x, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = _py_mul(r, x)
        x = _py_mul(x, x)
        e >>= 1
    return r


def root_of_unity_int(log_order: int):
    """(real, img) ints of the canonical 2^log_order root of unity
    (fieldElement.cpp:237-249)."""
    assert log_order <= 61
    rou = (ROU_MAX_REAL, ROU_MAX_IMG)
    for _ in range(MAX_ORDER - log_order):
        rou = _py_mul(rou, rou)
    return rou


def root_of_unity(log_order: int, device="cpu"):
    r, i = root_of_unity_int(log_order)
    return full((), r, i, device)


def inv_int(x):
    return _py_pow(x, MOD * MOD - 2)


def pow_int(x, e: int):
    return _py_pow(x, e)
