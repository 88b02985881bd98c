"""Radix-2 FFT / IFFT over GF((2^61-1)^2) on int64 planes.

Counterpart of ``virgo_plus_tpu/pc/fft.py`` (reference
lib/virgo/src/RS_polynomial.cpp:26-220).  Transforms act on the last axis
and batch over any leading axes after the component axis: x is (2, ..., n);
roots of unity are python-int pairs computed on the host.

``fft`` and ``ifft`` send a CUDA tensor to ``gf_fft`` (``csrc/gf_fft.cu``):
``launches(lg_coef)`` launches, one up to 2^TILE_LOG coefficients, reading
strided rows in place, with the IFFT's 1/n in the last store.  Their
twiddles are ``twiddles``' stage tables, made once per (root, order,
device) by one ``gf_table`` launch (``powers``) and kept, so a call
launches nothing else; none is made inside a CUDA-graph capture (the
eager warm-up before it makes it).  A CPU
tensor goes to the plain twin ``fft_plain`` (``ifft_plain``): the
self-sorting stage loop, each stage a reshape, one product and an add/sub
pair on ``gf``'s plain ops, which counts ``kernels.PLAIN_CALLS["gf_fft"]``.
Every op is canonical, so both give the JAX package's bits.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field import chains, gf

TILE_LOG = 11   # the most butterfly stages one gf_fft launch runs
FFT_AXES = 3    # strided lead axes gf_fft reads in place
MAX_LOG = 40    # the largest log2 of an order gf_fft takes


def powers(base_int, n: int, device):
    """base: python-int pair -> (2, n) [1, base, base^2, ...], one
    ``chains.table`` call (the base goes by value)."""
    return chains.table(chains.POWER, base_int, None, n, device)


def stage_tables(table):
    """The power table (2, 2^(L-1)) of a root of order 2^L -> gf_fft's
    twiddles (2^L - 1, 2): stage dep's 2^(L-1-dep) powers of rou^(2^dep)
    (table[:, ::2^dep]) at 2^L - 2^(L-dep), one (re, im) pair a row."""
    order = 2 * table.shape[1]
    return torch.cat([table[:, ::1 << dep]
                      for dep in range(order.bit_length() - 1)]
                     + [table[:, :0]], dim=1).T.contiguous()


_TWIDDLES = {}   # (root, log2 of the order, device) -> (stage tables, i_neg)


def twiddles(rou_int, log_order: int, device):
    """gf_fft's twiddles for the root rou_int of order 2^log_order on a
    CUDA device: (``stage_tables`` of its powers, whether rou^(2^(L-2)) is
    -i), made once per (root, order, device) by one ``gf_table`` launch
    and kept: a CUDA graph replays it, and none is made inside a capture
    (the eager warm-up call before it makes it)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rou = tuple(int(v) for v in rou_int)
    key = (rou, log_order, dev)
    if key not in _TWIDDLES:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"gf_fft: no twiddles for the order 2^"
                               f"{log_order} on the capturing stream; an "
                               f"eager call makes them first")
        if log_order and gf.pow_int(rou, 1 << (log_order - 1)) != (
                gf.MOD - 1, 0):
            raise ValueError(f"gf_fft: {rou} is not a root of order 2^"
                             f"{log_order}")
        i_neg = log_order >= 2 and gf.pow_int(
            rou, 1 << (log_order - 2)) == (0, gf.MOD - 1)
        _TWIDDLES[key] = (stage_tables(powers(rou, (1 << log_order) // 2,
                                              dev)), int(i_neg))
    return _TWIDDLES[key]


def launches(lg_coef: int) -> int:
    """gf_fft's launches for a transform of 2^lg_coef coefficients."""
    return max(1, -(-lg_coef // TILE_LOG))


def _log2(n: int) -> int:
    lg = n.bit_length() - 1
    if n != 1 << lg:
        raise ValueError(f"fft: length {n} is not a power of two")
    return lg


def _inverse(n: int, rou_int):
    """(log2 n, the inverse root, 1/n) of an order-n IFFT
    (RS_polynomial.cpp:188-214; 1/n in the base field)."""
    lg = _log2(n)
    return (lg, gf.pow_int(rou_int, n - 1),
            gf.pow_int((n % gf.MOD, 0), gf.MOD - 2))


def fft(coeffs, log_order: int, rou_int):
    """coeffs: (2, ..., coef_len), coef_len = 2^lg_coef <= 2^log_order;
    rou_int: root of unity of order 2^log_order.  Returns (2, ...,
    2^log_order) evaluations (fast_fourier_transform in the reference)."""
    fn = fft_cuda if gf._on_cuda(coeffs) else fft_plain
    return fn(coeffs, log_order, rou_int)


def ifft(evals, rou_int):
    """Inverse FFT with coef_len == order (RS_polynomial.cpp:159-220)."""
    lg, inv_rou, inv_n = _inverse(evals.shape[-1], rou_int)
    fn = fft_cuda if gf._on_cuda(evals) else fft_plain
    return fn(evals, lg, inv_rou, inv_n)


def ifft_plain(evals, rou_int):
    """The plain twin of an IFFT (fft_plain at the inverse root, scaled)."""
    return fft_plain(evals, *_inverse(evals.shape[-1], rou_int))


def fft_plain(coeffs, log_order: int, rou_int, scale=None):
    """Plain twin of gf_fft: the block-replicated self-sorting stage loop
    (RS_polynomial.cpp:54-60 replication), times the python-int pair
    `scale` if given."""
    kernels.PLAIN_CALLS["gf_fft"] += 1
    lg_coef = _log2(coeffs.shape[-1])
    order = 1 << log_order
    assert lg_coef <= log_order
    lead = tuple(coeffs.shape[1:-1])
    dst = coeffs.repeat((1,) * (coeffs.dim() - 1)
                        + (order >> lg_coef,))
    rot = rou_int          # rou^(2^dep) for dep = 0, 1, ...
    rot_mul = []
    for _ in range(lg_coef):
        rot_mul.append(rot)
        rot = gf._py_mul(rot, rot)
    for dep in range(lg_coef - 1, -1, -1):
        m = 1 << dep
        half_blk = order >> (dep + 1)
        w = chains.table_plain(chains.POWER, rot_mul[dep], None, half_blk,
                               coeffs.device)
        w = w.reshape((2,) + (1,) * len(lead) + (half_blk, 1))
        pre = dst.reshape((2,) + lead + (half_blk, 2, m))
        e = pre[..., 0, :]
        t = gf.mul_plain(w, pre[..., 1, :])
        dst = torch.cat([gf.add_plain(e, t), gf.sub_plain(e, t)], dim=-2)\
                   .reshape((2,) + lead + (order,))
    if scale is not None:
        dst = gf.mul_plain(dst, gf.full((1,), scale[0], scale[1],
                                        coeffs.device))
    return dst


def fft_cuda(coeffs, log_order: int, rou_int, scale=None):
    """gf_fft on the card: same signature and bits as fft_plain on
    canonical inputs; launches(lg_coef) launches (and the root's twiddles
    once), none for an empty output."""
    if coeffs.device.type != "cuda":
        raise ValueError("gf_fft: coeffs must be on a CUDA device")
    if (coeffs.dtype != torch.int64 or coeffs.dim() < 2
            or coeffs.shape[0] != 2):
        raise ValueError(f"gf_fft: coeffs {coeffs.dtype} "
                         f"{tuple(coeffs.shape)}, (2, ..., n) int64 taken")
    lg_coef = _log2(coeffs.shape[-1])
    if not lg_coef <= log_order <= MAX_LOG:
        raise ValueError(f"gf_fft: 2^{lg_coef} coefficients onto 2^"
                         f"{log_order} points")
    sizes, strides = kernels.row_layout("gf_fft", coeffs, FFT_AXES)
    lead = tuple(coeffs.shape[1:-1])
    out = torch.empty((2,) + lead + (1 << log_order,), dtype=torch.int64,
                      device=coeffs.device)
    if out.numel():
        kernels.check_int("gf_fft", points=out.numel() // 2)
        tw, i_neg = twiddles(rou_int, log_order, coeffs.device)
        n = launches(lg_coef)
        tmp = torch.empty_like(out) if n > 1 else None
        s = (0, 0) if scale is None else tuple(int(v) for v in scale)
        kernels.launch("gf_fft", n, coeffs.data_ptr(), *sizes, *strides,
                       coeffs.stride(0), coeffs.stride(-1), tw.data_ptr(),
                       out.data_ptr(), None if tmp is None else tmp.data_ptr(),
                       lg_coef, log_order, i_neg, int(scale is not None), *s,
                       kernels.stream_ptr())
    return out
