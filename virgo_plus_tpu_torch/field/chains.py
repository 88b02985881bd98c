"""GF((2^61-1)^2) tables and segment sums: one kernel launch a call.

Inside the JAX package's jits XLA fuses whole chains of field ops into one
loop: a beta table's doubling steps (``virgo_plus_tpu/gkr/beta.py``), a
power table's (``pc/fft.py`` ``powers``),
a log-tree sum (``gkr/sumcheck.py`` ``tree_sum``) or a gate scatter's prefix
sum (``apply_scatter_arrays``).  Here each such chain is one call:

* ``table(op, a, r, n, device)``: ``BETA`` gives (2, *lead, n) tables with
  entry i = init · prod_{j<k} (bit j of i ? r_j : 1 - r_j), n = 2^k (a =
  init (2, *lead), r (2, *lead, >= k)); ``POWER`` gives entry i = base^i
  for i < n, with the base a tensor (2, *lead) or a Python-int pair
  (lead ());
* ``segsum(x, plan)``: x (*rows, N) -> (*rows, G), segment g the field sum
  of x[..., idx[t]] over t in [starts[g], ends[g]) (0 when empty), for a
  plan (idx or None, starts, ends) of int64 tensors; without a plan one
  segment, the whole last axis.

``lead`` has at most one axis and ``rows`` at most ``SEG_AXES``.  A CUDA
tensor goes to ``csrc/gf_chains.cu`` (``gf_table``, ``gf_segsum``), which
reads strided inputs in place and takes a Python-int base's squarings
(``power_factors``) by value; a CPU
tensor to the plain twin (``table_plain``, ``segsum_plain``: the doubling
loops, the log tree and the prefix-sum route on ``gf``'s plain ops only),
which counts ``kernels.PLAIN_CALLS``.  Every field op returns the canonical
representative, so on canonical inputs (all the callers') kernel and twin
give the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from . import gf

# gf_table's op codes (csrc/gf_chains.cu)
TABLE_OPS = ("beta", "power")
BETA, POWER = range(len(TABLE_OPS))

SEG_AXES = 4   # row axes gf_segsum takes
# gf_segsum's summers: a thread, a warp or a block per output, by the mean
# segment length (up to THREAD_MEAN, up to WARP_MEAN, longer)
SEG_THREAD, SEG_WARP, SEG_BLOCK = range(3)
THREAD_MEAN, WARP_MEAN = 16, 512


def _on_cuda(device) -> bool:
    t = torch.device(device).type
    if t == "cuda":
        return True
    if t == "cpu":
        return False
    raise ValueError(f"gf chains: no kernels for device {device}")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def table(op: int, a, r, n: int, device):
    """See the module docstring; device: where the tables go (a's)."""
    fn = table_cuda if _on_cuda(device) else table_plain
    return fn(op, a, r, n, device)


def table_plain(op: int, a, r, n: int, device):
    """Plain twin of gf_table: the doubling loops."""
    kernels.PLAIN_CALLS["gf_table"] += 1
    if op == BETA:
        out = a[..., None]
        for j in range(n.bit_length() - 1):
            hi = gf.mul_plain(out, r[..., j:j + 1])
            out = torch.cat([gf.sub_plain(out, hi), hi], dim=-1)
        return out
    if isinstance(a, torch.Tensor):
        out = gf.ones(tuple(a.shape[1:]) + (1,), a.device)
        cur = a
        while out.shape[-1] < n:
            out = torch.cat([out, gf.mul_plain(out, cur[..., None])], dim=-1)
            cur = gf.mul_plain(cur, cur)
        return out[..., :n]
    out = gf.ones((1,), device)
    cur = tuple(a)
    while out.shape[1] < n:
        nxt = gf.mul_plain(out, gf.full((1,), cur[0], cur[1], device))
        out = torch.cat([out, nxt], dim=1)
        cur = gf._py_mul(cur, cur)
    return out[:, :n]


@functools.lru_cache(maxsize=256)
def power_factors(base, k: int):
    """The k factors base^(2^j), j < k, of a power table of a Python-int
    base, as gf_table takes them by value: (re, im) pairs in host memory,
    kept per (base, k) and only read (the C entry copies them into the
    launch's arguments)."""
    words, cur = [], base
    for _ in range(k):
        words += cur
        cur = gf._py_mul(cur, cur)
    return (ctypes.c_ulonglong * max(len(words), 1))(*words)


def table_cuda(op: int, a, r, n: int, device):
    """gf_table on the card, one launch: same signature and bits as
    table_plain on canonical inputs."""
    tensor = isinstance(a, torch.Tensor)
    k = max(n - 1, 0).bit_length()
    lead = tuple(a.shape[1:]) if tensor else ()
    dev = a.device if tensor else torch.device(device)
    if dev.type != "cuda" or (r is not None and r.device != dev):
        raise ValueError("gf_table: a and r must be on one CUDA device")
    if op == BETA:
        if not tensor or r is None or n != 1 << k:
            raise ValueError("gf_table: a beta table needs init and r "
                             "tensors and n a power of two")
        if tuple(r.shape[:-1]) != (2,) + lead or r.shape[-1] < k:
            raise ValueError(f"gf_table: r {tuple(r.shape)} against init "
                             f"{tuple(a.shape)} and {k} bits")
    elif op != POWER or r is not None:
        raise ValueError(f"gf_table: op {op}")
    if tensor and (a.dtype != torch.int64 or a.shape[0] != 2
                   or len(lead) > 1):
        raise ValueError(f"gf_table: a {a.dtype} {tuple(a.shape)}, (2,) or "
                         f"(2, L) int64 taken")
    if r is not None and r.dtype != torch.int64:
        raise TypeError(f"gf_table: r is {r.dtype}, not int64")
    base = (0, 0) if tensor else tuple(int(v) for v in a)
    if not all(0 <= v < gf.MOD for v in base):
        raise ValueError(f"gf_table: base {base} is not canonical")
    out = torch.empty((2,) + lead + (n,), dtype=torch.int64, device=dev)
    if out.numel():
        tables = lead[0] if lead else 1
        kernels.check_int("gf_table", tables=tables)
        a_st = (a.stride(0), a.stride(1) if lead else 0) if tensor else (0, 0)
        r_st = ((r.stride(0), r.stride(1) if lead else 0, r.stride(-1))
                if r is not None else (0, 0, 0))
        factors = None if tensor else power_factors(base, k)
        kernels.launch("gf_table", 1, op, a.data_ptr() if tensor else None,
                       None if r is None else r.data_ptr(), out.data_ptr(),
                       tables, k, n, *a_st, *r_st,
                       None if factors is None else ctypes.addressof(factors),
                       kernels.stream_ptr())
    return out


# ---------------------------------------------------------------------------
# Segment sums
# ---------------------------------------------------------------------------

def segsum(x, plan=None):
    """See the module docstring."""
    idx, starts, ends = (None, None, None) if plan is None else plan
    fn = segsum_cuda if _on_cuda(x.device) else segsum_plain
    return fn(x, idx, starts, ends)


def tree_sum_plain(x):
    """Field sum along the last axis, (..., N) -> (...), by an exact log
    tree on the plain add (an odd level is zero-padded)."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = gf.add_plain(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def prefix_sum(x, add):
    """Inclusive field prefix sum along the last axis (Hillis-Steele,
    exact) with the field add `add`: each row on its own."""
    n = x.shape[-1]
    d = 1
    while d < n:
        shifted = torch.cat([torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype,
                                         device=x.device), x[..., :n - d]], -1)
        x = add(x, shifted)
        d *= 2
    return x


def segsum_plain(x, idx, starts, ends):
    """Plain twin of gf_segsum: the log tree for one whole segment, else a
    gather, the prefix sum and the difference of its ends."""
    kernels.PLAIN_CALLS["gf_segsum"] += 1
    if starts is None:
        return tree_sum_plain(x)[..., None]
    s = prefix_sum(x if idx is None else x[..., idx], gf.add_plain)
    s0 = torch.cat([torch.zeros(s.shape[:-1] + (1,), dtype=s.dtype,
                                device=s.device), s], -1)
    return gf.sub_plain(s0[..., ends], s0[..., starts])


def segsum_cuda(x, idx, starts, ends):
    """gf_segsum on the card, one launch: same signature and bits as
    segsum_plain on canonical inputs."""
    plan = [t for t in (idx, starts, ends) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in plan):
        raise ValueError("gf_segsum: x and the plan must be on one CUDA "
                         "device")
    if x.dtype != torch.int64 or any(t.dtype != torch.int64 for t in plan):
        raise TypeError("gf_segsum: expected int64 tensors")
    if (starts is None) != (ends is None) or (starts is None
                                              and idx is not None):
        raise ValueError("gf_segsum: starts and ends come together, and an "
                         "index only with them")
    if any(t.dim() != 1 or not t.is_contiguous() for t in plan) or (
            starts is not None and starts.shape != ends.shape):
        raise ValueError("gf_segsum: the plan must be contiguous vectors")
    if not 1 <= x.dim() <= 1 + SEG_AXES:
        raise ValueError(f"gf_segsum: {x.dim()} axes, 1 to {1 + SEG_AXES} "
                         f"taken")
    rows = tuple(x.shape[:-1])
    g = 1 if starts is None else starts.numel()
    out = torch.empty(rows + (g,), dtype=torch.int64, device=x.device)
    if out.numel():
        kernels.check_int("gf_segsum", segments=g, rows=max(rows, default=1))
        n = x.shape[-1]
        terms = n if idx is None else idx.numel()
        mean = terms / g
        mode = (SEG_THREAD if mean <= THREAD_MEAN else
                SEG_WARP if mean <= WARP_MEAN else SEG_BLOCK)
        pad = SEG_AXES - len(rows)
        sizes = (1,) * pad + rows
        strides = (0,) * pad + tuple(x.stride()[:-1])
        ptr = lambda t: None if t is None else t.data_ptr()
        kernels.launch("gf_segsum", 1, x.data_ptr(), ptr(idx), ptr(starts),
                       ptr(ends), out.data_ptr(), g, n, *sizes, *strides,
                       x.stride(-1), mode, kernels.stream_ptr())
    return out
