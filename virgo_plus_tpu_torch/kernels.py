"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is a plain-C-interface CUDA file compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` of the checkout, at first use, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library name
carries a hash of the source, so an edited source is rebuilt.  A build
writes a temporary file of its own and renames it into place, so processes
that build one source at once (the ranks of a sharded prove) never load a
partial library.

A source may expose several C entries; counts are kept per entry.  Every
kernel wrapper adds to ``LAUNCHES[entry]`` the number of device launches
its C entry makes (K1: ``sumcheck.fold_launches(bl)``, gf_fft:
``fft.launches(lg_coef)``, each K2 entry, each field op, each field chain,
each fold, each GKR init stage, each circuit layer, each phase of
the fft_gkr stage tables and each virtual oracle: one, none for an empty
output; the fft_gkr circuit: ``fft_gkr.circuit_launches(lg)``), and its
plain PyTorch twin adds one to ``PLAIN_CALLS[entry]`` when it runs instead
(CPU tensors only).  ``reset_counts`` zeroes both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "csrc"
BUILD = ROOT.parent / "build" / "torch_kernels"

# source (csrc/<source>.cu) -> {entry: (C symbol, argtypes)}; every C
# entry returns its cudaError_t as int
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_ulonglong
SOURCES = {
    "sumcheck_fold": {
        "sumcheck_fold": ("vpt_sumcheck_fold", [_P] * 8 + [_I, _I, _I, _P]),
    },
    "keccak": {
        "sha3_256_x64": ("vpt_sha3_256_x64", [_P, _P, _I, _P]),
        "sha3_chain_x64": ("vpt_sha3_chain_x64", [_P, _P, _I, _I, _P]),
        "merkle_forest": ("vpt_merkle_forest",
                          [_P, _L, _P, _P, _I, _I, _I, _P]),
    },
    # (gf_lin: its op code, then) x, y, out, the output's elements
    # (gf_mul) or words (gf_lin), GF_AXES sizes, x's and y's
    # 1 + GF_AXES strides, the stream
    "gf_ops": {
        "gf_mul": ("vpt_gf_mul", [_P] * 3 + [_I] * 5 + [_L] * 10 + [_P]),
        "gf_lin": ("vpt_gf_lin", [_I] + [_P] * 3 + [_I] * 5 + [_L] * 10
                   + [_P]),
    },
    # gf_table: op, a, r, out, tables, index bits, entries, a's 2 and r's
    # 3 strides, a by-value base's factors (host memory), the stream;
    # gf_segsum: x, idx, starts, ends, out, segments, the last axis'
    # length, SEG_AXES row sizes and strides, the last axis' stride, the
    # summer, the stream
    "gf_chains": {
        "gf_table": ("vpt_gf_table", [_I] + [_P] * 3 + [_I, _I] + [_L] * 6
                     + [_P, _P]),
        "gf_segsum": ("vpt_gf_segsum", [_P] * 5 + [_I, _L] + [_I] * 4
                      + [_L] * 5 + [_I, _P]),
    },
    # the input rows (pointer, FFT_AXES lead sizes and strides, plane and
    # last-axis strides), then gf_fft: the twiddles, out, scratch, log2 of
    # the coefficients and of the order, the sign of the fourth root, the
    # scale flag and its by-value element, the stream; gf_fri_fold: w and
    # its 2 strides, r and its plane stride, out, log2 of the output row,
    # the stream
    "gf_fft": {
        "gf_fft": ("vpt_gf_fft", [_P] + [_I] * 3 + [_L] * 5 + [_P] * 3
                   + [_I] * 4 + [_U, _U, _P]),
        "gf_fri_fold": ("vpt_gf_fri_fold", [_P] + [_I] * 3 + [_L] * 5
                        + [_P, _L, _L, _P, _L, _P, _I, _P]),
    },
    # values, its rows and last axis; c0, its columns, its first claim's;
    # the beta tables (count, host arrays of pointers and plane strides);
    # the plan's tab, slot_tab, starts, liu_starts, dg, coef, terms, idx,
    # gate, liu_ref, lists, the slots, a thread slot's most terms, the warp
    # and block slots, rs, its pairs; out, its rs region's offset; the
    # stream
    "gkr_inits": {
        entry: (f"vpt_{entry}", [_P, _L, _L, _P, _L, _L, _I, _P, _P]
                + [_P] * 6 + [_L] + [_P] * 4 + [_I] * 4 + [_P, _L, _P, _L,
                                                             _P])
        for entry in ("gkr_p1_inits", "gkr_p2_inits")},
    # values, its rows and last axis; x_idx, y_idx, the coefficients, the
    # layer's gates, x's and the output's offsets in a row; the stream
    "circuit_eval": {
        "gf_eval_layer": ("vpt_gf_eval_layer", [_P, _I, _L, _P, _P, _P, _I,
                                                _L, _L, _P]),
    },
    # the phase; bg, the twiddles, V or bu, vu, out; the stages, lg, the
    # first stage's dep; the stream
    "fft_gkr": {
        "fg_stage_tables": ("vpt_fg_stage_tables", [_I] + [_P] * 5
                            + [_I] * 3 + [_P]),
        # r and the evaluation points, each with its plane and element
        # strides; the twiddles; inv_n's two words; out, the partial sums;
        # lg; the stream
        "fg_build_circuit": ("vpt_fg_build_circuit", [_P, _L, _L] * 2
                             + [_P, _U, _U, _P, _P, _I, _P]),
    },
    # l, q, h and c0, each with its plane stride; the two tables; srec;
    # vo, h_full; the elements a plane; log2 of the columns; the stream
    "virgo_pc": {
        "pc_virtual_oracle": ("vpt_pc_virtual_oracle", [_P, _L] * 4
                              + [_P, _P, _U, _P, _P, _L, _I, _P]),
    },
}
ENTRIES = {entry: src for src, entries in SOURCES.items() for entry in entries}

LAUNCHES = {entry: 0 for entry in ENTRIES}
PLAIN_CALLS = {entry: 0 for entry in ENTRIES}

_LIBS = {}   # source -> loaded library
_FNS = {}    # entry -> C function


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns {name: build log}."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            logs[name] = "(cached)"
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def lib(entry: str):
    """The C function of one entry, building its source on first use."""
    if entry not in _FNS:
        src = ENTRIES[entry]
        if src not in _LIBS:
            out = _target(src)
            if not out.exists():
                build([src])
            _LIBS[src] = ctypes.CDLL(str(out))
        symbol, argtypes = SOURCES[src][entry]
        fn = getattr(_LIBS[src], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return _FNS[entry]


def launch(entry: str, n_launches: int, *args):
    """Call a kernel's C entry, which makes ``n_launches`` device launches,
    and raise on a CUDA error; counts the launches."""
    err = lib(entry)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed: cudaError_t {err}")
    LAUNCHES[entry] += n_launches


def check_cuda(name: str, tensors, shapes):
    """Wrapper-side checks: every tensor on one CUDA device, int64,
    contiguous, of its expected shape."""
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


GF_AXES = 4   # axes after the first that gf_mul and gf_lin take


def check_gf(name: str, shape, x, y, mul: bool):
    """Wrapper-side checks of a field op of output `shape`: x and y on one
    CUDA device, int64, 1 to 1 + GF_AXES axes; for the product a plane
    axis of 2 first on each input.  The sums are elementwise, so their
    first axis may have any size.  Any strides."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"{name}: x and y must be on one CUDA device")
    if x.dtype != torch.int64 or y.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 tensors, got {x.dtype}, "
                        f"{y.dtype}")
    if mul and (x.dim() == 0 or y.dim() == 0 or x.shape[0] != 2
                or y.shape[0] != 2):
        raise ValueError(f"{name}: no plane axis of 2 in {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if not 1 <= len(shape) <= 1 + GF_AXES:
        raise ValueError(f"{name}: {len(shape)} axes, 1 to {1 + GF_AXES} "
                         f"taken")


def gf_layout(shape, x, y, mul: bool):
    """The size and stride descriptor of a field op of output `shape` (1 to
    1 + GF_AXES axes; for the product the plane axis first): the output's
    sizes after its first axis, padded at the front with 1 to GF_AXES; for
    each input its stride on the first axis, then its element stride on
    each of those GF_AXES axes, 0 where it is broadcast.  The inputs align
    from the right, with the output (add, sub, ...) or, for the product,
    plane axis with plane axis and the rest with the rest.  Offsets come
    from ``data_ptr()``."""
    r = len(shape) - 1
    sizes = (1,) * (GF_AXES - r) + tuple(shape[1:])

    def strides(t):
        st = [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]
        if not mul:
            st = [0] * (r + 1 - len(st)) + st
        return (st[0],) + (0,) * (GF_AXES + 1 - len(st)) + tuple(st[1:])

    return sizes, strides(x), strides(y)


def row_layout(name: str, x, axes: int):
    """The rows of x (planes, *lead, n) as `axes` lead sizes and element
    strides: axes that are one strided axis merged, size-1 axes dropped,
    padded at the front with size 1 and stride 0; raises past `axes`."""
    sizes, strides = [], []
    for n, s in zip(x.shape[1:-1], x.stride()[1:-1]):
        if n == 1:
            continue
        if sizes and strides[-1] == s * n:
            sizes[-1] *= n
            strides[-1] = s
        else:
            sizes.append(n)
            strides.append(s)
    if len(sizes) > axes:
        raise ValueError(f"{name}: lead axes {tuple(x.shape[1:-1])} with "
                         f"strides {tuple(x.stride()[1:-1])} are more than "
                         f"{axes} strided axes")
    pad = axes - len(sizes)
    return [1] * pad + sizes, [0] * pad + strides


def check_int(name: str, **counts):
    """Counts passed to a C entry as `int` must fit in 31 bits."""
    for what, n in counts.items():
        if not 0 <= n < 2 ** 31:
            raise ValueError(f"{name}: {what} = {n} does not fit a C int")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
