"""ctypes bindings for the native C++ circuit frontend.

Counterpart of ``virgo_plus_tpu/native/__init__.py``.  ``frontend.cpp`` (a
copy of the JAX package's) is compiled with ``g++ -std=c++17 -O2`` at first
use into ``build/native/lib<name>-<source hash>.so`` of the checkout, keyed
the way ``kernels`` keys the CUDA sources, so an edited source is rebuilt.
``load_circuit(path, bug_compat)`` returns the same ``LayeredCircuit`` as
the Python frontend (``circuits/pws.py`` + ``circuits/layered.py``), many
times faster on large ``.pws`` files.  ``available()`` is false only when no
C++ compiler is found; a failed build or a parse error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

NAME = "vptfrontend"
SRC = Path(__file__).resolve().parent / "frontend.cpp"
BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "native"

_lib = None


def _compiler():
    """The C++ compiler: $CXX if set, else g++; None when neither is found."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _target() -> Path:
    h = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{NAME}-{h}.so"


def _build(out: Path) -> None:
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("native frontend: no C++ compiler found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, "-std=c++17", "-O2", "-fPIC", "-shared", str(SRC), "-o",
           str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native frontend: {' '.join(cmd)} failed:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    out = _target()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    lib.vpt_build.restype = ctypes.c_void_p
    lib.vpt_build.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.vpt_error.restype = ctypes.c_char_p
    lib.vpt_error.argtypes = [ctypes.c_void_p]
    P = ctypes.c_void_p
    I64 = ctypes.c_int64
    for name, res, args in (
            ("vpt_depth", ctypes.c_int64, [P]),
            ("vpt_layer_size", ctypes.c_int64, [P, I64]),
            ("vpt_layer_bl", ctypes.c_int32, [P, I64]),
            ("vpt_layer_max_dad_bl", ctypes.c_int32, [P, I64]),
            ("vpt_layer_max_dad_size", ctypes.c_int64, [P, I64])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    lib.vpt_layer_gates.restype = None
    lib.vpt_layer_gates.argtypes = [P, I64, P, P, P, P, P, P]
    lib.vpt_dad_sizes.restype = None
    lib.vpt_dad_sizes.argtypes = [P, I64, P, P]
    lib.vpt_dad_ids.restype = None
    lib.vpt_dad_ids.argtypes = [P, I64, I64, P]
    lib.vpt_inputs.restype = None
    lib.vpt_inputs.argtypes = [P, P]
    lib.vpt_free.restype = None
    lib.vpt_free.argtypes = [P]
    _lib = lib
    return lib


def available() -> bool:
    """True when the library is built or a C++ compiler can build it."""
    return _lib is not None or _target().exists() or _compiler() is not None


def load_circuit(path: str, bug_compat: bool = True):
    """Parse + layer + subsets natively; returns a LayeredCircuit whose
    input values are the reference's glibc-stream witness, as the Python
    frontend's."""
    from ..circuits.layered import Layer, LayeredCircuit, _SENTINEL_EMPTY

    lib = _load()
    h = lib.vpt_build(str(path).encode(), int(bug_compat), 1)
    try:
        err = lib.vpt_error(h)
        if err:
            raise ValueError(f"native frontend: {err.decode()}")
        depth = lib.vpt_depth(h)
        layers = []
        for i in range(depth):
            size = lib.vpt_layer_size(h, i)
            ty = np.zeros(size, np.int32)
            u = np.zeros(size, np.int64)
            v = np.zeros(size, np.int64)
            lv = np.zeros(size, np.int64)
            l = np.zeros(size, np.int32)
            c_real = np.zeros(size, np.uint64)
            lib.vpt_layer_gates(h, i, ty.ctypes.data, u.ctypes.data,
                                v.ctypes.data, lv.ctypes.data,
                                l.ctypes.data, c_real.ctypes.data)
            L = Layer(ty=ty, u=u, v=v, l=l, lv=lv, c_real=c_real,
                      c_img=np.zeros(size, np.uint64),
                      is_assert=np.zeros(size, bool), size=int(size),
                      bit_length=int(lib.vpt_layer_bl(h, i)))
            if i > 0:
                sizes = np.zeros(i, np.int64)
                bls = np.zeros(i, np.int64)
                lib.vpt_dad_sizes(h, i, sizes.ctypes.data, bls.ctypes.data)
                L.dad_size = [int(x) for x in sizes]
                L.dad_bit_length = [
                    int(b) if s > 0 else _SENTINEL_EMPTY
                    for b, s in zip(bls, sizes)]
                L.dad_id = []
                for li in range(i):
                    ids = np.zeros(int(sizes[li]), np.int64)
                    if sizes[li] > 0:
                        lib.vpt_dad_ids(h, i, li, ids.ctypes.data)
                    L.dad_id.append(ids)
                L.max_dad_size = int(lib.vpt_layer_max_dad_size(h, i))
                L.max_dad_bit_length = int(lib.vpt_layer_max_dad_bl(h, i))
            layers.append(L)
        input_vals = np.zeros((2, layers[0].size), np.uint64)
        lib.vpt_inputs(h, input_vals[0].ctypes.data)
        return LayeredCircuit(layers=layers, input_values=input_vals)
    finally:
        lib.vpt_free(h)
