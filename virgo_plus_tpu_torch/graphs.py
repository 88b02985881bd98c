"""Capture and replay of a function at one argument shape.

The JAX package runs its hot paths as a few ``jax.jit`` programs, each
compiled once per argument shape.  Here a CUDA graph plays that part:
``Graphed(fn, device, name)`` is a callable that keeps one ``Holder`` per
argument structure and shapes, as a jit retraces on a new shape (a new
batch size B, for example).  A holder owns static buffers for the
arguments.  Each call copies its arguments in, replays the graph, and
returns the outputs cloned out of the graph's pool, so that a later call
never overwrites a result already returned.

Arguments and results are pytrees: tensors, numpy arrays (uint64 arrays
become int64 tensors of the same bits, the port's field layout), lists,
tuples, dicts and dataclasses (``protocol.Challenges``, ``Proof``, the PC's
``Oracle``, ...).  Any other leaf is a constant, and joins the shape key.

Building a holder on the card:

* one eager call on the device's graph stream, which builds the kernels
  at first use, sets K1's shared-memory attribute, and makes K1's ticket
  words and the Merkle forest's tree tables for that stream, so that none
  is born inside the capture (both wrappers raise if one would be);
* the capture on that stream, in the default capture mode, then the
  instantiation.

Every holder of a device captures and replays on that one stream
(``graph_stream``), whatever the caller's current stream: the replay
waits for the caller's stream and the caller's stream waits for the
replay.  So the graphs that share K1's ticket words and the forest's
tables, which are keyed by the stream, never run at the same time, and
the port never launches an eager kernel on that stream.

The kernel wrappers count launches on the host (``kernels.launch``), so a
replay would count nothing.  The holder keeps the launches its capture
counted, takes them back off ``kernels.LAUNCHES`` (a capture runs nothing),
and adds them at every replay.  A capture that made a plain twin call
raises.  On the CPU there is no graph: the holder runs the function eagerly
on its static buffers, with the same copy-in and clone-out.  The maker's
device decides which path runs; a tensor argument on another device raises.
Nothing falls back: a capture or replay that fails raises.

A holder keeps its graph's memory pool as long as it lives, one per shape;
``release`` drops a maker's holders.  Makers that take ``graphed=False``
return the eager function instead, for a caller that proves once.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from . import kernels


# ---------------------------------------------------------------------------
# Pytrees
# ---------------------------------------------------------------------------

_LEAF = ("leaf",)


def _flatten(x, leaves: list):
    """Append x's array leaves to `leaves`; return its hashable structure."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        leaves.append(x)
        return _LEAF
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple(_flatten(v, leaves)
                                        for v in x.values()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return ("dataclass", type(x), names,
                tuple(_flatten(getattr(x, n), leaves) for n in names))
    return ("const", x)


def _unflatten(tree, leaves):
    """Inverse of _flatten: rebuild the structure from an iterator of
    leaves."""
    kind = tree[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "const":
        return tree[1]
    if kind in ("list", "tuple"):
        vals = [_unflatten(t, leaves) for t in tree[1]]
        return vals if kind == "list" else tuple(vals)
    if kind == "dict":
        return {k: _unflatten(t, leaves) for k, t in zip(tree[1], tree[2])}
    _, cls, names, subtrees = tree
    return cls(**{n: _unflatten(t, leaves) for n, t in zip(names, subtrees)})


def _as_tensor(a):
    """A numpy leaf as a CPU tensor; uint64 keeps its bits as int64."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)


def _spec(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return ("numpy", x.shape, x.dtype.str)


def clone(tree):
    """Every tensor of a pytree cloned; the rest as it is."""
    leaves = []
    structure = _flatten(tree, leaves)
    return _unflatten(structure, iter(
        x.clone() if isinstance(x, torch.Tensor) else x for x in leaves))


# ---------------------------------------------------------------------------
# Capture bookkeeping
# ---------------------------------------------------------------------------

class capture_counts:
    """The launch counters around a capture.  On exit, ``launches`` holds
    the launches the kernel wrappers counted inside, by entry, and they are
    taken back off ``kernels.LAUNCHES``: a capture runs nothing, its
    replays do.  A plain twin call inside raises."""

    def __init__(self, what: str):
        self.what = what
        self.launches = {}

    def __enter__(self):
        self._launches = dict(kernels.LAUNCHES)
        self._plain = dict(kernels.PLAIN_CALLS)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.launches = {e: kernels.LAUNCHES[e] - n
                         for e, n in self._launches.items()
                         if kernels.LAUNCHES[e] != n}
        kernels.LAUNCHES.update(self._launches)
        plain = {e: kernels.PLAIN_CALLS[e] - n
                 for e, n in self._plain.items()
                 if kernels.PLAIN_CALLS[e] != n}
        if plain and exc_type is None:
            raise RuntimeError(f"the capture of {self.what} made plain twin "
                               f"calls {plain}: a graph must launch only the "
                               f"kernels")
        return False


def _normal(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_STREAMS = {}   # device -> the stream its graphs capture and replay on


def graph_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream on which the graphs of `dev` are captured and
    replayed (and their warm-up calls run)."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


# ---------------------------------------------------------------------------
# Holders
# ---------------------------------------------------------------------------

class Holder:
    """fn at one argument structure and shapes: static argument buffers
    and, on the card, the captured graph and its outputs.

    Kept for the records: ``launches`` (by entry, per replay), ``replays``
    (calls; on the CPU each is an eager run on the buffers),
    ``warmup_s``, ``capture_s`` (capture plus instantiation) and
    ``pool_bytes`` (device memory the capture reserved), and ``graph``."""

    def __init__(self, fn, structure, leaves, device: torch.device,
                 name: str):
        self.fn = fn
        self.name = name
        self.device = device
        self.buffers = []
        for x in leaves:
            x = x if isinstance(x, torch.Tensor) else _as_tensor(x)
            self.buffers.append(torch.empty(x.shape, dtype=x.dtype,
                                            device=device))
        self.args = _unflatten(structure, iter(self.buffers))
        self.graph = None
        self.out = None
        self.launches = {}
        self.replays = 0
        self.warmup_s = self.capture_s = 0.0
        self.pool_bytes = 0
        if device.type == "cuda":
            self._copy_in(leaves)
            self._capture()

    def _copy_in(self, leaves):
        for buf, x in zip(self.buffers, leaves):
            if isinstance(x, torch.Tensor):
                if x.device != self.device:
                    raise ValueError(f"{self.name}: an argument on {x.device} "
                                     f"for a graph on {self.device}")
                buf.copy_(x)
            else:
                buf.copy_(_as_tensor(x))

    def _capture(self):
        dev = self.device
        s = graph_stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(s):
            self.fn(*self.args)
        s.synchronize()
        self.warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = _new_graph()
        t0 = time.perf_counter()
        with capture_counts(self.name) as counted:
            with torch.cuda.graph(graph, stream=s):
                out = self.fn(*self.args)
        if _keeps_graph():
            graph.instantiate()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.out, self.launches = graph, out, counted.launches

    def replay(self):
        """Replay the graph on its buffers as they are, on the graph
        stream, ordered after the caller's stream's work and before its
        later work; count the capture's launches."""
        cur = torch.cuda.current_stream(self.device)
        s = graph_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            self.graph.replay()
        cur.wait_stream(s)
        for entry, n in self.launches.items():
            kernels.LAUNCHES[entry] += n

    def __call__(self, leaves, clone_out: bool = True):
        self._copy_in(leaves)
        if self.graph is None:
            out = self.fn(*self.args)
        else:
            self.replay()
            out = self.out
        self.replays += 1
        return clone(out) if clone_out else out


@functools.lru_cache(maxsize=None)
def _keeps_graph() -> bool:
    """Whether this PyTorch can keep the cudaGraph_t after capture, so
    that its nodes can be read (chip_smoke.py counts the kernel nodes)."""
    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return False
    return True


def _new_graph():
    return (torch.cuda.CUDAGraph(keep_graph=True) if _keeps_graph()
            else torch.cuda.CUDAGraph())


class Graphed:
    """fn as a graph per argument shape, on `device`.  Call it as fn; use
    ``call(args, clone_out=False)`` to chain graphs: the outputs are then
    the holder's own, valid until its next call."""

    def __init__(self, fn, device, name: str):
        self.fn = fn
        self.device = _normal(device)
        self.name = name
        self.holders = {}

    def __call__(self, *args):
        return self.call(args)

    def call(self, args, clone_out: bool = True):
        leaves = []
        structure = _flatten(args, leaves)
        key = (structure, tuple(_spec(x) for x in leaves))
        holder = self.holders.get(key)
        if holder is None:
            holder = Holder(self.fn, structure, leaves, self.device,
                            f"{self.name} #{len(self.holders)}")
            self.holders[key] = holder
        return holder(leaves, clone_out)


def program(fn, device, name: str, graphed: bool = True):
    """fn as a Graphed on `device`, or fn itself (eager) for
    graphed=False."""
    return Graphed(fn, device, name) if graphed else fn


def _graphed(obj):
    """The Graphed objects of a maker's result: a Graphed, or a callable
    or dict that carries them (``.graphs``, or dict values)."""
    if isinstance(obj, Graphed):
        return [obj]
    parts = (obj.values() if isinstance(obj, dict)
             else getattr(obj, "graphs", ()))
    return [g for g in parts if isinstance(g, Graphed)]


def holders(obj):
    """Every holder of a maker's result."""
    return [h for g in _graphed(obj) for h in g.holders.values()]


def release(obj):
    """Drop every holder of a maker's result, so that their graphs' pools
    go back to PyTorch's allocator; a later call captures anew.  Results
    already returned stay valid (they are clones)."""
    for g in _graphed(obj):
        g.holders.clear()
