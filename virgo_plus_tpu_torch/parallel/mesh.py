"""Ranks of a sharded prove: one process per rank under torch.distributed.

Counterpart of building a ``jax.sharding.Mesh`` of shape (dp, sp)
(``virgo_plus_tpu/driver.py:419-425``).  The JAX package runs every shard
of a mesh from one process; here each rank is a process of its own, on its
own device, and holds only its own shard.  Rank r sits at (dp_rank, sp_rank)
= (r // sp, r % sp): the sp ranks of one dp row shard one proof, the dp
ranks of one sp column split a batch of witnesses.

The backend is chosen once, by one rule, and kept on the ``Mesh``: ``nccl``
when every rank has a card of its own, ``gloo`` when ranks share a device or
run on the CPU.  Nothing retries with another backend.

Every collective is one int64 SUM ``all_reduce``, which gloo takes on CPU
and CUDA tensors alike and NCCL takes too.  int64 addition wraps modulo 2^64
with the bits of u64 addition, so

* ``field_sum`` adds canonical field elements over the ranks as raw u64
  lanes and folds the lazy sum back with ``gf.reduce_lazy``, exact for at
  most 8 ranks (8 terms below 2^61 stay below 2^64; ROADMAP F1);
* ``all_gather`` is the sum of zero buffers in which each rank fills its
  own slot: every entry has one writer, so the sum is that entry's bits.

``spawn`` starts the dp·sp ranks from one process; inside a process group
that is already initialised (``torchrun``), ``Mesh.create`` makes the mesh
in place.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from .. import device as _device
from .. import kernels
from ..field import gf

TIMEOUT_S = 900      # rendezvous, collectives and the whole spawned run
MAX_FIELD_SUM_RANKS = 8


def rank_device(rank: int, device=None) -> torch.device:
    """The device of `rank`: ``cuda:{rank % device_count}`` for ``None`` or
    ``"cuda"``, else `device` as given (``"cpu"``, ``"cuda:0"``).  Raises
    without CUDA unless the CPU is asked for."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def backend_for(world: int, device=None) -> str:
    """``nccl`` when each of the `world` ranks gets a card of its own,
    ``gloo`` when they share one device or run on the CPU."""
    dev = _device.resolve(device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


@dataclass
class Mesh:
    """This rank's view of a (dp, sp) mesh: its coordinates, device and
    backend, and the process group of each axis (None for an axis of size
    one)."""
    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: str
    groups: dict

    @staticmethod
    def create(dp: int, sp: int, device=None) -> "Mesh":
        """The mesh of this process inside an initialised process group of
        dp·sp ranks.  Every rank must call it: it makes the axis groups."""
        world = dist.get_world_size()
        if world != dp * sp:
            raise ValueError(f"mesh ({dp}, {sp}) needs {dp * sp} ranks, the "
                             f"process group has {world}")
        if sp & (sp - 1):
            raise ValueError(f"sp = {sp} is not a power of two")
        rank = dist.get_rank()
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        groups = {}
        for axis, members in (
                ("sp", [[d * sp + s for s in range(sp)] for d in range(dp)]),
                ("dp", [[d * sp + s for d in range(dp)] for s in range(sp)])):
            if len(members[0]) == world:
                groups[axis] = dist.group.WORLD
                continue
            groups[axis] = None
            for ranks in members:        # every rank makes every group
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[axis] = g
        return Mesh(dp=dp, sp=sp, rank=rank, device=dev,
                    backend=dist.get_backend(), groups=groups)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    def size(self, axis: str) -> int:
        return self.sp if axis == "sp" else self.dp

    def index(self, axis: str) -> int:
        return self.sp_rank if axis == "sp" else self.dp_rank

    def all_sum(self, x, axis: str = "sp"):
        """int64 sum over the ranks of `axis`, wrapping modulo 2^64."""
        out = x.contiguous().clone()
        if self.size(axis) > 1:
            dist.all_reduce(out, group=self.groups[axis])
        return out

    def field_sum(self, x, axis: str = "sp"):
        """Field sum of canonical elements over the ranks of `axis`."""
        if self.size(axis) > MAX_FIELD_SUM_RANKS:
            raise ValueError(
                f"a lazy field sum over {self.size(axis)} ranks can pass "
                f"2^64; at most {MAX_FIELD_SUM_RANKS} are supported")
        return gf.reduce_lazy(self.all_sum(x, axis))

    def all_gather(self, x, axis: str = "sp"):
        """(n, *x.shape): rank k of `axis` contributes row k."""
        buf = torch.zeros((self.size(axis),) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
        buf[self.index(axis)] = x
        return self.all_sum(buf, axis)


def _rank_main(rank, dp, sp, device, backend, store_path, timeout, entry,
               args, results):
    """One rank: join the group through the file store, make the mesh, run
    entry(mesh, *args) and report its result (or traceback) to the parent."""
    try:
        world = dp * sp
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=timeout))
        try:
            out = entry(Mesh.create(dp, sp, device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(entry, dp: int, sp: int, device=None, args=(),
          timeout: float = TIMEOUT_S):
    """Run entry(mesh, *args) on dp·sp new ranks and return their results
    in rank order.  `entry` is a module-level function (it is pickled by
    name); so are `args` and each rank's result.

    Ranks start with the ``spawn`` method (the caller may hold threads, as
    JAX does) and rendezvous through a ``FileStore`` in a temporary
    directory, so concurrent runs never contend for a port.  On the card,
    the kernels are built here first, so the ranks only load them.  A rank
    that raises, dies or outlives `timeout` fails the whole run: the other
    ranks are killed and the error is raised here."""
    world = dp * sp
    dev = _device.resolve(device)
    backend = backend_for(world, device)
    if dev.type == "cuda":
        kernels.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="vpt_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, dp, sp, device, backend, store, timeout, entry, args, results))
            for r in range(world)]
        for p in procs:
            p.start()
        done, failed = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks did not finish in "
                                       f"{timeout} s ({len(done)} did)")
                try:
                    r, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]} without a "
                            f"result")
                    continue
                (done if ok else failed)[r] = out
        finally:
            for p in procs:
                p.join(timeout=10 if len(done) == world else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    if failed:
        r = min(failed)
        raise RuntimeError(f"rank {r} of {world} ({backend}) failed:\n"
                           f"{failed[r]}")
    return [done[r] for r in range(world)]
