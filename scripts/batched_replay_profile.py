#!/usr/bin/env python3
"""Profile the batched prover's graph replay of one or more checkouts, in
turns, on one card.

Usage, from the repository root, with each tree unpacked by git archive
into a directory that .gitignore lists:

    python3 scripts/batched_replay_profile.py [--batch B] DIR [DIR ...]

For each DIR, in the order given (name a tree twice to alternate, as
parent, change, change, parent), a process of its own imports that
tree's ``virgo_plus_tpu_torch`` and, at randomize(14, 13, seed=0) with B
witnesses (chip_smoke.py phase 10's: the inputs plus default_rng(7)
integers in [0, 5) on the real plane; B = 64 by default), builds
``make_batched_full_prover``'s graph, times 8 replays after 3 warm-up
calls (host walls, synchronised) and profiles one replay with
torch.profiler (CUDA activity): its device busy time, its device records
and the device ms of each port entry (and of the largest other kernels).
It prints the card's name and power limit, then one line a run."""

import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

WALL_RUNS, WARM_UP = 8, 3


def one(tree: str, label: str, batch: int):
    """One tree's replay walls and profile, printed as one line."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from virgo_plus_tpu_torch import driver, kernels
    from virgo_plus_tpu_torch.circuits.compile import input_buffer
    from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
    from virgo_plus_tpu_torch.field import gf
    from virgo_plus_tpu_torch.gkr import protocol
    from virgo_plus_tpu_torch.parallel.sharded import (
        make_batched_full_prover)
    from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc
    from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom
    if not Path(kernels.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        raise RuntimeError(f"{label}: imported {kernels.__file__}")
    dev = torch.device("cuda")
    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c, graphed=False)
    cc = cp.cc
    bl0 = cc.layers[0].bit_length
    n_folds = bl0 - virgo_pc.LOG_SLICE
    grng = GlibcRandom(3396)
    ch = protocol.make_challenges(cc, grng, dev)
    fft_gkr.draw_schedule(n_folds, grng)
    fold_rands = []
    for _ in range(n_folds):
        r, i = grng.field_element()
        fold_rands.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                      dev).reshape(2))
    final_point = ch.layers[1].r_liu[:, :bl0]
    xs = np.stack([gf.to_numpy(input_buffer(cc, None, dev))] * batch)
    xs[:, 0, :] = (xs[:, 0, :] + np.random.default_rng(7).integers(
        0, 5, xs[:, 0, :].shape, dtype=np.uint64)) % np.uint64(gf.MOD)
    run = make_batched_full_prover(cc, cp.plans)

    def call():
        run(xs, ch, final_point, fold_rands)
        torch.cuda.synchronize()

    for _ in range(WARM_UP):
        call()
    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
    by, busy, records = collections.defaultdict(float), 0.0, 0
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.device_time <= 0:
            continue
        key = next((k for k in kernels.ENTRIES if k in e.name),
                   "other: " + e.name[:40])
        by[key] += e.device_time / 1e3
        busy += e.device_time / 1e3
        records += 1
    top = sorted(by.items(), key=lambda kv: -kv[1])[:14]
    print(f"{label}: B = {batch} replay walls ms median "
          f"{statistics.median(walls):.3f} min {min(walls):.3f} max "
          f"{max(walls):.3f} {[round(w, 3) for w in walls]}; profiled busy "
          f"{busy:.3f} ms in {records} device records; device ms by entry "
          f"{[(k, round(v, 4)) for k, v in top]}", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1], args[2], int(args[3]))
        return
    batch = 64
    if args[:1] == ["--batch"]:
        batch, args = int(args[1]), args[2:]
    if not args:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    seen = collections.Counter()
    status = 0
    for tree in args:
        seen[tree] += 1
        label = f"{Path(tree).name} {seen[tree]}"
        rc = subprocess.run([sys.executable, __file__, "--one", tree, label,
                             str(batch)]).returncode
        status = status or rc
    sys.exit(status)


if __name__ == "__main__":
    main()
