#!/usr/bin/env python3
"""Time and profile the GKR verifier of one or more checkouts, in turns,
on one card.

Usage, from the repository root, with each tree unpacked by git archive
into a directory that .gitignore lists:

    python3 scripts/verify_walk_profile.py DIR [DIR ...]

For each DIR, in the order given (name a tree twice to alternate, as
parent, change, change, parent), a process of its own imports that
tree's ``virgo_plus_tpu_torch`` and, at randomize(14, 13, seed=0), proves
once with ``driver.prove`` and ``driver.prove_fs`` (eager compiled
prover), then times (host walls, synchronised, 5 runs after a warm-up)
the eager ``driver.verify`` and ``driver.verify_fs`` with each run's
``last_split``, the eager GKR walk alone (``cp.verifier`` on the proof and
its challenges) and the staged graphed walk (``make_verifier``'s
replays), counts the port's launches of one eager walk, and profiles one
eager ``driver.verify``, one eager ``verify_fs`` and one eager walk with
torch.profiler (CUDA activity): device busy time, device records and the
device ms of each port entry.  It prints the card's name and power limit,
then one line a run."""

import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUNS = 5


def one(tree: str, label: str):
    """One tree's verify walls and profiles, printed as one line."""
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from virgo_plus_tpu_torch import driver, kernels
    from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
    from virgo_plus_tpu_torch.field import gf
    from virgo_plus_tpu_torch.gkr import protocol
    from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom
    if not Path(kernels.__file__).resolve().is_relative_to(
            Path(tree).resolve()):
        raise RuntimeError(f"{label}: imported {kernels.__file__}")
    kernels.build()
    dev = torch.device("cuda")
    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c, graphed=False)
    cc = cp.cc
    full, _ = driver.prove(c, cp)
    full_fs, _ = driver.prove_fs(c, cp)
    proof = protocol.Proof(
        vres=gf.tensor(full.vres, dev),
        layers=[None] + [driver._layer_proof_from(full.layers[i], dev)
                         for i in range(1, cc.depth)])
    ch = protocol.make_challenges(cc, GlibcRandom(3396), dev)
    graphed = protocol.make_verifier(cc, dev)

    def timed(fn, splits=None):
        out = []
        for k in range(RUNS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            if splits is not None and k:
                splits.append([round(x * 1e3, 3)
                               for x in cp.verifier.last_split])
        out = out[1:]
        return [round(statistics.median(out), 3), round(min(out), 3),
                round(max(out), 3)]

    res, splits = {}, {"verify": [], "verify_fs": []}
    for what, fn in (
            ("verify", lambda: driver.verify(c, full, cp)),
            ("verify_fs", lambda: driver.verify_fs(c, full_fs, cp))):
        if not fn().ok:
            raise RuntimeError(f"{label}: {what} rejects its proof")
        res[what] = timed(fn, splits[what])
    res["walk eager"] = timed(lambda: cp.verifier(proof, ch))
    res["walk graphed"] = timed(lambda: graphed(proof, ch))
    kernels.reset_counts()
    cp.verifier(proof, ch)
    walk = {e: n for e, n in kernels.LAUNCHES.items() if n}
    prof = {}
    for what, fn in (("verify", lambda: driver.verify(c, full, cp)),
                     ("verify_fs", lambda: driver.verify_fs(c, full_fs, cp)),
                     ("walk", lambda: cp.verifier(proof, ch))):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        by, busy, records = collections.defaultdict(float), 0.0, 0
        for e in p.events():
            if e.device_type.name != "CUDA" or e.device_time <= 0:
                continue
            key = next((k for k in kernels.ENTRIES if k in e.name), "other")
            by[key] += e.device_time / 1e3
            busy += e.device_time / 1e3
            records += 1
        prof[what] = dict(busy_ms=round(busy, 4), records=records,
                          by_entry={k: round(v, 4) for k, v in sorted(
                              by.items(), key=lambda kv: -kv[1])})
    print(f"{label}: walls ms [median, min, max] {res}; last_split ms "
          f"(fast, slow) by run {splits}; one eager walk's launches "
          f"{walk}; profiles {prof}", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1], args[2])
        return
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
        rc = subprocess.run([sys.executable, __file__, "--one", tree,
                             label]).returncode
        status = status or rc
    sys.exit(status)


if __name__ == "__main__":
    main()
