#!/usr/bin/env python3
"""What chip_smoke.py does not check of fs_sumcheck, on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_fs.py`` (~2 min).  It prints the card's name and
power limit, builds ``csrc/fs_rounds.cu`` (printing ptxas' registers and
spills), and reads its SASS (``cuobjdump -sass``): each kernel's
instruction count, and every memory fence, cache invalidation, cluster
barrier and mbarrier instruction of ``fs_sumcheck_kernel`` with its
offset, failing if a memory fence or cache invalidation (MEMBAR.ALL.GPU,
CCTL.IVALL) follows the first mbarrier arrive or wait: the rounds may
hold none; the head (the mbarriers' init, the start's cluster barrier)
precedes them.  Then a sweep: chip_smoke.py's larger fixed FS sumcheck
shapes (from (13, 1) on, ``FS_ROUTE_SHAPES`` included) on clusters of
1, 2, 4, 8 and 16 blocks (the wrapper's cluster choice overridden), each
held against the plain twin and timed by torch.profiler (chip_smoke.py's
``profiled_ms``), with its route and J; a cluster that no plan or route
takes is printed as such.  Any difference raises."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from virgo_plus_tpu_torch import kernels  # noqa: E402
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import fs  # noqa: E402

REPS = 20


def sass_check():
    """Instruction counts of fs_rounds.cu's kernels and fs_sumcheck's
    fences, invalidations, cluster barriers and mbarrier instructions."""
    lib = kernels._target("fs_rounds")
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    bad = []
    for name, ins in funcs.items():
        print(f"SASS {name}: {len(ins)} instructions", flush=True)
        if "fs_sumcheck_kernel" not in name:
            continue
        marks = [(o, i) for o, i in ins
                 if re.search(r"MEMBAR|CCTL|UCGABAR|SYNCS|ERRBAR|FENCE", i)]
        # the rounds start at the first mbarrier arrive or wait; before
        # them, the mbarriers' init and the one cluster barrier
        first = min(o for o, i in marks if "TRANS64" in i)
        head = [i for o, i in marks if o < first]
        rounds = [i for o, i in marks if o >= first]
        print(f"  head (before {first:#06x}): {head}", flush=True)
        print(f"  rounds (from {first:#06x}): {rounds}", flush=True)
        bad += [i for i in rounds if "MEMBAR" in i or "CCTL" in i]
    if bad:
        raise RuntimeError(f"fs_sumcheck_kernel holds {bad}")


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    log = kernels.build(["fs_rounds"])["fs_rounds"]
    print("build: " + "; ".join(ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln
                                or "Compiling" in ln), flush=True)
    sass_check()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20)

    # the FS sumchecks at every cluster size their plan takes
    orig = fs.sumcheck_cluster
    for shp in cs.FIXED_SHAPES["fs_sumcheck"][3:]:
        ins = cs.random_inputs(torch, np, gf, "fs_sumcheck", shp, dev, rng)
        want = cs.flatten(fs.fs_sumcheck_plain(*ins))
        mdb, bls = shp[:2]
        for C in (1, 2, 4, 8, 16):
            label = f"sweep {mdb, len(bls)} C {C}"
            if C == orig(ins[0]):
                label += " (the wrapper's)"
            try:
                plan, route = fs.sumcheck_route(bls, mdb, C)
            except ValueError as e:
                print(f"{label}: {e}", flush=True)
                continue
            fs.sumcheck_cluster = lambda t, C=C: C
            try:
                got = cs.flatten(fs.fs_sumcheck_cuda(*ins))
                if cs.max_abs_err(torch, got, want) != 0.0:
                    raise AssertionError(f"{label} differs from the twin")
                ms = cs.profiled_ms(torch, lambda: fs.fs_sumcheck_cuda(*ins),
                                    REPS, ("fs_sumcheck_kernel",), 1)
                if ms is None:
                    raise RuntimeError(f"{label}: the profiler missed it")
            finally:
                fs.sumcheck_cluster = orig
            print(f"{label}: route {route}, J {plan.J}: {ms * 1e3:.2f} us",
                  flush=True)
    print("check_fs ok", flush=True)


if __name__ == "__main__":
    main()
