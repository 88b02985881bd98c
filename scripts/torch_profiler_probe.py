#!/usr/bin/env python3
"""Does a large torch.profiler trace make later short profiles in the same
process miss kernel launches?

Run from the repository root on a CUDA card: ``python3
scripts/torch_profiler_probe.py``.  It profiles 20 calls of the port's K1
(sumcheck fold) at (bl, K) = (7, 1), then a trace of 120k small PyTorch
kernels, K1 again (CPU + CUDA activity, then CUDA only), a trace of 400k
more, and K1 again (also with ``acc_events=True``).  Each K1 line prints
the launches the profiler counted (20 when nothing was missed) and their
device time in microseconds.  Each large trace prints its launches and the
seconds it took, digesting included.  chip_smoke.py orders its profiles by
what this shows.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from virgo_plus_tpu_torch import kernels  # noqa: E402
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import sumcheck  # noqa: E402

BOTH = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def k1_profile(fold, label, activities, **kw):
    fold()
    torch.cuda.synchronize()
    with profile(activities=activities, **kw) as prof:
        for _ in range(20):
            fold()
        torch.cuda.synchronize()
    rows = [(e.count, getattr(e, "self_device_time_total", 0))
            for e in prof.key_averages() if "sumcheck_fold" in e.key]
    counted = sum(n for n, _ in rows)
    print(f"{label}: {counted} of 20 K1 launches counted, device us "
          f"{sum(us for _, us in rows):.1f}", flush=True)


def large_trace(n, dev):
    x = torch.zeros(1024, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    with profile(activities=BOTH) as prof:
        for _ in range(n):
            x = x + 1
        torch.cuda.synchronize()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if "CUDA" in str(e.device_type))
    print(f"large trace of {n} adds: {launches} device launches counted, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("this probe needs a CUDA card")
    kernels.build(["sumcheck_fold"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    tables = [gf.tensor(rng.integers(0, gf.MOD, size=(2, 1, 128),
                                     dtype=np.uint64), dev)
              for _ in range(3)]
    rs = gf.tensor(rng.integers(0, gf.MOD, size=(2, 1, 7), dtype=np.uint64),
                   dev)

    def fold():
        return sumcheck.fold_cuda(*tables, rs)

    k1_profile(fold, "K1 before any large trace", BOTH)
    large_trace(120_000, dev)
    k1_profile(fold, "K1 after 120k", BOTH)
    k1_profile(fold, "K1 after 120k, CUDA only", [ProfilerActivity.CUDA])
    large_trace(400_000, dev)
    k1_profile(fold, "K1 after 520k", BOTH)
    k1_profile(fold, "K1 after 520k, CUDA only", [ProfilerActivity.CUDA])
    k1_profile(fold, "K1 after 520k, acc_events", BOTH, acc_events=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
