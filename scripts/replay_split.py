#!/usr/bin/env python3
"""Split the timed prove's replay wall on randomize(14, 13).

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/replay_split.py``.  It prints one line ``SPLIT {...}``
of host walls [median, min, max] in ms (30 runs, 10 for the eager calls,
each synchronised): the e2e graph alone (``fused.make_e2e_prover``), the
tape graph alone (``make_fg_tape``) on the numpy schedule, as
chip_smoke.py passes it, and on a schedule already on the card, both
together (as chip_smoke.py times them, 200 runs), and the eager
``fused.fg_tape`` and ``prove_e2e``; and each graph's replay alone
between CUDA events (device time, no copy-in or clone-out).  Then both
together again after two things chip_smoke.py does before it times the
replay: the tape on the CPU, and new e2e and tape graphs built (warm-up,
capture) while the tree's chip_smoke.py Recorder holds every kernel call
against its twin.  To compare
two trees unpacked by ``git archive`` in one chip call, run it from each
in turns: ``for d in PARENT CHANGE CHANGE PARENT; do (cd $d && python3
$ROOT/scripts/replay_split.py); done``."""

import statistics
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from virgo_plus_tpu_torch import driver, fused, graphs  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import input_buffer  # noqa: E402
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import protocol  # noqa: E402
from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402


def wall(fn, runs=30):
    fn()
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return [round(statistics.median(ts), 3), round(min(ts), 3),
            round(max(ts), 3)]


def event_ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / reps, 4)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c, graphed=False)
    cc = cp.cc
    dev = torch.device("cuda")
    n_folds = cc.layers[0].bit_length - virgo_pc.LOG_SLICE
    grng = GlibcRandom(3396)
    ch = protocol.make_challenges(cc, grng, dev)
    sched = fft_gkr.draw_schedule(n_folds, grng)
    fold_rands = []
    for _ in range(n_folds):
        r, i = grng.field_element()
        fold_rands.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                      dev).reshape(2))
    inputs = input_buffer(cc, None, dev)
    e2e = fused.make_e2e_prover(cc, cp.plans)
    tape = fused.make_fg_tape(n_folds)
    sched_dev = {k: (tuple(tuple(gf.tensor(x, dev) for x in s) for s in v)
                     if k == "stages" else gf.tensor(v, dev))
                 for k, v in sched.items()}
    both = lambda: (e2e(inputs, ch, fold_rands), tape(sched))
    out = {"e2e": wall(lambda: e2e(inputs, ch, fold_rands)),
           "tape numpy": wall(lambda: tape(sched)),
           "tape device": wall(lambda: tape(sched_dev)),
           "both": wall(both, 200)}
    held = graphs.holders(e2e) + graphs.holders(tape)
    out["holders"] = [h.name for h in held]
    out["e2e replay events"] = event_ms(held[0].replay)
    out["tape replay events"] = event_ms(held[1].replay)
    out["tape eager"] = wall(lambda: fused.fg_tape(n_folds, sched, dev), 10)
    out["e2e eager"] = wall(lambda: fused.prove_e2e(
        cc, cp.plans, inputs, ch, fold_rands, cp.arrs), 10)
    out["both again"] = wall(both, 200)
    fused.fg_tape(n_folds, sched, "cpu")
    out["both after the CPU tape"] = wall(both, 200)
    import chip_smoke
    kernels, wrappers, twin, _ = chip_smoke.kernel_tables()
    with chip_smoke.Recorder(kernels, wrappers, twin):
        e2e2 = fused.make_e2e_prover(cc, cp.plans)
        tape2 = fused.make_fg_tape(n_folds)
        e2e2(inputs, ch, fold_rands)
        tape2(sched)
    torch.cuda.synchronize()
    out["both after a recorded warm-up"] = wall(both, 200)
    out["new graphs after a recorded warm-up"] = wall(
        lambda: (e2e2(inputs, ch, fold_rands), tape2(sched)), 200)
    print("SPLIT", out, flush=True)


if __name__ == "__main__":
    main()
