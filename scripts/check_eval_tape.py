#!/usr/bin/env python3
"""A short first check of gf_eval_layer and fg_stage_tables on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_eval_tape.py``.  It prints the card's name and
power limit, builds every kernel source (printing ptxas' registers),
holds each entry against its plain twin at the paths' shapes (circuit
layers at (rows, gates) (1, 8192), (64, 8192), (3, 1000) and (1, 2); the
stage tables at lg = 1, 7 and 12, both phases, all stages and one),
randomize(14, 13)'s evaluation and ``mle_fold`` against the CPU's, the
fft_gkr tape at lg = 7 eager and through its graph against the CPU's
(with its launches and the graph's kernel nodes), and ``fft_gkr.run``
against the CPU's, then stops.  Any difference raises.  chip_smoke.py is
the full check; this one takes well under a minute."""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from virgo_plus_tpu_torch import fused, kernels  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import (  # noqa: E402
    compile_circuit, eval_arrays, evaluate, input_buffer)
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr.sumcheck import mle_fold  # noqa: E402
from virgo_plus_tpu_torch.pc import fft_gkr  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.time()
    for src, log in kernels.build().items():
        print("build", src, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln])
    print(f"built in {time.time() - t0:.1f} s")
    _, wrappers, twin, expected = cs.kernel_tables()
    cuda = {e: getattr(m, a) for e, (m, a) in wrappers.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def held(entry, ins, what):
        twin_ins = tuple(cs.kept(a) for a in ins)
        before = kernels.LAUNCHES[entry]
        got = cs.flatten(cuda[entry](*ins))
        launched = kernels.LAUNCHES[entry] - before
        want = cs.flatten(twin[entry](*twin_ins))
        torch.cuda.synchronize()
        err = cs.max_abs_err(torch, got, want)
        print(entry, what, "max_abs_err", err, "launches", launched)
        if err != 0.0 or launched != expected(entry, ins):
            raise RuntimeError(f"{entry} at {what}")

    for shp in ((1, 8192), (64, 8192), (3, 1000), (1, 2)):
        held("gf_eval_layer", cs.random_inputs(torch, np, gf, "gf_eval_layer",
                                               shp, dev, rng), shp)
    for lg in (1, 7, 12):
        for phase in (1, 2):
            for stages in sorted({lg, 1}):
                shp = (phase, stages, lg)
                held("fg_stage_tables", cs.random_inputs(
                    torch, np, gf, "fg_stage_tables", shp, dev, rng), shp)

    c = randomize(14, 13, seed=0)
    subset_init(c)
    cc = compile_circuit(c)
    card = evaluate(cc, input_buffer(cc, None, dev), eval_arrays(cc, dev))
    host = evaluate(cc, input_buffer(cc, None, "cpu"), eval_arrays(cc, "cpu"))
    if not torch.equal(card.cpu(), host):
        raise RuntimeError("randomize(14, 13)'s evaluation differs")
    rs = gf.tensor(rng.integers(0, gf.MOD, size=(2, 13), dtype=np.uint64),
                   dev)
    top = card[:, -8192:]
    if not torch.equal(mle_fold(top, rs).cpu(), mle_fold(top.cpu(),
                                                         rs.cpu())):
        raise RuntimeError("mle_fold differs")
    print("randomize(14, 13) evaluation and mle_fold == the CPU's")

    sched = fft_gkr.draw_schedule(7, GlibcRandom(5))
    kernels.reset_counts()
    eager = fused.fg_tape(7, sched, dev)
    torch.cuda.synchronize()
    print("tape launches", {k: v for k, v in kernels.LAUNCHES.items() if v})
    want = fused.fg_tape(7, sched, "cpu")
    tape = fused.make_fg_tape(7)
    tape(sched)
    replayed = tape(sched)
    for got in (eager, replayed):
        if len(got) != len(want) or not all(
                torch.equal(x.cpu(), y) for x, y in zip(got, want)):
            raise RuntimeError("the tape differs from the CPU's")
    holder = next(iter(tape.holders.values()))
    print(f"tape == the CPU's in all {len(want)} messages, eager and "
          f"replayed; the graph's kernel nodes "
          f"{dict(cs.graph_kernel_nodes(holder.graph))}")
    ran = fft_gkr.run(7, GlibcRandom(12), device=dev)
    ref = fft_gkr.run(7, GlibcRandom(12), device="cpu")
    if not ran.ok or not all(np.array_equal(x, y)
                             for x, y in zip(ran.messages, ref.messages)):
        raise RuntimeError("fft_gkr.run differs from the CPU's")
    print("fft_gkr.run == the CPU's; OK")


if __name__ == "__main__":
    main()
