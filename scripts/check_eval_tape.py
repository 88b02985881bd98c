#!/usr/bin/env python3
"""A short first check of gf_eval_layer, fg_stage_tables, fg_build_circuit
and pc_virtual_oracle on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_eval_tape.py``.  It prints the card's name and
power limit, builds every kernel source (printing ptxas' registers),
holds each entry against its plain twin at the paths' shapes (circuit
layers at (rows, gates) (1, 8192), (64, 8192), (3, 1000) and (1, 2); the
stage tables at lg = 1, 7 and 12, both phases, all stages and one; the
fft_gkr circuit and the virtual oracle at chip_smoke.py's fixed shapes),
randomize(14, 13)'s evaluation and ``mle_fold`` against the CPU's, the
fft_gkr tape at lg = 7 eager and through its graph against the CPU's
(with its launches and the graph's kernel nodes), ``fft_gkr.run``
against the CPU's, and the public commit at bl = 13 (one codeword and a
batch of 4, eager and through a graph) against the CPU's, then stops.
With arguments, ``python3 scripts/check_eval_tape.py NAME=VALUE,...
...``, it then times ``fg_build_circuit`` (device time from torch.profiler
over 20 calls after a warm-up) at lg = 5 to 13 for the source as it is
and for each argument, a variant of ``csrc/fft_gkr.cu`` with the named
``constexpr int`` constants set (``BUILD_THREADS``, ``ONE_LAUNCH_LOG``,
``SHARED_TW_LOG``, ``CHUNK_LOG``), built into
``build/fft_gkr_variants/``, each call held against the twin, in turns.  Any difference raises.  chip_smoke.py is
the full check; this one takes well under a minute."""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from virgo_plus_tpu_torch import fused, graphs, kernels  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import (  # noqa: E402
    compile_circuit, eval_arrays, evaluate, input_buffer)
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr.sumcheck import mle_fold  # noqa: E402
from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402


VARIANTS = ROOT / "build" / "fft_gkr_variants"
TIMED_LGS = range(5, 14)
REPS = 20


def build_variants(specs):
    """{spec: (the variant's fg_build_circuit, its ONE_LAUNCH_LOG and
    CHUNK_LOG)}, one nvcc a variant, all started together."""
    src = (kernels.CSRC / "fft_gkr.cu").read_text()
    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, spec in enumerate(specs):
        text, consts = src, {}
        for item in spec.split(","):
            const, value = item.split("=")
            text, found = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
            if not found:
                raise ValueError(f"no constant {const} in csrc/fft_gkr.cu")
            consts[const] = int(value)
        cu, so = VARIANTS / f"fft_gkr_v{k}.cu", VARIANTS / f"libfft_gkr_v{k}.so"
        cu.write_text(text)
        cmd = kernels._command("fft_gkr", so)
        cmd[cmd.index(str(kernels.CSRC / "fft_gkr.cu"))] = str(cu)
        cmd[1:1] = ["-I", str(kernels.CSRC)]
        procs[spec] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, (consts.get("ONE_LAUNCH_LOG",
                                       fft_gkr.ONE_LAUNCH_LOG),
                            consts.get("CHUNK_LOG", fft_gkr.CHUNK_LOG)))
    out = {}
    for spec, (proc, so, logs) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        print("variant", spec, [ln.split(":")[-1].strip()
                                for ln in log.splitlines() if "registers" in ln])
        symbol, argtypes = kernels.SOURCES["fft_gkr"]["fg_build_circuit"]
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[spec] = (fn, logs)
    return out


def build_us(lg, ins, launches):
    """fg_build_circuit's device time (us) a call, from the profiler over
    REPS calls; None if it missed a launch."""
    from torch.profiler import ProfilerActivity, profile
    fft_gkr.build_circuit_cuda(*ins)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fft_gkr.build_circuit_cuda(*ins)
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        if cs.is_device_row(e) and "fg_build_" in e.key:
            us += cs.device_us(e)
            count += e.count
    return us / REPS if count == REPS * launches else None


def time_variants(specs, dev, rng):
    """Each variant and the source, in turns, at every lg of TIMED_LGS:
    held against the twin, then timed (the wrapper's ONE_LAUNCH_LOG and
    CHUNK_LOG set to the variant's, which size its launches and scratch)."""
    logs = (fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG)
    variants = {"source": (kernels.lib("fg_build_circuit"), logs)}
    variants.update(build_variants(specs))
    rows = {spec: [] for spec in variants}
    try:
        for lg in TIMED_LGS:
            ins = cs.random_inputs(torch, np, gf, "fg_build_circuit", (lg,),
                                   dev, rng)
            want = cs.flatten(fft_gkr.build_circuit_plain(*ins))
            for spec, (fn, v_logs) in variants.items():
                kernels._FNS["fg_build_circuit"] = fn
                fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG = v_logs
                try:
                    got = fft_gkr.build_circuit_cuda(*ins)
                except RuntimeError as e:   # a variant the card refuses
                    rows[spec].append(f"{lg}: refused ({e})")
                    continue
                if cs.max_abs_err(torch, cs.flatten(got), want) != 0.0:
                    raise RuntimeError(f"variant {spec} differs at lg {lg}")
                us = build_us(lg, ins, fft_gkr.circuit_launches(lg))
                rows[spec].append(f"{lg}: {us:.2f}" if us else f"{lg}: -")
    finally:
        kernels._FNS["fg_build_circuit"] = variants["source"][0]
        fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG = logs
    for spec, row in rows.items():
        print(f"fg_build_circuit {spec}: us a call by lg {'; '.join(row)}")


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

    for entry in ("fg_build_circuit", "pc_virtual_oracle"):
        for shp in cs.FIXED_SHAPES[entry]:
            held(entry, cs.random_inputs(torch, np, gf, entry, shp, dev, rng),
                 shp)

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
    print("fft_gkr.run == the CPU's")
    bl = 13
    q = rng.integers(0, gf.MOD, size=(2, 1 << bl), dtype=np.uint64)
    pub = graphs.Graphed(lambda l, q: virgo_pc.commit_public_eval(l, q, bl),
                         dev, "public_commit")
    for lead in ((), (4,)):
        l_eval = rng.integers(0, gf.MOD, size=(2, *lead, 65, 1 << (bl - 1)),
                              dtype=np.uint64)
        want = virgo_pc.commit_public_eval(gf.tensor(l_eval),
                                           gf.tensor(q), bl)
        kernels.reset_counts()
        eager = virgo_pc.commit_public_eval(gf.tensor(l_eval, dev),
                                            gf.tensor(q, dev), bl)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        pub(gf.tensor(l_eval, dev), gf.tensor(q, dev))
        replayed = pub(gf.tensor(l_eval, dev), gf.tensor(q, dev))
        for got in (eager, replayed):
            if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
                raise RuntimeError(f"the public commit (lead {lead}) differs "
                                   f"from the CPU's")
        holder = [h for h in pub.holders.values()][-1]
        print(f"public commit, lead {lead}: == the CPU's eager and replayed; "
              f"launches {launches}; the graph's kernel nodes "
              f"{dict(cs.graph_kernel_nodes(holder.graph))}")
    if sys.argv[1:]:
        time_variants(sys.argv[1:], dev, rng)
    print("OK")


if __name__ == "__main__":
    main()
