#!/usr/bin/env python3
"""A short first check of gf_evaluate, gf_segsum, fg_stage_tables,
fg_build_circuit and pc_virtual_oracle on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_eval_tape.py``.  It prints the card's name and
power limit, builds every kernel source (printing ptxas' registers),
holds each entry against its plain twin at the paths' shapes (whole
evaluations of random layers at (rows, gates, layers) (1, 8192, 13),
(64, 8192, 13), (3, 1000, 3) and (1, 2, 2), and of a layer of 2^18
gates, with their launches; (2, N) segment sums at N = 2^10 to 2^20,
one block and clusters of 2 to 8 an output; the
stage tables at lg = 1, 7 and 12, both phases, all stages and one; the
fft_gkr circuit and the virtual oracle at chip_smoke.py's fixed shapes),
randomize(14, 13)'s evaluation (eager and through ``make_evaluator``'s
graph, with its kernel nodes) and ``mle_fold`` against the CPU's, the
fft_gkr tape at lg = 7 eager and through its graph against the CPU's
(with its launches and the graph's kernel nodes), ``fft_gkr.run``
against the CPU's, and the public commit at bl = 13 (one codeword and a
batch of 4, eager and through a graph) against the CPU's; then it times
gf_evaluate at randomize(14, 13)'s shape at 1, 4, 16 and 64 rows and
the sums at 2^13 and 2^14 (device time from torch.profiler) beside their
bounds, and stops.
An argument ``eval:NAME=VALUE,...`` times ``gf_evaluate`` at
randomize(14, 13)'s shape at 1, 4, 16 and 64 rows for the source and for
a variant of ``csrc/circuit_eval.cu`` with the named ``constexpr int``
constants set (``THREADS``, ``CLUSTER``), built into ``build/circuit_eval_variants/``, each call
held against the twin, in turns.  Other arguments, ``NAME=VALUE,...``,
time ``fg_build_circuit`` (device time from torch.profiler
over 20 calls after a warm-up, and CUDA events over 50 back-to-back
calls of the C entry) at lg = 0 to 13 for the source as it is
and for each argument, a variant of ``csrc/fft_gkr.cu`` with the named
``constexpr int`` constants set (``BUILD_THREADS``, ``WARP_LOG``, ``ONE_LAUNCH_LOG``,
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
from virgo_plus_tpu_torch.circuits import compile as comp  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import (  # noqa: E402
    compile_circuit, eval_arrays, evaluate, input_buffer)
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import chains, gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import protocol  # noqa: E402
from virgo_plus_tpu_torch.gkr.sumcheck import mle_fold  # noqa: E402
from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402


EVAL_SHAPES = [(b, 8192, 13) for b in (1, 4, 16, 64)]
TIMED_LGS = range(0, 14)
REPS = 20


def build_variants(source, specs):
    """{spec: (the variant's library, its constants)}: csrc/<source>.cu
    with each spec's named constexpr int constants set, built into
    build/<source>_variants/, one nvcc a variant, all started together."""
    src = (kernels.CSRC / f"{source}.cu").read_text()
    where = ROOT / "build" / f"{source}_variants"
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, spec in enumerate(specs):
        text, consts = src, {}
        for item in spec.split(","):
            const, value = item.split("=")
            text, found = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
            if not found:
                raise ValueError(f"no constant {const} in csrc/{source}.cu")
            consts[const] = int(value)
        cu, so = where / f"{source}_v{k}.cu", where / f"lib{source}_v{k}.so"
        cu.write_text(text)
        cmd = kernels._command(source, so)
        cmd[cmd.index(str(kernels.CSRC / f"{source}.cu"))] = str(cu)
        cmd[1:1] = ["-I", str(kernels.CSRC)]
        procs[spec] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, consts)
    out = {}
    for spec, (proc, so, consts) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:     # a variant the compiler refuses: skipped
            print(f"variant {spec}: nvcc failed, skipped:\n{log}")
            continue
        print("variant", spec, [ln.split(":")[-1].strip()
                                for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln])
        out[spec] = (ctypes.CDLL(str(so)), consts)
    return out


def entry_of(lib, source, entry):
    """The C function of `entry` in a variant's library."""
    symbol, argtypes = kernels.SOURCES[source][entry]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def time_eval_variants(specs, dev, rng):
    """gf_evaluate's source and each variant, in turns, at EVAL_SHAPES:
    held against the twin, then timed by the profiler ("-" when every try
    missed a launch) and by CUDA events around REPS calls (a call's host
    issue when that is longer), with the wrapper's launch constants and
    cluster query set to the variant's."""
    names = ("THREADS", "CLUSTER")
    saved = ({n: getattr(comp, f"EVAL_{n}") for n in names},
             comp._fits, kernels._FNS.get("gf_evaluate"))
    variants = {"source": (kernels.lib("gf_evaluate"), None, {})}
    for spec, (lib, consts) in build_variants("circuit_eval", specs).items():
        query = lib.vpt_gf_evaluate_clusters
        query.argtypes = [ctypes.c_int, ctypes.c_void_p]
        query.restype = ctypes.c_int
        variants[spec] = (entry_of(lib, "circuit_eval", "gf_evaluate"),
                          query, consts)
    rows = {spec: [] for spec in variants}

    def fits(query):
        out = {}
        for k in (1 << j for j in range(comp.EVAL_CLUSTER.bit_length())):
            n = ctypes.c_int(0)
            err = query(k, ctypes.byref(n))
            if err:
                raise RuntimeError(f"cluster query: cudaError_t {err}")
            out[k] = n.value
        return out

    try:
        for shp in EVAL_SHAPES:
            ins = cs.random_inputs(torch, np, gf, "gf_evaluate", shp, dev,
                                   rng)
            want = comp.evaluate_plain(*ins)
            for spec, (fn, query, consts) in variants.items():
                for n in names:
                    setattr(comp, f"EVAL_{n}", consts.get(n, saved[0][n]))
                kernels._FNS["gf_evaluate"] = fn
                comp._fits = (saved[1] if query is None else
                              (lambda dev, q=query: fits(q)))
                try:
                    got = comp.evaluate_cuda(*ins)
                except RuntimeError as e:   # a variant the card refuses
                    rows[spec].append(f"{shp[0]}: refused ({e})")
                    continue
                if not torch.equal(got, want):
                    raise RuntimeError(f"variant {spec} differs at {shp}")
                n_launch = len(comp.eval_launches(ins[1].steps, shp[0],
                                                  comp._fits(dev)))
                call = lambda: comp.evaluate_cuda(*ins)
                ms = cs.profiled_ms(torch, call, REPS, ("gf_evaluate",),
                                    n_launch)
                ev = cs.event_ms(torch, call, REPS)
                rows[spec].append(
                    f"{shp[0]}: {'-' if ms is None else f'{ms * 1e3:.2f}'} "
                    f"(events {ev * 1e3:.2f}) "
                    f"{comp.eval_shape(shp[0], comp._fits(dev))}")
    finally:
        for n in names:
            setattr(comp, f"EVAL_{n}", saved[0][n])
        comp._fits = saved[1]
        kernels._FNS["gf_evaluate"] = saved[2]
    print(f"clusters that fit at once by size: {comp._fits(dev)}")
    for spec, row in rows.items():
        print(f"gf_evaluate {spec}: us a call by rows (blocks a cluster, "
              f"groups, rows a group) {'; '.join(row)}")


def build_us(lg, ins, launches):
    """fg_build_circuit's device time (us) a call: the profiler's over
    REPS calls of the wrapper (a profile that misses a launch is repeated,
    up to 10 times; None if none holds them all), and CUDA events' over
    50 back-to-back calls of the C entry itself on buffers made once, so
    that the host's issue is one ctypes call a launch."""
    _, r, ep = ins
    call = lambda: fft_gkr.build_circuit_cuda(*ins)
    ms = cs.profiled_ms(torch, call, REPS, ("fg_build_",), launches)
    n = 1 << lg
    buf = torch.empty(2 * (sum(fft_gkr.circuit_sizes(lg)) + fft_gkr.POINTS
                           * n), dtype=torch.int64, device=r.device)
    parts = torch.empty(2 * fft_gkr.POINTS * max(n >> fft_gkr.CHUNK_LOG, 1),
                        dtype=torch.int64, device=r.device)
    inv = gf.pow_int((n % gf.MOD, 0), gf.MOD - 2)
    args = (r.data_ptr(), r.stride(0), r.stride(1), ep.data_ptr(),
            ep.stride(0), ep.stride(1),
            fft_gkr.stage_powers(lg, r.device).data_ptr(), inv[0], inv[1],
            buf.data_ptr(), parts.data_ptr(), lg, kernels.stream_ptr())
    fn = kernels.lib("fg_build_circuit")
    ev = cs.event_ms(torch, lambda: fn(*args), 50)
    return None if ms is None else ms * 1e3, ev * 1e3


def time_variants(specs, dev, rng):
    """Each variant and the source, in turns, at every lg of TIMED_LGS:
    held against the twin, then timed (the wrapper's ONE_LAUNCH_LOG and
    CHUNK_LOG set to the variant's, which size its launches and scratch)."""
    logs = (fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG)
    variants = {"source": (kernels.lib("fg_build_circuit"), logs)}
    for spec, (lib, consts) in build_variants("fft_gkr", specs).items():
        variants[spec] = (entry_of(lib, "fft_gkr", "fg_build_circuit"),
                          (consts.get("ONE_LAUNCH_LOG", logs[0]),
                           consts.get("CHUNK_LOG", logs[1])))
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
                us, ev = build_us(lg, ins, fft_gkr.circuit_launches(lg))
                rows[spec].append(f"{lg}: {'-' if us is None else f'{us:.2f}'}"
                                  f" (events {ev:.2f})")
    finally:
        kernels._FNS["fg_build_circuit"] = variants["source"][0]
        fft_gkr.ONE_LAUNCH_LOG, fft_gkr.CHUNK_LOG = logs
    for spec, row in rows.items():
        print(f"fg_build_circuit {spec}: us a call by lg {'; '.join(row)}")


def time_entries(dev, rng):
    """gf_evaluate at randomize(14, 13)'s shape and the long sums, device
    time from the profiler beside chip_smoke's bounds."""
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    rate = (cs.INT32_OPS_PER_CLK_SM * clk
            * torch.cuda.get_device_properties(0).multi_processor_count)
    _, wrappers, _, expected = cs.kernel_tables()
    shapes = [("gf_evaluate", (b, 8192, 13)) for b in (1, 4, 16, 64)]
    shapes += [("gf_segsum", (2 << k,)) for k in (13, 14)]
    for entry, shp in shapes:
        ins = cs.random_inputs(torch, np, gf, entry, shp, dev, rng)
        fn = getattr(*wrappers[entry])
        ms = cs.profiled_ms(torch, lambda: fn(*ins), REPS,
                            cs.KERNEL_NAMES[entry], expected(entry, ins))
        nbytes, ops = cs.cost(entry, shp, ins)
        bound = max(nbytes / cs.HBM_BYTES_S, ops / rate) * 1e3
        print(f"time {entry} {shp}: "
              f"{'-' if ms is None else f'{ms * 1e3:.3f}'} us a call "
              f"(bound {bound * 1e3:.3f} us)")
    # the long sums at each cluster size the route takes, forced
    rule = chains.seg_cluster
    try:
        for n in (1 << 13, 1 << 14, 1 << 20):
            ins = cs.random_inputs(torch, np, gf, "gf_segsum", (2 * n,), dev,
                                   rng)
            row = []
            for k in (1, 2, 4, 5, 8):
                chains.seg_cluster = lambda outputs, k=k: k
                ms = cs.profiled_ms(torch, lambda: chains.segsum_cuda(*ins),
                                    REPS, ("gf_segsum",), 1)
                row.append(f"{k}: {'-' if ms is None else f'{ms * 1e3:.3f}'}")
            print(f"time gf_segsum (2, {n}) by blocks an output, forced "
                  f"(the rule's {rule(2)}): {'; '.join(row)} us")
    finally:
        chains.seg_cluster = rule


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

    for shp in ((1, 8192, 13), (64, 8192, 13), (3, 1000, 3), (1, 2, 2)):
        held("gf_evaluate", cs.random_inputs(torch, np, gf, "gf_evaluate",
                                             shp, dev, rng), shp)
    for lead in ((), (4,)):
        widths = [1000, 1 << 18, 3000, 500]
        inputs = gf.tensor(rng.integers(0, gf.MOD, size=(2, *lead, 1000),
                                        dtype=np.uint64), dev)
        held("gf_evaluate",
             (inputs, cs.random_plan(torch, np, gf, widths, dev, rng)),
             f"a 2^18-gate layer, lead {lead}")
    for k in range(10, 21):
        held("gf_segsum", cs.random_inputs(torch, np, gf, "gf_segsum",
                                           (2 << k,), dev, rng),
             f"a (2, 2^{k}) sum")
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
    evaluator = protocol.make_evaluator(cc, dev)
    evaluator(input_buffer(cc, None, dev))
    if not torch.equal(evaluator(input_buffer(cc, None, dev)).cpu(), host):
        raise RuntimeError("randomize(14, 13)'s replayed evaluation differs")
    holder = next(iter(evaluator.holders.values()))
    print(f"randomize(14, 13)'s evaluation replayed == the CPU's; the "
          f"evaluator graph's kernel nodes "
          f"{dict(cs.graph_kernel_nodes(holder.graph))}")
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
    time_entries(dev, rng)
    evals = [a[5:] for a in sys.argv[1:] if a.startswith("eval:")]
    if evals:
        time_eval_variants(evals, dev, rng)
    builds = [a for a in sys.argv[1:] if not a.startswith("eval:")]
    if builds:
        time_variants(builds, dev, rng)
    print("OK")


if __name__ == "__main__":
    main()
