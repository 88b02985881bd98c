#!/usr/bin/env python3
"""A short check of gkr_verify_fast and gkr_verify_slow on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_verify.py [--parent DIR] [SHAPE ...]`` (~3 min
with every shape, ~5 with a parent).  It prints the card's name and power
limit, builds ``csrc/gkr_verify.cu`` (printing ptxas' registers and
spills) and reads its SASS (``cuobjdump -sass``): each kernel's
instruction count and every memory fence, cache invalidation, cluster
barrier, block barrier and atomic with its offset.  Then, for each shape
(default all):

* ``14,13``: proves randomize(14, 13, seed=0) on the card and holds both
  entries (the fast one with and without the output block) against their
  plain twins on the proof and on chip_smoke.py's tampers (each verdict
  the twin's, the honest proof accepted, every tamper by one rejected),
  times each entry and the host wall of an eager and of a graphed GKR
  walk (``make_verifier``), each over 20 calls;
* ``narrow``: randomize(14, b) for b = 11, 9, 7, 5 and randomize(4, 3),
  each held against its twin first, then timed: what a launch costs
  whatever its terms;
* ``5,22``: BASELINE scenario 4's circuit, randomize(5, 22, seed=4), its
  GKR proof made on the card as chip_smoke.py's phase 12 makes it
  (``scenario4_setup``): both entries against their twins with and
  without the output block (which phase 12 does not take) and on phase
  12's tampers (``scenario4_tampers``), then timed.

A timing is the device time of the wrapper's call from torch.profiler
(chip_smoke.py's ``profiled_ms``, 20 calls after a warm-up, 5 at
randomize(5, 22), "not measured" where every profile missed launches)
and of the entry's launch alone (``vchecks._launch`` on the call's c0 and
polynomials) between CUDA events queued behind a device sleep
(``queued_ms``, the median of 5), against chip_smoke.py's bound
(``verify_cost``).  Any difference raises.

With ``--parent DIR`` (another checkout, unpacked by ``git archive``), that
tree's port is loaded beside this one as a package of its own
(``parent_port``) and its kernels built from its sources; at every shape
its entries run on the same proofs (their outputs must equal this tree's)
and are timed in turns with this tree's: parent, change, change, parent."""

import argparse
import importlib
import importlib.util
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from virgo_plus_tpu_torch import driver, kernels  # noqa: E402
from virgo_plus_tpu_torch.circuits import compile as compile_mod  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import input_buffer  # noqa: E402
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import protocol, vchecks  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402

REPS = 20
WIDE_REPS = 5       # randomize(5, 22)
QUEUED_REPS = 5
SHAPES = ("14,13", "narrow", "5,22")
MARKS = r"MEMBAR|CCTL|UCGABAR|FENCE|ERRBAR|SYNCS|BAR\.|ATOM|RED\."


class Port:
    """One tree's port: the modules a verifier timing needs."""

    def __init__(self, label, kernels_, vchecks_, protocol_, compile_):
        self.label, self.kernels, self.vchecks = label, kernels_, vchecks_
        self.protocol, self.compile = protocol_, compile_

    def fns(self, entry):
        v = self.vchecks
        return {"gkr_verify_fast": (v.verify_fast_cuda, v.verify_fast_plain),
                "gkr_verify_slow": (v.verify_slow_cuda,
                                    v.verify_slow_plain)}[entry]

    def plan(self, c, cc, dev):
        """This port's verifier plan of layered circuit c (cc: this
        tree's compile of it, made again by the other port's)."""
        if self.label != "change":
            cc = self.compile.compile_circuit(c)
        return self.vchecks.plan(cc, self.protocol.verifier_arrays(cc, dev),
                                 dev)


def load_parent(tree) -> Port:
    """The port of another checkout as the package ``parent_port`` (its
    modules import each other by relative imports only), its
    gkr_verify kernels built from its own sources."""
    init = Path(tree).resolve() / "virgo_plus_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "parent_port", init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = pkg
    spec.loader.exec_module(pkg)
    mods = [importlib.import_module(f"parent_port.{m}") for m in (
        "kernels", "gkr.vchecks", "gkr.protocol", "circuits.compile")]
    return Port("parent", *mods)


def held(port, entry, ins, what, want=None):
    """One call of the port's entry: one launch, == its twin (the change)
    or == `want` (the parent: the change's outputs); returns the outputs."""
    fn, twin = port.fns(entry)
    before = port.kernels.LAUNCHES[entry]
    got = cs.flatten(fn(*ins))
    n = port.kernels.LAUNCHES[entry] - before
    if n != 1:
        raise RuntimeError(f"{port.label}'s {entry} made {n} launches")
    if want is None:
        want = cs.flatten(twin(*ins))
    if cs.max_abs_err(torch, got, want) != 0.0:
        raise RuntimeError(f"{port.label}'s {entry} differs at {what}")
    return got


def held_all(ports, vps, proof, ch, out, what):
    """Both entries of every port on one proof (and output block): each
    port's outputs the change's, the change's its twins'; the verdict."""
    got = held(ports[0], "gkr_verify_fast", (vps[0], proof, ch, out), what)
    mids = list(got[1:1 + vps[0].fast.layers])
    slow = held(ports[0], "gkr_verify_slow", (vps[0], proof, ch, mids),
                what)
    for port, vp in zip(ports[1:], vps[1:]):
        held(port, "gkr_verify_fast", (vp, proof, ch, out), what, got)
        held(port, "gkr_verify_slow", (vp, proof, ch, mids), what, slow)
    return bool(got[0]) and bool(slow[0])


def check_verdict(case, verdict):
    if case not in cs.NONCANONICAL and verdict != case.startswith("good"):
        raise RuntimeError(f"the entries' verdict on {case}: {verdict}")


def walls(fn):
    out = []
    for _ in range(REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    out = out[1:]
    return (f"median {statistics.median(out):.3f} ms, min {min(out):.3f}, "
            f"max {max(out):.3f}")


def sass_marks(port):
    """Each gkr_verify kernel's instruction count, and its fences, cache
    invalidations, barriers and atomics with their offsets."""
    lib = port.kernels._target("gkr_verify")
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    for name, ins in funcs.items():
        marks = [f"{o:#06x} {i}" for o, i in ins if re.search(MARKS, i)]
        count = {k: sum(k in i for _, i in ins)
                 for k in ("MEMBAR.ALL.GPU", "MEMBAR.SC.GPU", "CCTL.IVALL",
                           "UCGABAR")}
        print(f"SASS ({port.label}) {name}: {len(ins)} instructions; "
              f"{count}; marks: {marks}", flush=True)


def launch_only(port, vp, entry, proof, ch, last):
    """The entry's launch alone, on the c0 and polynomials its wrapper
    would cat for this call (last: the output block or the mids)."""
    v = port.vchecks
    if entry == "gkr_verify_fast":
        kp = vp.fast
        polys, c0 = v._polys(vp.cc, proof), v._c0(kp, proof, ch, last)
        mids = torch.empty((kp.layers, 2), dtype=torch.int64,
                           device=c0.device)
        jobs = kp.n_jobs + (last is not None)
        return lambda: v._launch(kp, c0, polys, jobs, mids)
    kp = vp.slow
    c0 = v._c0(kp, proof, ch, mids=last)
    return lambda: v._launch(kp, c0, None, kp.n_jobs)


def timed(ports, vps, proof, ch, out, rate, reps=REPS):
    """Each entry's device time (profiler, the wrapper's call; queued
    events, the launch alone) against its bound (this tree's plan), every
    port in turns: parent, change, change, parent."""
    mids = list(vchecks.verify_fast_cuda(vps[0], proof, ch)[1])
    calls = [("gkr_verify_fast", None)]
    if out is not None:
        calls.append(("gkr_verify_fast", out))
    calls.append(("gkr_verify_slow", mids))
    order = [1, 0, 0, 1] if len(ports) > 1 else [0]
    for entry, last in calls:
        ins0 = (vps[0], proof, ch, last)
        nbytes, ops = cs.verify_cost(entry, ins0)
        t_bytes, t_ops = nbytes / cs.HBM_BYTES_S, ops / rate
        kp, jobs = cs.verify_jobs(entry, ins0)
        res = {}
        for k in order:
            fn = ports[k].fns(entry)[0]
            ins = (vps[k], proof, ch, last)
            ms = cs.profiled_ms(torch, lambda: fn(*ins), reps, (entry,), 1)
            ev = statistics.median(cs.queued_ms(torch, launch_only(
                ports[k], vps[k], entry, proof, ch, last), QUEUED_REPS))
            res.setdefault(ports[k].label, []).append(
                f"profiler {'not measured' if ms is None else f'{ms * 1e3:.2f}'}"
                f" / queued {ev * 1e3:.2f}")
        print(f"  {entry} {cs.verify_shape(entry, ins0)}: "
              + "; ".join(f"{lb} [{', '.join(x)}] us" for lb, x in
                          res.items())
              + f"; bound {max(t_bytes, t_ops) * 1e6:.3f} us "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"{kp.items_of(jobs)} blocks (change)", flush=True)


def full_width(ports, dev, rate, card):
    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c, graphed=False)
    cc = cp.cc
    full, _ = driver.prove(c, cp)
    proof = protocol.Proof(
        vres=gf.tensor(full.vres, dev),
        layers=[None] + [driver._layer_proof_from(full.layers[i], dev)
                         for i in range(1, cc.depth)])
    ch = protocol.make_challenges(cc, GlibcRandom(3396), dev)
    vps = [port.plan(c, cc, dev) for port in ports]
    values = cp.evaluator(input_buffer(cc, None, dev))
    out = values[:, int(cc.value_off[cc.depth - 1]):]
    verdicts = {}
    for case, (pf, ob) in cs.tampered(cc, proof, out).items():
        verdicts[case] = held_all(ports, vps, pf, ch, ob, case)
        check_verdict(case, verdicts[case])
    print(f"randomize(14, 13): both entries == their twins on the proof and "
          f"its tampers: {verdicts}", flush=True)
    timed(ports, vps, proof, ch, out, rate)
    eager = protocol.make_verifier(cc, dev, graphed=False)
    graphed = protocol.make_verifier(cc, dev)
    graphed(proof, ch)
    print(f"GKR walk (change), eager: {walls(lambda: eager(proof, ch))}, "
          f"last_split (ms) {[round(x * 1e3, 3) for x in eager.last_split]}"
          f"; through the graphs: {walls(lambda: graphed(proof, ch))}, "
          f"last_split {[round(x * 1e3, 3) for x in graphed.last_split]} "
          f"({card})", flush=True)


def narrow(ports, dev, rate):
    for layers, bits in ((14, 11), (14, 9), (14, 7), (14, 5), (4, 3)):
        c = randomize(layers, bits, seed=0)
        subset_init(c)
        cpn = driver.compile_prover(c, graphed=False)
        ccn = cpn.cc
        values = cpn.evaluator(input_buffer(ccn, None, dev))
        chn = protocol.make_challenges(ccn, GlibcRandom(3396), dev)
        pf = cpn.prover(values, chn)
        vps = [port.plan(c, ccn, dev) for port in ports]
        held_all(ports, vps, pf, chn, None, "a narrow one")
        print(f"randomize({layers}, {bits}):", flush=True)
        timed(ports, vps, pf, chn, None, rate)


def scenario4(ports, dev, rate):
    cc, ev, prover, ch, inputs, t_rand, t_setup = cs.scenario4_setup(dev)
    t1 = time.perf_counter()
    values = ev(inputs)
    proof = prover(values, ch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c = cc.source
    vps = [port.plan(c, cc, dev) for port in ports]
    out = values[:, int(cc.value_off[cc.depth - 1]):]
    print(f"randomize(5, 22, seed=4): host set-up {t_setup:.1f} s "
          f"(randomize + subset_init {t_rand:.1f} s), prove on the card "
          f"{t2 - t1:.3f} s, verifier plans {time.perf_counter() - t2:.1f} "
          f"s", flush=True)
    cases = {"good": (proof, None), "good, output block": (proof, out)}
    cases.update((k, (pf, None)) for k, pf in
                 cs.scenario4_tampers(torch, cc, proof).items())
    verdicts = {}
    for case, (pf, ob) in cases.items():
        verdicts[case] = held_all(ports, vps, pf, ch, ob, case)
        check_verdict(case, verdicts[case])
    print(f"randomize(5, 22, seed=4): both entries == their twins: "
          f"{verdicts}", flush=True)
    timed(ports, vps, proof, ch, out, rate, reps=WIDE_REPS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to time beside this")
    ap.add_argument("shapes", nargs="*", default=list(SHAPES))
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {ROOT}; parent {args.parent}", flush=True)
    ports = [Port("change", kernels, vchecks, protocol, compile_mod)]
    if args.parent:
        ports.append(load_parent(args.parent))
    for port in ports:
        log = port.kernels.build(["gkr_verify"])["gkr_verify"]
        print(f"build ({port.label}): " + "; ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        sass_marks(port)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    clk = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    rate = cs.INT32_OPS_PER_CLK_SM * props.multi_processor_count * clk
    for shape in args.shapes:
        if shape == "14,13":
            full_width(ports, dev, rate, card)
        elif shape == "narrow":
            narrow(ports, dev, rate)
        elif shape == "5,22":
            scenario4(ports, dev, rate)
        else:
            raise SystemExit(f"unknown shape {shape}: one of {SHAPES}")
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
