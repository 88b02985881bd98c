#!/usr/bin/env python3
"""A short check of gkr_p1_inits and gkr_p2_inits on the card, with timed
variants of the kernel's tile constants.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_gkr_inits.py [NAME=VALUE,... ...]``.  It prints
the card's name and power limit, builds ``csrc/gkr_inits.cu`` (printing
ptxas' registers and spills, and ``cuobjdump -res-usage``), holds both
entries against their plain twins on randomize(14, 13)'s plans at 1, 4,
5, 64 and 65 rows and on chip_smoke.py's three phase-3 circuits at
several lead shapes, then times both entries (device time from torch.profiler,
chip_smoke.py's ``profiled_ms``: 20 calls after a warm-up) at 1, 4 and 64
rows against chip_smoke.py's bound (``init_cost``).  Each argument is
one variant, ``NAME=VALUE,...``: the source with the named ``constexpr
int`` constants (``P1_ROWS``, ``ROW_TILE_P1``, ``ROW_TILE_P2``, ``KEPT``,
``THREADS``) set; each is built beside the others into
``build/gkr_variants/``, checked against the twins at 1, 5 and 65 rows
and timed the same way, in turns with the source as it is.  Any
difference raises."""

import ctypes
import math
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
from virgo_plus_tpu_torch import kernels  # noqa: E402
from virgo_plus_tpu_torch.circuits.compile import (  # noqa: E402
    compile_circuit, evaluate, input_buffer)
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import inits, protocol  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402

ENTRIES = ("gkr_p1_inits", "gkr_p2_inits")
VARIANTS = ROOT / "build" / "gkr_variants"
REPS = 20


def circuit(layers, bits, seed, long=0):
    """chip_smoke.py's phase-3 init circuits."""
    c = randomize(layers, bits, seed=seed)
    if long:
        top = c.layers[2]
        top.is_assert[[1, 5, 9, 12]] = True
        top.u[:long] = 0
        top.l[:long], top.v[:long] = 0, 3
    subset_init(c)
    return c


class Stages:
    """A circuit's two init stages on the card: plans, challenges and a
    values row to which each lead adds canonical noise."""

    def __init__(self, c, dev, rng):
        self.cc = compile_circuit(c)
        plans = protocol.build_plans(self.cc)
        arrs = protocol.circuit_arrays(self.cc, plans, dev)
        self.plans = (arrs["p1I"], arrs["p2I"])
        self.ch = protocol.make_challenges(self.cc, GlibcRandom(3396), dev)
        self.values = evaluate(self.cc, input_buffer(self.cc, None, dev), arrs)
        self.dev, self.rng = dev, rng

    def inputs(self, lead):
        """{entry: (plan, values, c0, betas)} at lead axes `lead`."""
        rows = math.prod(lead)
        canon = lambda *s: gf.tensor(self.rng.integers(
            0, gf.MOD, size=s, dtype=np.uint64), self.dev)
        values = gf.add(self.values[:, None],
                        canon(2, rows, self.values.shape[-1]))
        values = values.reshape((2,) + tuple(lead) + (-1,)).contiguous()
        claims = {i: canon(2, *lead) for i in range(self.cc.depth)}
        out = {}
        for entry, plan, cl in zip(ENTRIES, self.plans, (None, claims)):
            c0 = inits.challenge_buffer(plan, self.ch, cl)
            out[entry] = (plan, values, c0, inits.beta_tables(plan, c0))
        return out


def held(ins, what):
    for entry, args in ins.items():
        fn = inits.p1_inits_cuda if entry == ENTRIES[0] else inits.p2_inits_cuda
        twin = (inits.p1_inits_plain if entry == ENTRIES[0]
                else inits.p2_inits_plain)
        before = kernels.LAUNCHES[entry]
        got = fn(*args)
        want = twin(*args)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[entry] - before != 1 or not torch.equal(got, want):
            raise RuntimeError(f"{entry} differs from its twin at {what}")


def variant_source(spec):
    """The source with the constants of ``NAME=VALUE,...`` set."""
    src = (kernels.CSRC / "gkr_inits.cu").read_text()
    for item in spec.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"no constant {name} in gkr_inits.cu")
    return src


def build_variants(specs):
    """{spec: {entry: C function}}, one nvcc each, all started together."""
    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, spec in enumerate(specs):
        cu = VARIANTS / f"v{k}.cu"
        cu.write_text(variant_source(spec))
        so = VARIANTS / f"libv{k}.so"
        cmd = kernels._command("gkr_inits", so)
        cmd[cmd.index(str(kernels.CSRC / "gkr_inits.cu"))] = str(cu)
        cmd[1:1] = ["-I", str(kernels.CSRC)]
        procs[spec] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    out = {}
    for spec, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        print("variant", spec, registers(log))
        lib = ctypes.CDLL(str(so))
        fns = {}
        for entry in ENTRIES:
            symbol, argtypes = kernels.SOURCES["gkr_inits"][entry]
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[entry] = fn
        out[spec] = fns
    return out


def registers(log):
    return [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.time()
    log = kernels.build(["gkr_inits"])["gkr_inits"]
    print("build gkr_inits", registers(log))
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-res-usage",
                          str(kernels._target("gkr_inits"))],
                         capture_output=True, text=True).stdout
    print("cuobjdump -res-usage:", " | ".join(
        ln.strip() for ln in res.splitlines() if "REG" in ln or "Function" in ln))
    variants = build_variants(sys.argv[1:])
    print(f"built in {time.time() - t0:.1f} s")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    base = {e: kernels.lib(e) for e in ENTRIES}

    for what, c, leads in (
            ("randomize(4, 3, seed=5)", circuit(4, 3, 5), [(), (5,)]),
            ("randomize(3, 6) asserts, 40-term segments", circuit(3, 6, 7, 40),
             [(3,), (2, 2), (5, 13)]),
            ("randomize(3, 11) asserts, 1,500-term segments",
             circuit(3, 11, 3, 1500), [(2, 2), (5, 13)])):
        st = Stages(c, dev, rng)
        for lead in leads:
            held(st.inputs(lead), f"{what}, lead {lead}")
        print(f"{what}: == twins at leads {leads}; classes "
              f"{[p.classes for p in st.plans]}")

    big = randomize(14, 13, seed=0)
    subset_init(big)
    st = Stages(big, dev, rng)
    shapes = {}
    for rows in (1, 4, 5, 64, 65):
        shapes[rows] = st.inputs((rows,))
        held(shapes[rows], f"randomize(14, 13), {rows} rows")
    print("randomize(14, 13): == twins at 1, 4, 5, 64, 65 rows; slots",
          [p.n_slots for p in st.plans], "terms", [p.n_terms for p in st.plans])
    props = torch.cuda.get_device_properties(0)
    clock = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    int32_rate = cs.INT32_OPS_PER_CLK_SM * props.multi_processor_count * clock * 1e6

    def timed(tag):
        for rows in (1, 4, 64):
            for entry in ENTRIES:
                args = shapes[rows][entry]
                fn = (inits.p1_inits_cuda if entry == ENTRIES[0]
                      else inits.p2_inits_cuda)
                ms = cs.profiled_ms(torch, lambda: fn(*args), REPS,
                                    cs.KERNEL_NAMES[entry], 1)
                if ms is None:
                    raise RuntimeError(f"the profiler missed {entry} launches")
                us = ms * 1e3
                nbytes, ops = cs.init_cost(entry, args)
                bound = max(nbytes / cs.HBM_BYTES_S, ops / int32_rate) * 1e6
                print(f"time {tag} {entry} rows {rows}: {us:.2f} us, bound "
                      f"{bound:.2f} us, share {bound / us:.3f}")

    timed("source")
    for spec, fns in variants.items():
        kernels._FNS.update(fns)
        for rows in (1, 5, 65):
            held(shapes[rows] if rows in shapes else st.inputs((rows,)),
                 f"variant {spec}, {rows} rows")
        timed(spec)
        kernels._FNS.update(base)
        timed("source")
    print("OK")


if __name__ == "__main__":
    main()
