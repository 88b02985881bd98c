#!/usr/bin/env python3
"""A short check of gkr_verify_fast and gkr_verify_slow on the card.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_verify.py``.  It prints the card's name and power
limit, builds ``csrc/gkr_verify.cu`` (printing ptxas' registers and
spills), proves randomize(14, 13, seed=0) on the card and holds both
entries (the fast one with and without the output block) against their
plain twins on the proof and on chip_smoke.py's tampers (each verdict the
twin's, the honest proof accepted, every tamper rejected), then times each
entry: device time from torch.profiler (chip_smoke.py's ``profiled_ms``,
20 calls after a warm-up) against chip_smoke.py's bound
(``verify_cost``), and the host wall of an eager GKR walk
(``make_verifier(graphed=False)``) and of a graphed one (the staged
verifier's replays), each over 20 calls.  Then both entries' device time
on narrower circuits, randomize(14, b) for b = 11, 9, 7, 5 and
randomize(4, 3), each held against its twin first: what a launch costs
whatever its terms.  Any difference raises."""

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
from virgo_plus_tpu_torch.circuits.compile import input_buffer  # noqa: E402
from virgo_plus_tpu_torch.circuits.layered import (  # noqa: E402
    randomize, subset_init)
from virgo_plus_tpu_torch.field import gf  # noqa: E402
from virgo_plus_tpu_torch.gkr import protocol, vchecks  # noqa: E402
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom  # noqa: E402

REPS = 20


def held(entry, ins, what):
    """One call of the entry against its twin; returns the outputs."""
    fn = {"gkr_verify_fast": vchecks.verify_fast_cuda,
          "gkr_verify_slow": vchecks.verify_slow_cuda}[entry]
    twin = {"gkr_verify_fast": vchecks.verify_fast_plain,
            "gkr_verify_slow": vchecks.verify_slow_plain}[entry]
    before = kernels.LAUNCHES[entry]
    got = cs.flatten(fn(*ins))
    if kernels.LAUNCHES[entry] - before != 1:
        raise RuntimeError(f"{entry} made "
                           f"{kernels.LAUNCHES[entry] - before} launches")
    want = cs.flatten(twin(*ins))
    if cs.max_abs_err(torch, got, want) != 0.0:
        raise RuntimeError(f"{entry} differs from its twin at {what}")
    return got


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


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    log = kernels.build()["gkr_verify"]
    print("build: " + "; ".join(ln.strip() for ln in log.splitlines()
                                if "registers" in ln or "spill" in ln),
          flush=True)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    clk = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    rate = cs.INT32_OPS_PER_CLK_SM * props.multi_processor_count * clk
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
    vp = vchecks.plan(cc, protocol.verifier_arrays(cc, dev), dev)
    values = cp.evaluator(input_buffer(cc, None, dev))
    out = values[:, int(cc.value_off[cc.depth - 1]):]
    verdicts = {}
    for case, (pf, ob) in cs.tampered(cc, proof, out).items():
        got = held("gkr_verify_fast", (vp, pf, ch, ob), case)
        mids = list(got[1:1 + vp.fast.layers])
        slow = held("gkr_verify_slow", (vp, pf, ch, mids), case)[0]
        verdicts[case] = bool(got[0]) and bool(slow)
        if verdicts[case] != case.startswith("good"):
            raise RuntimeError(f"the entries' verdict on {case}: "
                               f"{verdicts[case]}")
    print(f"randomize(14, 13): both entries == their twins on the proof and "
          f"its tampers: {verdicts}", flush=True)
    timed(vp, proof, ch, out, rate)
    eager = protocol.make_verifier(cc, dev, graphed=False)
    graphed = protocol.make_verifier(cc, dev)
    graphed(proof, ch)
    print(f"GKR walk, eager: {walls(lambda: eager(proof, ch))}, last_split "
          f"(ms) {[round(x * 1e3, 3) for x in eager.last_split]}; through "
          f"the graphs: {walls(lambda: graphed(proof, ch))}, last_split "
          f"{[round(x * 1e3, 3) for x in graphed.last_split]} ({card})",
          flush=True)
    for layers, bits in ((14, 11), (14, 9), (14, 7), (14, 5), (4, 3)):
        c = randomize(layers, bits, seed=0)
        subset_init(c)
        cpn = driver.compile_prover(c, graphed=False)
        ccn = cpn.cc
        values = cpn.evaluator(input_buffer(ccn, None, dev))
        chn = protocol.make_challenges(ccn, GlibcRandom(3396), dev)
        pf = cpn.prover(values, chn)
        vpn = vchecks.plan(ccn, protocol.verifier_arrays(ccn, dev), dev)
        got = held("gkr_verify_fast", (vpn, pf, chn, None), "a narrow one")
        held("gkr_verify_slow", (vpn, pf, chn, list(got[1:-2])),
             "a narrow one")
        print(f"randomize({layers}, {bits}):", flush=True)
        timed(vpn, pf, chn, None, rate)


def timed(vp, proof, ch, out, rate):
    """Each entry's profiled device time against its bound."""
    mids = list(vchecks.verify_fast_cuda(vp, proof, ch)[1])
    calls = [("gkr_verify_fast", (vp, proof, ch, None))]
    if out is not None:
        calls.append(("gkr_verify_fast", (vp, proof, ch, out)))
    for entry, ins in calls + [("gkr_verify_slow", (vp, proof, ch, mids))]:
        fn = {"gkr_verify_fast": vchecks.verify_fast_cuda,
              "gkr_verify_slow": vchecks.verify_slow_cuda}[entry]
        ms = cs.profiled_ms(torch, lambda: fn(*ins), REPS, (entry,), 1)
        nbytes, ops = cs.verify_cost(entry, ins)
        t_bytes, t_ops = nbytes / cs.HBM_BYTES_S, ops / rate
        kp, jobs = cs.verify_jobs(entry, ins)
        print(f"  {entry} {cs.verify_shape(entry, ins)}: device "
              f"{'not measured' if ms is None else f'{ms * 1e3:.2f} us'} "
              f"against a bound of {max(t_bytes, t_ops) * 1e6:.3f} us "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}); "
              f"{jobs} clusters of {kp.cluster} blocks, "
              f"{8 * kp.smem_words} B of tables a block", flush=True)


if __name__ == "__main__":
    main()
