#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Virgo++ prover on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
card and the CUDA toolkit (``nvcc``); it imports neither JAX nor the JAX
package.  Phases, one line each, any failure exits non-zero:

1. the card's name and power limit; build the kernels (one ``nvcc`` per
   source, started together) into ``build/torch_kernels/``;
2. K1 (sumcheck fold) against its plain twin, bit for bit;
3. K2 (SHA3-256 of 64-byte blocks) against its plain twin and hashlib;
4. prove ``tests/data/small1200.pws`` on the card: pinned transcript hash,
   Merkle roots and proof sizes; the port's verify accepts.  A card proof
   of ``randomize(3, 7, seed=21)`` equals the CPU proof in every field;
5. full width, ``randomize(14, 13, seed=0)``: prove and verify through the
   driver with the launch counters reset just before and read just after,
   while every kernel call's inputs and outputs are recorded; each
   recorded call is then held against its plain twin on the same inputs.
   A tampered proof is rejected.  The timed prove (fused.prove_e2e + the
   fft_gkr tape) must launch the kernels too.  Wall times of the timed
   prove, verify and driver prove, every run listed; K1 and K2 timed at
   every shape the main path gave them, beside their plain twins and
   bounds;
6. where the time goes: synchronised prove spans, verify spans, and a
   profile of one timed prove.

The last lines are the card line, one JSON object with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""

import collections
import hashlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "small1200.pws"

# pinned from the reference C++ build (tests/test_reference_parity.py)
REF_TRANSCRIPT_HASH = 6734251442166396890
REF_ROOT_L = [4549031888097254546, 11168658884316476171,
              16120839039200765914, 5241882187682402051]
REF_ROOT_H = [13909950205968780032, 16010536814451885176,
              13358162157050512808, 7962201919850548760]
REF_GKR_BYTES = int(8.71875 * 1024)
REF_PC_BYTES = int(75.21875 * 1024)

HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
INT32_OPS_PER_CLK_SM = 64    # 32-bit IMAD / LOP3 / SHF issue rate, cc 9.0
KECCAK_INT32_OPS = 4320      # one Keccak-f[1600] with 3-input LOP3 fusing
K1_PRODUCTS_PER_PAIR = 21    # 7 GF(p^2) products x 3 base products
IMAD_PER_PRODUCT = 4         # 64x64->128 from four 32x32->64 partials

# device-kernel names of each source, as the profiler reports them
KERNEL_NAMES = {"sumcheck_fold": ("fold_round", "reduce_partials"),
                "keccak": ("sha3_256_x64",)}

TIMED_RUNS = 10              # wall-clock runs of the timed prove
VERIFY_RUNS = 5              # ... of driver.verify and driver.prove


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def transcript_hash(cc, full):
    """The reference parity hash over every GKR round poly and claim."""
    h = 146527

    def add(el):
        nonlocal h
        h = (h * 1000003 + int(el[0])) % 2 ** 64
        h = (h * 1000003 + int(el[1])) % 2 ** 64

    def poly(p):
        for k in range(3):
            add(p[:, k])

    add(full.vres)
    for i in range(cc.depth - 1, 0, -1):
        lp = full.layers[i]
        for j in range(lp["p1_polys"].shape[0]):
            poly(lp["p1_polys"][j])
        add(lp["claim_u"])
        if lp.get("p2_polys") is not None:
            for j in range(lp["p2_polys"].shape[0]):
                poly(lp["p2_polys"][j])
            for k in range(lp["claims_v"].shape[0]):
                add(lp["claims_v"][k])
        for j in range(lp["liu_polys"].shape[0]):
            poly(lp["liu_polys"][j])
        add(lp["liu_claim"])
    return h


def proof_arrays(proof_io, np, full):
    """Every field of a FullProof as named arrays (the .npz layout)."""
    buf = io.BytesIO()
    proof_io.save(buf, full)
    buf.seek(0)
    with np.load(buf) as d:
        return {k: d[k] for k in d.files}


def event_ms(torch, fn, reps):
    """Device time of one call, from CUDA events around `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn, runs):
    """Host wall times (ms) of `runs` calls of fn, synchronised around each
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def spread(ts):
    return (f"median {statistics.median(ts):.3f} ms, min {min(ts):.3f}, max "
            f"{max(ts):.3f}, runs [{', '.join(f'{t:.3f}' for t in ts)}]")


def max_abs_err(torch, xs, ys):
    """Largest |x - y| over pairs of int64 tensors holding u64 words."""
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            return float("inf")
        d = (x != y)
        if bool(d.any()):
            a = x[d].cpu().numpy().view("uint64").astype(object)
            b = y[d].cpu().numpy().view("uint64").astype(object)
            err = max(err, max(abs(int(p) - int(q)) for p, q in zip(a, b)))
    return float(err)


class Recorder:
    """While active, every call of the two kernel wrappers keeps a copy of
    its inputs and outputs, so that each call can be held against its plain
    twin afterwards.  The wrappers' own launch counts are untouched."""

    def __init__(self, sumcheck, keccak):
        self.sumcheck, self.keccak = sumcheck, keccak
        self.calls = []

    def __enter__(self):
        fold, sha = self.sumcheck.fold_cuda, self.keccak.sha3_256_x64_cuda
        self.saved = (fold, sha)

        def fold_rec(v, a, m, rs):
            ins = tuple(t.clone() for t in (v, a, m, rs))
            polys, bound = fold(v, a, m, rs)
            outs = (polys.clone(),) + tuple(b.clone() for b in bound)
            self.calls.append(("sumcheck_fold", ins, outs))
            return polys, bound

        def sha_rec(words):
            ins = (words.clone(),)
            out = sha(words)
            self.calls.append(("keccak", ins, (out.clone(),)))
            return out

        self.sumcheck.fold_cuda = fold_rec
        self.keccak.sha3_256_x64_cuda = sha_rec
        return self

    def __exit__(self, *exc):
        self.sumcheck.fold_cuda, self.keccak.sha3_256_x64_cuda = self.saved


def shape_of(name, ins):
    """(bl, K) of a K1 call, (N,) of a K2 call."""
    if name == "sumcheck_fold":
        return (ins[3].shape[2], ins[0].shape[1])
    return (ins[0].shape[1],)


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "virgo_plus_tpu_torch").is_dir() or not FIXTURE.exists():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from virgo_plus_tpu_torch import driver, fused, kernels, proof_io
    from virgo_plus_tpu_torch.circuits.compile import input_buffer
    from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
    from virgo_plus_tpu_torch.field import gf
    from virgo_plus_tpu_torch.gkr import protocol
    from virgo_plus_tpu_torch.gkr import sumcheck
    from virgo_plus_tpu_torch.pc import fft_gkr, keccak, virgo_pc
    from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    max_clk_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = INT32_OPS_PER_CLK_SM * n_sm * max_clk_hz
    say(f"card: {card} ({n_sm} SMs, max SM clock {max_clk_hz / 1e6:.0f} MHz, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    for src, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        say(f"phase 1 build {src}: {'; '.join(regs) or log.strip()}")
    say(f"phase 1 ok: kernels built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(2024)
    M = gf.MOD
    err = {"sumcheck_fold": 0.0, "keccak": 0.0}

    # ---- phase 2: K1 against its plain twin -------------------------------
    for bl in (1, 3, 7, 13, 17):
        for k in (1, 3, 26):
            n = 1 << bl
            ins = [gf.tensor(rng.integers(0, M, size=(2, k, n),
                                          dtype=np.uint64), dev)
                   for _ in range(3)]
            rs = gf.tensor(rng.integers(0, M, size=(2, k, bl),
                                        dtype=np.uint64), dev)
            p1, b1 = sumcheck.fold_cuda(*ins, rs)
            p0, b0 = sumcheck.fold_plain(*ins, rs)
            torch.cuda.synchronize()
            e = max_abs_err(torch, (p1,) + tuple(b1), (p0,) + tuple(b0))
            if e != 0.0:
                fail(f"K1 differs from its plain twin at bl={bl} K={k}")
    say("phase 2 ok: K1 == plain twin bit for bit, bl in {1,3,7,13,17} x "
        "K in {1,3,26}")

    # ---- phase 3: K2 against its plain twin and hashlib -------------------
    for n in (1, 1000, 4096, 6128, 65536):
        w = rng.integers(0, 2 ** 64, size=(8, n), dtype=np.uint64)
        wt = gf.tensor(w, dev)
        o1 = keccak.sha3_256_x64_cuda(wt)
        o0 = keccak.sha3_256_x64_plain(wt)
        torch.cuda.synchronize()
        if max_abs_err(torch, (o1,), (o0,)) != 0.0:
            fail(f"K2 differs from its plain twin at N={n}")
        o = gf.to_numpy(o1)
        wc = np.ascontiguousarray(w.T)
        oc = np.ascontiguousarray(o.T)
        for i in range(n):
            if hashlib.sha3_256(wc[i].tobytes()).digest() != oc[i].tobytes():
                fail(f"K2 differs from hashlib.sha3_256 at N={n}, message {i}")
    say("phase 3 ok: K2 == plain twin == hashlib.sha3_256, "
        "N in {1,1000,4096,6128,65536}")

    # ---- phase 4: small1200 pins on the card; card proof == CPU proof -----
    c = driver.load_circuit(str(FIXTURE))
    cp = driver.compile_prover(c)
    full, info = driver.prove(c, cp)
    rep = driver.verify(c, full, cp)
    th = transcript_hash(cp.cc, full)
    checks = {
        "verify": rep.ok,
        "transcript_hash": th == REF_TRANSCRIPT_HASH,
        "root_l": [int(x) for x in full.root_l] == REF_ROOT_L,
        "root_h": [int(x) for x in full.root_h] == REF_ROOT_H,
        "gkr_size": info["gkr_proof_size"] == REF_GKR_BYTES,
        "pc_size": info["pc_proof_size"] == REF_PC_BYTES,
    }
    if not all(checks.values()):
        fail(f"small1200 on the card: {checks}")
    say(f"phase 4 ok: small1200 transcript hash {th}, roots, GKR "
        f"{info['gkr_proof_size'] / 1024} KB, PC {info['pc_proof_size'] / 1024}"
        f" KB match the reference; verify accepts")

    c = randomize(3, 7, seed=21)
    subset_init(c)
    card_full, _ = driver.prove(c, device=dev)
    cpu_full, _ = driver.prove(c, device="cpu")
    got = proof_arrays(proof_io, np, card_full)
    want = proof_arrays(proof_io, np, cpu_full)
    differ = sorted(k for k in set(got) | set(want)
                    if k not in got or k not in want
                    or got[k].dtype != want[k].dtype
                    or not np.array_equal(got[k], want[k]))
    if differ:
        fail(f"randomize(3, 7): card proof differs from the CPU proof in "
             f"{differ}")
    if not driver.verify(c, card_full, device=dev).ok:
        fail("randomize(3, 7): the card proof is rejected")
    say(f"phase 4 ok: randomize(3, 7) card proof == CPU proof in all "
        f"{len(got)} arrays; verify accepts")

    # ---- phase 5: full width ----------------------------------------------
    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c)
    cc = cp.cc
    with Recorder(sumcheck, keccak) as rec:
        kernels.reset_counts()
        t0 = time.perf_counter()
        full, info = driver.prove(c, cp)
        torch.cuda.synchronize()
        t_prove_first = time.perf_counter() - t0
        rep = driver.verify(c, full, cp)
        launches = dict(kernels.LAUNCHES)
        plain = dict(kernels.PLAIN_CALLS)
    if not rep.ok:
        fail(f"full-width proof rejected: {rep}")
    if min(launches.values()) == 0 or max(plain.values()) != 0:
        fail(f"main path did not run through the kernels: launches "
             f"{launches}, plain twin calls {plain}")
    say(f"phase 5 main path ok: randomize(14, 13) proved and verified "
        f"(first prove {t_prove_first:.3f} s); device launches {launches}, "
        f"plain twin calls {plain}; transcript hash "
        f"{transcript_hash(cc, full)}")

    # every recorded kernel call against its plain twin on the same inputs
    shapes = {"sumcheck_fold": collections.Counter(),
              "keccak": collections.Counter()}
    example = {}
    for kname, ins, outs in rec.calls:
        if kname == "sumcheck_fold":
            p, b = sumcheck.fold_plain(*ins)
            ref = (p,) + tuple(b)
        else:
            ref = (keccak.sha3_256_x64_plain(*ins),)
        e = max_abs_err(torch, outs, ref)
        shp = shape_of(kname, ins)
        if e != 0.0:
            fail(f"{kname} differs from its plain twin on the main path's "
                 f"call at shape {shp}")
        err[kname] = max(err[kname], e)
        shapes[kname][shp] += 1
        example.setdefault((kname, shp), ins)
    rec.calls.clear()
    say(f"phase 5 recorded calls ok: every kernel call of the main path == "
        f"its plain twin on the same inputs; K1 (bl, K): calls "
        f"{dict(sorted(shapes['sumcheck_fold'].items()))}; K2 N: calls "
        f"{dict(sorted(shapes['keccak'].items()))}")

    lp = full.layers[cc.depth - 1]
    saved = lp["p1_polys"].copy()
    lp["p1_polys"][0, 0, 1] = np.uint64((int(saved[0, 0, 1]) + 1) % M)
    if driver.verify(c, full, cp).ok:
        fail("the tampered full-width proof was accepted")
    lp["p1_polys"] = saved
    say("phase 5 tamper ok: a proof with one p1_polys coefficient changed "
        "is rejected")

    # the timed prove: fused.prove_e2e + the fft_gkr tape
    bl0 = cc.layers[0].bit_length
    n_folds = bl0 - virgo_pc.LOG_SLICE
    grng = GlibcRandom(3396)
    ch = protocol.make_challenges(cc, grng, dev)
    sched = fft_gkr.draw_schedule(n_folds, grng)
    fold_rands = []
    for _ in range(n_folds):
        r, i = grng.field_element()
        fold_rands.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                      dev).reshape(2))
    inputs = input_buffer(cc, None, dev)

    def timed_prove():
        out = fused.prove_e2e(cc, cp.plans, inputs, ch, fold_rands, cp.arrs)
        fused.fg_tape(n_folds, sched, dev)
        return out

    kernels.reset_counts()
    out = timed_prove()
    torch.cuda.synchronize()
    timed_launches = dict(kernels.LAUNCHES)
    timed_plain = dict(kernels.PLAIN_CALLS)
    if min(timed_launches.values()) == 0 or max(timed_plain.values()) != 0:
        fail(f"the timed prove did not run through the kernels: launches "
             f"{timed_launches}, plain twin calls {timed_plain}")
    root_l_fused = [int(x) for x in gf.to_numpy(out[1].tree[:, 1])]
    if root_l_fused != [int(x) for x in full.root_l]:
        fail("fused.prove_e2e's l-oracle root differs from driver.prove's")
    say(f"phase 5 timed prove ok: device launches {timed_launches}, plain "
        f"twin calls {timed_plain}; l-oracle root == driver.prove's")

    t_e2e = wall_ms(torch, timed_prove, TIMED_RUNS)
    t_verify = wall_ms(torch, lambda: driver.verify(c, full, cp), VERIFY_RUNS)
    t_driver = wall_ms(torch, lambda: driver.prove(c, cp), VERIFY_RUNS)
    say(f"phase 5 timing ({card}): timed prove {spread(t_e2e)}; "
        f"driver.verify {spread(t_verify)}; driver.prove {spread(t_driver)}")

    # kernels at every shape the main path gave them
    def k1_cost(bl, k):
        n = 1 << bl
        nbytes = 3 * 16 * k * n + 16 * k * bl + 48 * bl * k + 48 * k
        ops = K1_PRODUCTS_PER_PAIR * k * (n - 1) * IMAD_PER_PRODUCT
        return nbytes, ops

    def k2_cost(n):
        return 96 * n, KECCAK_INT32_OPS * n

    plan = {"sumcheck_fold": (sumcheck.fold_cuda, sumcheck.fold_plain,
                              lambda s: k1_cost(*s), 20),
            "keccak": (keccak.sha3_256_x64_cuda, keccak.sha3_256_x64_plain,
                       lambda s: k2_cost(*s), 100)}
    rows = {}
    for kname, (cuda_fn, plain_fn, cost, reps) in plan.items():
        per = {}
        for shp, count in sorted(shapes[kname].items()):
            ins = example[(kname, shp)]
            ms = event_ms(torch, lambda: cuda_fn(*ins), reps)
            nbytes, ops = cost(shp)
            bound = max(nbytes / HBM_BYTES_S, ops / int32_rate) * 1e3
            per[shp] = (count, ms, bound, nbytes / HBM_BYTES_S >= ops / int32_rate)
        total_ms = sum(cnt * ms for cnt, ms, _, _ in per.values())
        total_bound = sum(cnt * bd for cnt, _, bd, _ in per.values())
        # the shape that takes the most kernel time in one prove
        top = max(per, key=lambda s: per[s][0] * per[s][1])
        ins = example[(kname, top)]
        plain_ms = event_ms(torch, lambda: plain_fn(*ins), 3)
        rows[kname] = dict(top=top, per=per, total_ms=total_ms,
                           total_bound=total_bound, plain_ms=plain_ms)
        say(f"phase 5 kernel {kname}: per shape (calls, ms, bound ms) "
            + "; ".join(f"{s}: {cnt}, {ms:.4f}, {bd:.5f}"
                        for s, (cnt, ms, bd, _) in per.items())
            + f"; all calls of one prove {total_ms:.3f} ms (bound "
            f"{total_bound:.4f}); top shape {top}: {per[top][1]:.4f} ms vs "
            f"plain {plain_ms:.3f} ms")
    example.clear()

    # ---- phase 6: where the time goes ------------------------------------
    from virgo_plus_tpu_torch.utils.metrics import PhaseTimer
    pt = PhaseTimer()
    runs = 3
    for _ in range(runs):
        fused.prove_e2e(cc, cp.plans, inputs, ch, fold_rands, cp.arrs,
                        timer=pt)
        with pt.span("fft_gkr_tape", torch.cuda.synchronize):
            fused.fg_tape(n_folds, sched, dev)
    spans = {k: round(v / runs * 1e3, 3) for k, v in pt.report().items()}
    say(f"phase 6 prove spans (ms, mean of {runs}, synchronised): {spans}")
    rep = driver.verify(c, full, cp)
    vph = {k: round(v * 1e3, 3) for k, v in rep.details["phases"].items()}
    say(f"phase 6 verify spans (ms): {vph}; GKR fast "
        f"{cp.verifier.last_split[0] * 1e3:.3f}, predicate sweeps "
        f"{cp.verifier.last_split[1] * 1e3:.3f}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_prove()
        torch.cuda.synchronize()
    prof_rows = []
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if "CUDA" in str(getattr(e, "device_type", "")) and us > 0:
            prof_rows.append((us, e.count, e.key))
    prof_rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in prof_rows) / 1e3
    n_kern = sum(r[1] for r in prof_rows)
    profiled = {kname: [0.0, 0] for kname in KERNEL_NAMES}
    idle = None
    if busy_ms > 0:
        med = statistics.median(t_e2e)
        idle = 1 - busy_ms / med
        say(f"phase 6 profile of one timed prove: {n_kern} kernel launches, "
            f"device busy {busy_ms:.3f} ms; idle share {idle:.4f} of the "
            f"median wall {med:.1f} ms ({1 - busy_ms / max(t_e2e):.4f} of "
            f"the slowest run, {1 - busy_ms / min(t_e2e):.4f} of the fastest)")
        for us, cnt, key in prof_rows[:8]:
            say(f"phase 6   {us / 1e3:9.3f} ms  x{cnt:6d}  {key[:90]}")
        for kname, pats in KERNEL_NAMES.items():
            for us, cnt, key in prof_rows:
                if any(p in key for p in pats):
                    profiled[kname][0] += us / 1e3
                    profiled[kname][1] += cnt
        say(f"phase 6 profile, the port's kernels in that prove (device ms, "
            f"launches): {profiled}")
    else:
        say("phase 6 profile: the profiler recorded no device time "
            "(device busy share not measured)")

    def entry(kname, source, replaces):
        row = rows[kname]
        _cnt, ms, bound, by_bytes = row["per"][row["top"]]
        return {"name": kname if kname != "keccak" else "sha3_256_x64",
                "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kname], "max_abs_err": err[kname],
                "ms": ms, "plain_ms": row["plain_ms"], "bound_ms": bound,
                "bound_by": "bytes" if by_bytes else "operations",
                "library_ms": None, "shape": list(row["top"]),
                "prove_total_ms": row["total_ms"],
                "prove_total_bound_ms": row["total_bound"],
                "timed_prove_launches": timed_launches[kname],
                "profiled_device_ms": profiled[kname][0]}

    report = {"kernels": [
        entry("sumcheck_fold", "virgo_plus_tpu_torch/csrc/sumcheck_fold.cu",
              "virgo_plus_tpu/pallas_kernels/sumcheck_fold.py:118"),
        entry("keccak", "virgo_plus_tpu_torch/csrc/keccak.cu",
              "virgo_plus_tpu/pallas_kernels/keccak_chain.py:100"),
    ], "timed_prove_ms": t_e2e, "verify_ms": t_verify,
        "driver_prove_ms": t_driver, "device_busy_ms": busy_ms or None,
        "idle_share_of_median": idle}
    say(f"card: {card}")
    say(json.dumps(report))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as exc:  # any phase failing fails the run
        import traceback
        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
