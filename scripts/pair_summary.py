#!/usr/bin/env python3
"""Summarise a same-call parent/change pair (scripts/same_call_pair.sh).

Usage: ``python3 scripts/pair_summary.py DIR``, where DIR holds the four
chip_smoke.py logs ``pair_{parent,change}{1,2}.log`` and, optionally, the
change's ``gf_fft.sass`` (``cuobjdump -sass`` of its gf_fft library).
For each log it prints one JSON line of the end-to-end numbers that
chip_smoke.py's report line carries: walls (median, min, max, in ms; the
graphed verifies' ``last_split`` by run; device busy ms and kernels of
the verifies that its closing profiles hold, where the log has them),
device busy ms and kernels of the profiled calls (an eager ``prove_fs``'s
kernels where the log has them, and the FS scans' device ms and launches
in it), the port's launches of a ``prove_fs``,
proofs per second of the batched replays, sharded walls per rank and the
run's length, and the GKR init stages' profiled device ms and bound ms by
rows.  For the SASS it prints the static instruction count of
``gf_fft_tile``'s pass loop (the smallest loop holding four shared-memory
loads and stores and two global loads: the four-slot kernel's pass, both
radix branches), of the loops nested in it, and the loop's most frequent
opcodes.
"""

import ast
import collections
import json
import re
import statistics
import sys
from pathlib import Path


def spread(ts):
    return [round(statistics.median(ts), 3), round(min(ts), 3),
            round(max(ts), 3)]


def summary(log: Path) -> dict:
    lines = log.read_text().splitlines()
    rep = json.loads(lines[-2])
    stamped = [ln for ln in lines if re.match(r"\[\s*[0-9.]+ s\]", ln)]
    prof = rep["replay_profiles"]
    timed, b16 = prof["timed prove replay"], prof["batched replay at B = 16"]
    fs_graphs = prof["driver.prove_fs through the graphs"]
    return dict(
        timed_prove_eager=spread(rep["timed_prove_ms"]),
        timed_prove_eager_busy=round(rep["device_busy_ms"], 3),
        timed_prove_replay=spread(rep["timed_prove_replay_ms"]),
        timed_prove_replay_busy=round(timed["busy_ms"], 3),
        timed_prove_replay_kernels=timed["kernels"],
        driver_prove_graphs=spread(rep["driver_prove_graphs_ms"]),
        driver_prove_eager=spread(rep["driver_prove_eager_ms"]),
        verify_graphs=spread(rep["verify_graphs_ms"]),
        verify_eager=spread(rep["verify_ms"]),
        verify_graphs_last_split=rep["verify_graphs_splits"],
        verify_fs_graphs=spread(rep["fs_verify_graphs_ms"]),
        verify_fs_eager=spread(rep["fs_verify_ms"]),
        verify_fs_graphs_last_split=rep["fs_verify_graphs_splits"],
        verify_profiles={k: [round(v["busy_ms"], 4), v["kernels"]]
                         for k, v in prof.items() if "verify" in k},
        prove_fs_eager=spread(rep["fs_prove_ms"]),
        prove_fs_eager_busy=rep["fs_device_busy_ms"],
        prove_fs_eager_kernels=rep.get("fs_kernels"),
        prove_fs_launches=sum(rep["fs_prove_launches"].values()),
        prove_fs_graphs=spread(rep["fs_prove_graphs_ms"]),
        prove_fs_graphs_busy=round(fs_graphs["busy_ms"], 3),
        prove_fs_graphs_kernels=fs_graphs["kernels"],
        batched_replay_proofs_per_s={
            b: round(r["proofs_per_s"], 1)
            for b, r in rep["batched_replay"].items()},
        batched_eager_proofs_per_s={
            b: round(r["proofs_per_s"], 1) for b, r in rep["batched"].items()},
        batched_b16_replay_busy=round(b16["busy_ms"], 3),
        sharded_rank_ms={k: [round(w[0], 1) for w in v["wall_ms"]]
                         for k, v in rep["sharded"].items()},
        run_s=float(re.match(r"\[\s*([0-9.]+) s\]", stamped[-1]).group(1)),
        init_kernels_ms=init_kernels(lines),
        prove_fs_eager_scans=fs_scans(lines))


def fs_scans(lines):
    """{entry: [device ms, launches]} of the FS scans in the profile of one
    eager ``prove_fs`` (chip_smoke.py phase 7)."""
    line = next((ln for ln in lines
                 if "] phase 7 profile of one eager prove_fs" in ln), "")
    m = re.search(r"\(device ms, launches\): (\{.*?\})", line)
    got = ast.literal_eval(m.group(1)) if m else {}
    return {e: [round(got[e][0], 4), got[e][1]]
            for e in ("fs_sumcheck", "fs_sponge") if e in got}


def init_kernels(lines):
    """{entry: {rows: [device ms, bound ms]}} of the GKR init stages, from
    the profiled ``kernel gkr_p1_inits`` / ``gkr_p2_inits`` lines."""
    out = {}
    for entry in ("gkr_p1_inits", "gkr_p2_inits"):
        line = next((ln for ln in lines if f"] kernel {entry} (" in ln), "")
        out[entry] = {int(m.group(1)): [float(m.group(2)), float(m.group(3))]
                      for m in re.finditer(
                          r"\[(\d+), \d+\]: [\d/]+, ([0-9.]+), \d+, "
                          r"([0-9.]+) (?:bytes|operations)", line)}
    return out


def butterfly_loop(sass: str) -> dict:
    """The static size of gf_fft_tile's pass loop in the SASS: the
    four-slot kernel's (gf_fft_tile<4>) where the library has one."""
    four = sass.find("gf_fft_tileILi4E")
    body = sass[four if four >= 0 else sass.index("gf_fft_tile"):]
    nxt = body.find("Function :")
    body = body if nxt < 0 else body[:nxt]
    ins = [(int(m.group(1), 16), m.group(2), m.group(3))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                                r"([A-Z0-9]+)[^;]*?(?:0x([0-9a-f]+))?\s*;",
                                body)]
    loops = [(int(t, 16), off) for off, op, t in ins
             if op == "BRA" and t and int(t, 16) < off]

    def ops(lo, hi):
        return [op for off, op, _ in ins if lo <= off <= hi]

    def is_butterfly(lo, hi):
        c = collections.Counter(ops(lo, hi))
        return c["LDS"] >= 4 and c["STS"] >= 4 and c["LDG"] >= 2

    lo, hi = min((lp for lp in loops if is_butterfly(*lp)),
                 key=lambda lp: lp[1] - lp[0])
    inner = [len(ops(a, b)) for a, b in loops
             if lo <= a and b <= hi and (a, b) != (lo, hi)]
    return dict(butterfly_loop_instructions=len(ops(lo, hi)),
                nested_loop_instructions=inner,
                opcodes=collections.Counter(ops(lo, hi)).most_common(8))


def main():
    d = Path(sys.argv[1])
    for name in ("parent1", "change1", "change2", "parent2"):
        print(name, json.dumps(summary(d / f"pair_{name}.log")))
    sass = d / "gf_fft.sass"
    if sass.exists():
        print("gf_fft_tile", json.dumps(butterfly_loop(sass.read_text())))


if __name__ == "__main__":
    main()
