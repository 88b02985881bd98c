#!/usr/bin/env python3
"""A short check of gf_table, gf_fft and gf_fri_fold on the card, with
timed variants of the kernels' constants.

Run from the root of a checkout on a machine with a CUDA card:
``python3 scripts/check_transforms.py [NAME=VALUE,... ...]``.  It prints
the card's name and power limit, builds ``csrc/gf_chains.cu`` and
``csrc/gf_fft.cu`` (printing ptxas' registers and spills, and the SASS
size of ``gf_fft_tile`` and of its pass loop from ``cuobjdump -sass``,
and a latency probe: the cycles of a dependent field product, shuffle and
sum, and a one-warp launch's device time),
holds the entries against their plain twins at the shapes below (the
timed prove's, the batched call's, a sharded rank's, and the kernels'
edges; folds of 1 to 10 levels), then times
them (device time from torch.profiler over 20 calls after a warm-up, per
launch it recorded) against chip_smoke.py's bound (``gf_cost``).  Each
argument is one variant, ``NAME=VALUE,...``: the sources with the named
``constexpr int`` constants set (``TASK_LOG``, ``MIN_TASK_LOG``,
``TABLE_BLOCKS`` of gf_chains.cu; ``BLOCK_LOG``, ``FFT_BLOCKS``,
``FFT_PAIRS_BELOW``, ``FOLD_TILE_LOG``, ``FOLD_BLOCKS``, ``FOLD_SMS`` of
gf_fft.cu); each is built beside the others into
``build/transform_variants/``, checked against the twins and timed the
same way, in turns with the sources as they are.  Any difference
raises."""

import collections
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
from virgo_plus_tpu_torch import kernels  # noqa: E402
from virgo_plus_tpu_torch.field import chains, gf  # noqa: E402
from virgo_plus_tpu_torch.pc import fft, virgo_pc  # noqa: E402

SOURCES = ("gf_chains", "gf_fft")
ENTRIES = {"gf_table": "gf_chains", "gf_fft": "gf_fft",
           "gf_fri_fold": "gf_fft"}
VARIANTS = ROOT / "build" / "transform_variants"
REPS = 20


def variant_source(name, spec):
    """csrc/<name>.cu with those constants of ``NAME=VALUE,...`` set that it
    defines."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    for item in spec.split(","):
        const, value = item.split("=")
        src = re.sub(rf"constexpr int {const} = \d+;",
                     f"constexpr int {const} = {value};", src)
    return src


def registers(log):
    return [ln.split("ptxas info    : ")[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build_variants(specs):
    """{spec: {entry: C function}}, one nvcc a source and variant, all
    started together."""
    known = set()
    for name in SOURCES:
        known |= set(re.findall(r"constexpr int (\w+) =",
                                (kernels.CSRC / f"{name}.cu").read_text()))
    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, spec in enumerate(specs):
        for item in spec.split(","):
            if item.split("=")[0] not in known:
                raise ValueError(f"no constant {item} in {SOURCES}")
        for name in SOURCES:
            cu = VARIANTS / f"{name}_v{k}.cu"
            cu.write_text(variant_source(name, spec))
            so = VARIANTS / f"lib{name}_v{k}.so"
            cmd = kernels._command(name, so)
            cmd[cmd.index(str(kernels.CSRC / f"{name}.cu"))] = str(cu)
            cmd[1:1] = ["-I", str(kernels.CSRC)]
            procs[spec, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    out = collections.defaultdict(dict)
    for (spec, name), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec} ({name}):\n{log}")
        print("variant", spec, name, registers(log))
        lib = ctypes.CDLL(str(so))
        for entry, src in ENTRIES.items():
            if src == name:
                symbol, argtypes = kernels.SOURCES[src][entry]
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                out[spec][entry] = fn
    return out


# the latency probe: one warp runs a dependent chain of n steps between
# two clock64() reads; cycles a step = the slope over n
PROBE = r"""
#include <cuda_runtime.h>
#include "field.cuh"
using vpt::F2;
using vpt::u64;
template <int OP>
__global__ void chain(u64* io, int n) {
    F2 x = {io[0], io[1]}, y = {io[2], io[3]};
    const long long t0 = clock64();
    for (int i = 0; i < n; ++i) {
        if (OP == 0) x = vpt::mul2(x, y);
        if (OP == 1) x = vpt::mul2_split(x, y);
        if (OP == 2) x = {__shfl_sync(0xffffffffu, x.re, (threadIdx.x + 1) & 31),
                          __shfl_sync(0xffffffffu, x.im, (threadIdx.x + 1) & 31)};
        if (OP == 3) x = vpt::add2(x, y);
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0) { io[4] = x.re; io[5] = x.im; io[6] = t1 - t0; }
}
extern "C" int probe(int op, u64* io, int n, void* stream) {
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch (op) {
        case 0: chain<0><<<1, 32, 0, s>>>(io, n); break;
        case 1: chain<1><<<1, 32, 0, s>>>(io, n); break;
        case 2: chain<2><<<1, 32, 0, s>>>(io, n); break;
        default: chain<3><<<1, 32, 0, s>>>(io, n); break;
    }
    return (int)cudaGetLastError();
}
"""


def latency_probe():
    """Cycles a dependent step of mul2, mul2_split, a 64-bit shuffle pair
    and add2 (clock64 slope over chains of 64 and 576 steps), and the
    device time of a one-warp launch with no step (the launch floor)."""
    VARIANTS.mkdir(parents=True, exist_ok=True)
    cu, so = VARIANTS / "probe.cu", VARIANTS / "libprobe.so"
    cu.write_text(PROBE)
    cmd = kernels._command("probe", so)
    cmd[cmd.index(str(kernels.CSRC / "probe.cu"))] = str(cu)
    cmd[1:1] = ["-I", str(kernels.CSRC)]
    subprocess.run(cmd, check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    io = torch.tensor([3, 5, 7, 11, 0, 0, 0], dtype=torch.int64,
                      device="cuda")
    out = {}
    for op, name in enumerate(("mul2", "mul2_split", "shfl2", "add2")):
        cycles = []
        for n in (64, 576):
            fn(op, io.data_ptr(), n, kernels.stream_ptr())
            torch.cuda.synchronize()
            cycles.append(int(io[6]))
        out[name] = round((cycles[1] - cycles[0]) / 512, 1)
    floor = device_us(lambda: fn(0, io.data_ptr(), 0, kernels.stream_ptr()),
                      (), 1, ("chain",))
    out["empty launch us"] = None if floor is None else round(floor, 2)
    # the SM clock under this load: a long chain's cycles over its time
    long = device_us(lambda: fn(1, io.data_ptr(), 20000,
                                kernels.stream_ptr()), (), 1, ("chain",))
    torch.cuda.synchronize()
    out["SM MHz in a 20000-product chain"] = (
        None if long is None else round(int(io[6]) / long, 1))
    return out


def sass_summary(lib):
    """Static SASS of gf_fft_tile: its instructions, and the smallest loop
    holding four shared-memory stores and loads (the pass loop) with its
    most frequent opcodes."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    body = sass[sass.index("gf_fft_tile"):]
    nxt = body.find("Function :")
    body = body if nxt < 0 else body[:nxt]
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)[^;]*;", body)]
    jumps = [(int(m.group(2), 16), int(m.group(1), 16)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA[^;]*?0x([0-9a-f]+)",
        body)]
    loops = [(lo, hi) for lo, hi in jumps if lo < hi]
    ops = lambda lo, hi: [op for off, op in ins if lo <= off <= hi]
    passes = [lp for lp in loops if collections.Counter(ops(*lp))["STS"] >= 4
              and collections.Counter(ops(*lp))["LDS"] >= 4]
    out = {"instructions": len(ins)}
    if passes:
        lo, hi = min(passes, key=lambda lp: lp[1] - lp[0])
        out["pass_loop"] = len(ops(lo, hi))
        out["pass_loop_opcodes"] = collections.Counter(
            ops(lo, hi)).most_common(8)
    return out


def fold_sass(lib):
    """Static SASS of gf_fri_fold: its instructions and most frequent
    opcodes."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    body = sass[sass.index("gf_fri_fold"):]
    nxt = body.find("Function :")
    body = body if nxt < 0 else body[:nxt]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", body)
    return {"instructions": len(ops),
            "opcodes": collections.Counter(ops).most_common(10)}


def device_us(fn, ins, launches,
              names=("gf_table", "gf_fft_tile", "gf_fri_fold")):
    """Device time (us) of a call: the profiler's kernels of REPS calls
    after a warm-up, summed over the launches it recorded, per recorded
    launch, times the launches a call; None if it recorded under nine in
    ten of them."""
    from torch.profiler import ProfilerActivity, profile
    fn(*ins)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn(*ins)
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        if cs.is_device_row(e) and any(n in e.key for n in names):
            us += cs.device_us(e)
            count += e.count
    if count < 0.9 * REPS * launches:
        return None
    return us / count * launches


def profile_rows(fn, ins):
    """The profiler's device rows (name, calls) of REPS calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn(*ins)
        torch.cuda.synchronize()
    return [(e.key[:60], e.count) for e in prof.key_averages()
            if cs.is_device_row(e)]


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.time()
    logs = kernels.build(list(SOURCES))
    for name in SOURCES:
        print("build", name, registers(logs[name]))
    print("gf_fft_tile SASS", sass_summary(kernels._target("gf_fft")))
    print("gf_fri_fold SASS", fold_sass(kernels._target("gf_fft")))
    print("latency probe (cycles a dependent step)", latency_probe(),
          flush=True)
    variants = build_variants(sys.argv[1:])
    print(f"built in {time.time() - t0:.1f} s")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    M = gf.MOD
    canon = lambda *s: gf.tensor(rng.integers(0, M, size=s, dtype=np.uint64),
                                 dev)
    rou = gf.root_of_unity_int
    base = lambda: tuple(int(v) for v in rng.integers(0, M, 2,
                                                      dtype=np.uint64))
    fns = {"gf_table": chains.table_cuda, "gf_fft": fft.fft_cuda,
           "gf_fri_fold": virgo_pc.fold_step_cuda}
    twins = {"gf_table": chains.table_plain, "gf_fft": fft.fft_plain,
             "gf_fri_fold": virgo_pc.fold_levels_plain}
    rs = lambda n, step=1: [canon(2 * step)[::step] for _ in range(n)]

    # (what, entry, inputs): checked; the timed ones as well below
    checked = []
    for k in (0, 1, 5, 6, 7, 8, 10, 11, 13, 16, 17, 18, 20):
        checked.append((f"beta 2^{k}", "gf_table", (
            chains.BETA, canon(2), canon(2, 2 * k + 1)[:, ::2][:, :k], 1 << k,
            dev)))
    for k in (6, 10, 13):
        checked.append((f"63 beta 2^{k}", "gf_table", (
            chains.BETA, canon(2, 63), canon(2, 63, k), 1 << k, dev)))
    for k in range(0, 21):
        n = max((1 << k) - 3, 1)
        checked.append((f"powers n = {n}", "gf_table", (
            chains.POWER, base(), None, n, dev)))
    for n in (1, 100, 300):
        checked.append((f"64 tensor powers n = {n}", "gf_table", (
            chains.POWER, canon(2, 64), None, n, dev)))
    for lg in range(0, 14):
        checked.append((f"fft 2^{lg} onto 2^{lg}, 3 rows", "gf_fft", (
            canon(2, 3, 1 << lg), lg, rou(lg))))
        checked.append((f"ifft 2^{lg}, 2 rows", "gf_fft", (
            (canon(2, 2, 1 << lg),) + fft._inverse(1 << lg, rou(lg)))))
    for lg_coef, lg in ((0, 5), (1, 4), (3, 9), (7, 12), (7, 16), (16, 16),
                        (7, 19), (19, 19)):
        rows = 64 if lg < 17 else 2
        checked.append((f"fft 2^{lg_coef} onto 2^{lg}, {rows} rows", "gf_fft",
                        (canon(2, rows, 1 << lg_coef), lg, rou(lg))))
    checked.append(("strided rows onto 2^12", "gf_fft", (
        canon(2, 64, 256)[..., 128:], 12, rou(12))))
    # folds: (codeword shape, top order, levels, shards)
    for shape, lg, levels, shards in (
            ((2, 65, 2), 1, 1, (1, 0)), ((2, 65, 64), 6, 6, (1, 0)),
            ((2, 3, 1024), 10, 10, (1, 0)), ((2, 65, 2048), 12, 7, (2, 1)),
            ((2, 65, 1024), 12, 7, (4, 3)), ((2, 4, 65, 4096), 12, 7, (1, 0))):
        checked.append((f"{levels} fold levels of {shape} at {shards}",
                        "gf_fri_fold", (canon(*shape), rs(levels), lg,
                                        shards)))
    checked.append(("7 fold levels of a strided codeword", "gf_fri_fold", (
        canon(2, 65, 8192)[..., ::2], rs(7, 2), 12, (1, 0))))
    # the timed shapes: the timed prove's buckets, the batched call's
    timed = {
        "beta 2^6 (128 words)": ("gf_table", (
            chains.BETA, canon(2), canon(2, 6), 64, dev)),
        "beta 2^10 (2048 words)": ("gf_table", (
            chains.BETA, canon(2), canon(2, 10), 1024, dev)),
        "beta 2^11 (4096 words)": ("gf_table", (
            chains.BETA, canon(2), canon(2, 11), 2048, dev)),
        "beta 2^13 (16384 words)": ("gf_table", (
            chains.BETA, canon(2), canon(2, 13), 8192, dev)),
        "powers 2^18 (524288 words)": ("gf_table", (
            chains.POWER, base(), None, 1 << 18, dev)),
        "beta 2^20": ("gf_table", (
            chains.BETA, canon(2), canon(2, 20), 1 << 20, dev)),
        "powers 2^20 - 3": ("gf_table", (
            chains.POWER, base(), None, (1 << 20) - 3, dev)),
        "ifft 2^7, 64 rows": ("gf_fft", (canon(2, 64, 128),)
                              + fft._inverse(128, rou(7))),
        "ifft 2^8, 64 rows": ("gf_fft", (canon(2, 64, 256),)
                              + fft._inverse(256, rou(8))),
        "128 onto 2^12, 64 rows": ("gf_fft", (canon(2, 64, 128), 12,
                                               rou(12))),
        "128 onto 2^12, (64, 64) rows": ("gf_fft", (canon(2, 64, 64, 128),
                                                     12, rou(12))),
        "2^19 onto 2^19, 2 rows": ("gf_fft", (canon(2, 2, 1 << 19), 19,
                                               rou(19))),
        "7 fold levels of (2, 65, 4096)": ("gf_fri_fold", (
            canon(2, 65, 4096), rs(7), 12, (1, 0))),
        "1 fold level of (2, 65, 4096)": ("gf_fri_fold", (
            canon(2, 65, 4096), rs(1), 12, (1, 0))),
        "7 fold levels of (2, 16, 65, 4096)": ("gf_fri_fold", (
            canon(2, 16, 65, 4096), rs(7), 12, (1, 0))),
        "7 fold levels of (2, 64, 65, 4096)": ("gf_fri_fold", (
            canon(2, 64, 65, 4096), rs(7), 12, (1, 0)))}
    checked += [(what, e, ins) for what, (e, ins) in timed.items()]

    def held(tag):
        for what, entry, ins in checked:
            got = cs.flatten(fns[entry](*ins))
            want = cs.flatten(twins[entry](*ins))
            torch.cuda.synchronize()
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{tag}: {entry} differs from its twin "
                                   f"at {what}")
        print(f"{tag}: {len(checked)} calls == twins", flush=True)

    props = torch.cuda.get_device_properties(0)
    clock = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0])
    int32_rate = (cs.INT32_OPS_PER_CLK_SM * props.multi_processor_count
                  * clock * 1e6)

    def times(tag):
        for what, (entry, ins) in timed.items():
            launches = cs.gf_launches(entry, ins)
            us = device_us(fns[entry], ins, launches)
            if us is None:
                print(f"time {tag} {entry} {what}: the profiler missed "
                      f"launches: {profile_rows(fns[entry], ins)}")
                continue
            ms = us / 1e3
            nbytes, ops = cs.gf_cost(entry, ins)
            bound = max(nbytes / cs.HBM_BYTES_S, ops / int32_rate) * 1e6
            print(f"time {tag} {entry} {what}: {ms * 1e3:.2f} us, bound "
                  f"{bound:.2f} us, share {bound / (ms * 1e3):.3f}",
                  flush=True)

    held("source")
    times("source")
    source = {e: kernels.lib(e) for e in ENTRIES}
    for spec, vfns in variants.items():
        kernels._FNS.update(vfns)
        held(f"variant {spec}")
        times(spec)
        kernels._FNS.update(source)
        times("source")
    print("OK")


if __name__ == "__main__":
    main()
