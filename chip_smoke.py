#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Virgo++ prover on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
card and the CUDA toolkit (``nvcc``); it imports neither JAX nor the JAX
package.  Phases, one line each, any failure exits non-zero:

1. the card's name and power limit; build the kernels (one ``nvcc`` per
   source, started together) into ``build/torch_kernels/``;
2. K1 (sumcheck fold) against its plain twin, bit for bit, on either side
   of the shared-memory boundary and at the sharded provers' shapes (the
   local folds and the 2^1-2^3-entry tails); each call's device launches
   equal ``sumcheck.fold_launches(bl)``;
3. K2's three entries against their plain twins: single SHA3-256 hashes
   (also against hashlib), the fused 65-step leaf chain at the main path's
   widths, and the Merkle forest on the main path's forest, on one tree of
   8192 leaves (many subtree blocks under one top) and on other mixes, each
   forest in one launch; then the field ops (X1: ``gf_mul``, and
   ``gf_lin`` with each of its four op codes) against their plain versions
   at the paths' call patterns (same shape, a (2, K, 1) challenge against
   (2, K, n), strided ``x[..., 0::2]``, a scalar (2,), rank 5, empty, a
   mesh's (bl, K, 2, 3) round polynomials for the sums, and sizes up to
   2^18), on canonical and on any int64 inputs, one launch a call and none
   for an empty output; the wrappers' output shape against
   ``torch.broadcast_shapes``, with the host time of each; then the field
   chains (X1: ``gf_table``, ``gf_segsum``) against their plain twins on
   canonical inputs: beta tables of 2^0 to 2^20 entries (either side of a
   warp task and of a block, strided challenges, 3 and 63 tables), power
   tables of a by-value base (its squarings from the host; n = 2^0 to
   2^20, and up to 2^20 - 3, not a power of two) and of tensor bases,
   tree sums of 0 to
   2^18 terms (rank 2 and 3, transposed), scatter plans with empty
   segments, one segment of 2^18 terms, a skewed plan and mean segment
   lengths on either side of the summers' thresholds; then the transforms
   (X1: ``gf_fft``, ``gf_fri_fold``) against their plain twins: 128
   coefficients onto 2^12 points at 64 rows and at leads (16, 64) and
   (64, 64), onto 2^16 and 2^19, IFFTs at 2^7, 2^8 and 2^11 (one launch)
   and at 2^12 and 2^16 (two launches), 2^19 coefficients onto 2^19
   points (two launches), 2^1 to 2^12 onto as many points (odd and even
   stage counts), strided and transposed rows, one coefficient, one
   point, an empty lead, and a root whose twiddles a capture asked for
   first (it must raise, then run eagerly); folds of 65 slices at N = 2,
   64 and 4096, a
   B = 64 batch, strided, empty; launches as ``fft.launches(lg_coef)``,
   one a fold; the largest shapes timed against their bounds; then the
   GKR init stages (X1: ``gkr_p1_inits``, ``gkr_p2_inits``) against their
   plain twins, one launch a stage, in the proves of three fixed
   circuits: randomize(4, 3), and randomize circuits with assert gates
   and segments long enough for a warp (lead (3,)) and for a block (lead
   (2, 2), and (5, 13): 65 rows, several row tiles and a short last
   pass), every summer class taken; then a circuit layer's evaluation
   (X1: ``gf_eval_layer``) against its plain twin at (rows, gates) (1,
   8192) and (64, 8192) and on every layer of a circuit with a layer of
   1,000 gates, unary gates and right inputs from layer 0 (lead () and
   (3,)), the whole evaluation equal to the CPU's with every padding
   word untouched, and the fft_gkr stage tables (X1:
   ``fg_stage_tables``) against their twin at lg = 1, 7 and 12 in both
   phases, the fft_gkr circuit (X1: ``fg_build_circuit``) at lg = 0, 1, 7
   and 12 (one launch) and 13 and 18 (``fft_gkr.circuit_launches(lg)``),
   and the public commit's virtual oracle (X1: ``pc_virtual_oracle``) at
   2^12 columns with no batch axis and at B = 4 and 64, and on a sharded
   rank's columns (rank 1 of 2, rank 3 of 4, its own tables);
4. prove ``tests/data/small1200.pws`` on the card: pinned transcript hash,
   Merkle roots and proof sizes; the port's verify accepts.  A card proof
   of ``randomize(3, 7, seed=21)`` equals the CPU proof in every field;
5. full width, ``randomize(14, 13, seed=0)``: a first driver prove (which
   builds the driver's graphs) with every kernel call's inputs, outputs
   and launches recorded, each recorded call then held against its plain
   twin on the same inputs; then the main path, one more prove (through
   the graphs' replays) and its verify, with the launch counters reset
   just before and read just after; both proofs are equal, the verify
   accepts, and the end's profile of a driver.prove must see exactly the
   prove's counted launches.  The first verify, which builds the
   verifier's graphs, is recorded with the first prove.  A tampered proof
   is rejected.  The timed prove (fused.prove_e2e
   + the fft_gkr tape) is recorded and held the same way, and must launch
   K1, K2's chain and forest kernels (these once each) and the field ops,
   with no plain twin call; its tape equals the CPU's, and its launches
   by entry are printed.  Wall times of the timed prove, verify and driver prove,
   every run listed;
6. where the time goes: synchronised prove spans, verify spans, and (at
   the end) a profile of one timed prove;
7. Fiat-Shamir: on ``randomize(3, 7, seed=9)`` and small1200 the card's
   ``driver.prove_fs`` equals the CPU's in every proof array and the card's
   ``verify_fs`` accepts it.  Full width: a first ``prove_fs`` and
   ``verify_fs`` (which build the FS and verifier graphs) with every kernel
   call recorded and held against its plain twin, then the main path, one
   more ``prove_fs`` (equal to the first) and its ``verify_fs``, with the
   counts reset just before and read just after; the FS prove must launch
   every entry but the GKR init stages (its walk keeps per-layer inits;
   the sponge's SHA3 at N = 1) with no plain twin call;
   proofs with one p1_polys coefficient or one all_sum entry changed are
   rejected; eager wall times of 2 ``prove_fs`` and 2 ``verify_fs`` runs,
   their spans, and (at the end) a profile of one eager ``prove_fs``;
8. batched proving (``parallel.sharded.make_batched_full_prover``, i.e.
   ``fused.prove_e2e`` on a (2, B, N) witness batch) at full width: a B = 1
   batched call equals ``prove_e2e`` on the same witness in every array,
   and at B = 16 instances 0 and 15 each equal ``prove_e2e`` of their own
   witness; every kernel call of one batched call at B = 4 and of one at
   B = 64 is recorded and held against its plain twin (a field op's twin
   runs as the call returns, keeping only a count of differing words on
   the card), with no plain twin call; the
   launches per batched call are the same at every B in (1, 4, 16, 64)
   (one chain, one forest); wall times (2 runs after a warm-up), proofs
   per second and peak device memory at each B, and (at the end) a
   profile of one batched call at B = 16;
9. the sharded provers (``parallel/gkr_sharded``, ``parallel/fs_sharded``)
   at full width, S ranks of ``parallel.mesh.spawn`` sharing the one card
   over gloo: the glibc ``prove_sharded`` at S = 2 and S = 4 and
   ``prove_fs_sharded`` at S = 2 each equal the single-device card proof of
   phase 5 or 7 in every array (meta adds ``mesh_shards``) and verify, and a
   tampered one is rejected; each rank proves with its launch counts reset
   just before and read just after, rank 0 recording every kernel call and
   holding it against its plain twin; every rank makes the same K1 and K2
   launches (the field ops' follow each rank's share), launches every
   entry but the GKR init stages, and makes no plain twin call; launches
   per rank per entry, the
   backend, the
   walls of every rank and each rank's peak device memory are printed;
10. the compiled programs as CUDA graphs (``graphs.py``): the replays of
   ``fused.make_e2e_prover`` + ``make_fg_tape``, the driver's
   ``make_evaluator`` and (unstaged) ``make_prover``, a staged
   ``make_prover``, the driver's four ``VirgoPC.compile`` programs and
   ``make_batched_full_prover`` at every B each equal the eager call
   (``graphed=False`` makers) in every array (every kernel call of the
   provers' eager calls, of the staged prover's warm-up and of the e2e
   and tape graphs' warm-ups and eager calls held against its twin), with
   launches per replay
   equal to the eager call's, no plain twin call, and each graph's kernel
   nodes (read from the cudaGraph_t through the driver API) equal to the
   launches its capture counted, the evaluator's, tape's and e2e
   prover's printed; the e2e + tape graphs and the batched
   graph at B = 4 replayed on another witness and other challenges equal
   the eager call on those, and leave the earlier replay's result as it
   was; capture + instantiate seconds and pool bytes per graph; each
   prover stage's replay time against the one graph's; the device memory
   ``graphs.release`` gives back; walls of 5 timed-prove replays, of
   ``driver.prove`` through the graphs and eagerly, of compile_prover +
   one prove (graphed and eager, as a process that proves once), and of
   the batched replays at every B;
11. the FS and verifier programs as CUDA graphs: ``fs.make_fs_prover`` and
   ``make_fs_pc_prover``, staged and unstaged, each replay equal to the
   ``graphed=False`` call in every array (launches and kernel nodes
   checked as in phase 10) and, on another witness, to the eager call on
   it, leaving the earlier result as it was; the same for
   ``protocol.make_verifier`` staged and unstaged, with and without an
   output block, on phase 5's proof; each graphed verifier rejects a proof
   with one p1_polys coefficient changed and a wrong output block by a
   replay (no new holder), and the graphed ``verify_fs`` a tampered FS
   proof; walls of each FS program's replays and of 5 ``driver.prove_fs``,
   ``driver.verify`` (with ``last_split``) and ``driver.verify_fs`` through
   the graphed ``compile_prover``, beside phases 5 and 7's eager walls; the
   memory ``graphs.release`` gives back.

``driver.prove``, ``prove_fs``, ``verify`` and ``verify_fs`` run through
the graphs of ``driver.compile_prover``, so phases 4-7 check them too: the
first call on a compiled circuit makes an eager warm-up call, the capture
and a replay, and the kernel calls the Recorder holds against their twins
are the warm-up's; the main paths' counts are read from a second call.
Phases 5-7 time the eager walls through a ``graphed=False`` twin of the
compiled prover.  Phase 8 drives the eager batched prover
(``graphed=False``), phase 10 its graphs.

Phase 4 starts by building the native C++ frontend into ``build/native/``
and holding its small1200 circuit against the Python frontend's, field by
field; from there on ``driver.load_circuit`` uses it.  Then each kernel
entry's device time per call at every shape the glibc, FS, batched and
sharded paths gave it, from the profiler (a profile that drops launches
is repeated, up to 10 times, and the run fails if none holds every
launch), and at phase 3's fixed shapes of ``fg_build_circuit`` and
``pc_virtual_oracle``, beside its bound and its plain
twin (a sharded shape on random inputs of that shape: rank 0's calls are
held in its own process), and last
the whole-call profiles (three eager calls, then one replay of the timed
prove's graphs, one batched replay at B = 16 and one ``driver.prove`` and
one ``driver.prove_fs`` through their graphs, each failing unless the
profiler's kernels of every port entry equal the counted launches): a
large trace makes every later short profile miss launches.  The X1
calls (field ops, chains and transforms) are grouped by their output's
words (a segment sum's by the words it reads), rounded up to a power of
two, in the listings; a bucket is profiled on the first call recorded in
it (its strides kept), and X1's device time on a path is the whole
profile's.
Each path's bound sums every recorded call's.  A line
lists every entry's launches on every path.  The last lines are the card
line, one JSON object
with every kernel entry's numbers (``launches``: the glibc, FS and B = 4
batched runs and rank 0 of the three sharded runs together), and
``{"ok": true, "device": {...}}``.
"""

import collections
import dataclasses
import hashlib
import io
import json
import math
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

# each kernel entry's device kernels, as the profiler names them
KERNEL_NAMES = {"sumcheck_fold": ("sumcheck_fold",),
                "sha3_256_x64": ("sha3_256_x64",),
                "sha3_chain_x64": ("sha3_chain_x64",),
                "merkle_forest": ("merkle_forest",),
                "gf_mul": ("gf_mul",),
                "gf_lin": ("gf_lin",),
                "gf_table": ("gf_table",),
                "gf_segsum": ("gf_segsum",),
                # (every kernel of csrc/gf_fft.cu carries "gf_fft" in its
                # mangled name: nvcc names the file's anonymous namespace)
                "gf_fft": ("gf_fft_tile",),
                "gf_fri_fold": ("gf_fri_fold",),
                # (csrc/gkr_inits.cu's namespace carries "gkr_inits", which
                # neither name matches)
                "gkr_p1_inits": ("gkr_p1_inits",),
                "gkr_p2_inits": ("gkr_p2_inits",),
                # (the namespaces carry "circuit_eval", "fft_gkr" and
                # "virgo_pc", which no name matches)
                "gf_eval_layer": ("gf_eval_layer",),
                "fg_stage_tables": ("fg_stage_tables",),
                "fg_build_circuit": ("fg_build_",),
                "pc_virtual_oracle": ("pc_virtual_oracle",)}
# X1: the elementwise field ops, the field chains and the transforms,
# called thousands of times a prove (a batched transform reads up to 2^25
# words): each call's twin runs as it returns (Recorder), and its calls
# are grouped in size buckets
ELEMENTWISE = ("gf_mul", "gf_lin")
GF_ENTRIES = ELEMENTWISE + ("gf_table", "gf_segsum", "gf_fft",
                            "gf_fri_fold")
# X1: the GKR init stages, one launch a stage on the glibc paths (the FS
# and sharded provers keep their own per-layer inits)
INIT_ENTRIES = ("gkr_p1_inits", "gkr_p2_inits")
# X1: a circuit layer's evaluation (in place in the values buffer, so its
# twin runs on a copy of the input), the fft_gkr tape's stage tables and
# circuit, and the public commit's virtual oracle: one launch a layer, a
# phase, a tape (circuit_launches(lg) above lg = 12) and a commit
FUSED_ENTRIES = ("gf_eval_layer", "fg_stage_tables", "fg_build_circuit",
                 "pc_virtual_oracle")
IN_PLACE = ("gf_eval_layer",)
# the entries every glibc prove must launch (sha3_256_x64 is the FS
# sponge's: every FS prove launches it and these but the GKR init stages)
PATH_ENTRIES = ("sumcheck_fold", "sha3_chain_x64", "merkle_forest",
                *GF_ENTRIES, *INIT_ENTRIES, *FUSED_ENTRIES)
# a batched call has no fft_gkr tape
BATCH_ENTRIES = tuple(e for e in PATH_ENTRIES
                      if e not in ("fg_stage_tables", "fg_build_circuit"))
FS_ENTRIES = tuple(e for e in KERNEL_NAMES if e not in INIT_ENTRIES)
_K1 = ("virgo_plus_tpu_torch/csrc/sumcheck_fold.cu",
       "virgo_plus_tpu/pallas_kernels/sumcheck_fold.py:118")
_K2 = ("virgo_plus_tpu_torch/csrc/keccak.cu",
       "virgo_plus_tpu/pallas_kernels/keccak_chain.py:100")
# X1 is no Pallas kernel: XLA's fusion of the JAX gf ops (and of their
# chains: the beta tables' doubling loop, the scatter's prefix sum) inside
# the jits
_X1 = "virgo_plus_tpu_torch/csrc/gf_ops.cu"
_X1C = "virgo_plus_tpu_torch/csrc/gf_chains.cu"
_X1F = "virgo_plus_tpu_torch/csrc/gf_fft.cu"
_X1I = "virgo_plus_tpu_torch/csrc/gkr_inits.cu"
_X1E = "virgo_plus_tpu_torch/csrc/circuit_eval.cu"
_X1T = "virgo_plus_tpu_torch/csrc/fft_gkr.cu"
_X1V = "virgo_plus_tpu_torch/csrc/virgo_pc.cu"
SOURCE_AND_REPLACES = {"sumcheck_fold": _K1, "sha3_256_x64": _K2,
                       "sha3_chain_x64": _K2, "merkle_forest": _K2,
                       "gf_mul": (_X1, "virgo_plus_tpu/field/gf.py:151"),
                       "gf_lin": (_X1, "virgo_plus_tpu/field/gf.py:131"),
                       "gf_table": (_X1C, "virgo_plus_tpu/gkr/beta.py:30"),
                       "gf_segsum": (_X1C,
                                     "virgo_plus_tpu/gkr/sumcheck.py:96"),
                       "gf_fft": (_X1F, "virgo_plus_tpu/pc/fft.py:38"),
                       "gf_fri_fold": (_X1F,
                                       "virgo_plus_tpu/pc/virgo_pc.py:197"),
                       "gkr_p1_inits": (_X1I,
                                        "virgo_plus_tpu/gkr/protocol.py:698"),
                       "gkr_p2_inits": (_X1I,
                                        "virgo_plus_tpu/gkr/protocol.py:784"),
                       "gf_eval_layer": (
                           _X1E, "virgo_plus_tpu/circuits/compile.py:185"),
                       "fg_stage_tables": (
                           _X1T, "virgo_plus_tpu/pc/fft_gkr.py:202"),
                       "fg_build_circuit": (
                           _X1T, "virgo_plus_tpu/pc/fft_gkr.py:107"),
                       "pc_virtual_oracle": (
                           _X1V, "virgo_plus_tpu/pc/virgo_pc.py:142")}
# profiled calls per shape
PROFILE_REPS = {"sumcheck_fold": 20, "sha3_256_x64": 20,
                "sha3_chain_x64": 5, "merkle_forest": 20, "gf_mul": 20,
                "gf_lin": 20, "gf_table": 20, "gf_segsum": 20, "gf_fft": 20,
                "gf_fri_fold": 20, "gkr_p1_inits": 20, "gkr_p2_inits": 20,
                "gf_eval_layer": 20, "fg_stage_tables": 20,
                "fg_build_circuit": 20, "pc_virtual_oracle": 20}
GF_MUL_INT32_OPS = 6         # an output word of a product: 12 32x32
                             # partials an element of two words
GF_LIN_INT32_OPS = 6         # an output word of a sum: a 64-bit add,
                             # compare and select (gf_segsum: a term of a
                             # row)
GF_TABLE_INT32_OPS = 6       # an output word of a table: one product an
                             # entry, as gf_mul
GF_FFT_INT32_OPS = 36        # a butterfly: a product (2 words) and a sum
                             # and a difference (4 words)
GF_FOLD_INT32_OPS = 72       # an output element of a fold: two products,
                             # three sums and the halving (a product)
GF_PRODUCT_INT32_OPS = 12    # a GF(p^2) product (two words, as gf_mul)
GF_SUM_INT32_OPS = 12        # a GF(p^2) sum (two words, as gf_lin)
# a GKR init term's products and sums a row: phase 1 four products, two
# inner sums and two accumulations; phase 2 five and four (an assert gate
# one product more); a Liu term one accumulation
INIT_TERM_OPS = {"gkr_p1_inits": (4, 4), "gkr_p2_inits": (5, 4)}
# products and sums of a gate a row (gf_eval_layer), of an item of each
# phase (fg_stage_tables)
EVAL_OPS = (4, 3)
STAGE_OPS = {1: (2, 2), 2: (4, 2)}
# products and sums of an element of the virtual oracle (pc_virtual_oracle)
ORACLE_OPS = (4, 2)
POINTS = 64                  # the fft_gkr circuit's evaluation points
BROADCAST_REPS = 2000        # rounds of phase 3's output-shape timing
# the timed prove's forest: the l and h trees and the 7 FRI level trees
MAIN_FOREST = [2048, 2048, 1024, 512, 256, 128, 64, 32, 16]
CHAIN_STEPS = 65

TIMED_RUNS = 5               # wall-clock runs of the timed prove
VERIFY_RUNS = 5              # ... of driver.prove and the graphed paths
EAGER_VERIFY_RUNS = 3        # ... of the eager driver.verify
FS_RUNS = 2                  # ... of the eager prove_fs and verify_fs
BATCHES = (1, 4, 16, 64)     # witnesses per batched call (phase 8)
BATCH_RUNS = 2               # wall-clock runs of a batched call per B
PROFILED_BATCH = 16          # B of the profiled batched call
SHARDED = ((2, ("glibc", "fs")), (4, ("glibc",)))   # S, transcripts
SHARDED_RUNS = 1             # timed proves per rank after the recorded one
# phase 3's fixed shapes of the fused entries that the paths meet at one
# size only, also profiled with the paths' shapes: the fft_gkr circuit at
# lg = 0, 1, 7, 12 (one launch) and 13, 18 (lg + 3 launches), the virtual oracle
# at 2^12 columns (no batch axis, B = 4, 64) and a sharded rank's columns
# (rank 1 of 2, rank 3 of 4)
ORACLE_RANKS = ((2, 1), (4, 3))
FIXED_SHAPES = {"fg_build_circuit": [(lg,) for lg in (0, 1, 7, 12, 13, 18)],
                "pc_virtual_oracle": [(1, 4096), (4, 4096), (64, 4096)]
                + [(1, 4096 // S) for S, _ in ORACLE_RANKS]}
# K1 at the sharded provers' shapes: the local folds of randomize(14, 13)'s
# five table groups at S = 2 and 4, and tails of 1-3 bits
K1_SHARDED = ([(bl - s, k) for s in (1, 2) for bl, k in
               ((13, 26), (10, 63), (11, 22), (12, 5), (13, 1))]
              + [(b, k) for b in (1, 2, 3) for k in (1, 5, 22, 26, 63)])


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def say(msg, stamp=True):
    """Print a line, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}" if stamp else msg,
          flush=True)


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
    """Time of one call between CUDA events around `reps` calls back to
    back: the plain twins' time, whose many small kernels wait on the
    host's issue rate, and the device time of a call that takes longer on
    the card than its host issue; never a short kernel's device time."""
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


def device_us(e):
    """A profiler row's own device time in microseconds."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def is_device_row(e):
    return "CUDA" in str(getattr(e, "device_type", "")) and device_us(e) > 0


def profiled_ms(torch, fn, reps, names, launches, tries=10):
    """Device time (ms) per call of the kernels whose names contain one of
    `names`, from torch.profiler (device activity only) over `reps` calls
    of fn after one warm-up call, each making `launches` device launches.
    A profile that missed any of those launches (the profiler drops one now
    and then, most often on a loaded host) is repeated; None after `tries`
    of them, and the caller fails."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = count = 0
        for e in prof.key_averages():
            if is_device_row(e) and any(n in e.key for n in names):
                us += device_us(e)
                count += e.count
        if count == reps * launches:
            return us / 1e3 / reps
    return None


def flatten(x):
    """A wrapper's output (tensor, tuple or list of them) as a tuple."""
    if isinstance(x, (tuple, list)):
        return tuple(t for part in x for t in flatten(part))
    return (x,)


def tree_tensors(x):
    """The tensors of a result (tuples, lists, dicts, dataclasses), in
    order; None where a field is None."""
    if x is None or hasattr(x, "data_ptr"):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tree_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tree_tensors(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in tree_tensors(getattr(x, f.name))]
    return []


def same_arrays(torch, a, b):
    """(number of arrays, whether every array of two results is equal)."""
    xs, ys = tree_tensors(a), tree_tensors(b)
    ok = len(xs) == len(ys) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and x.shape == y.shape
                                      and torch.equal(x, y))
        for x, y in zip(xs, ys))
    return len(xs), ok


def graph_kernel_nodes(graph):
    """A captured graph's kernel nodes by the port's entry whose name they
    carry ("other" for the rest), read through the driver API from the
    cudaGraph_t that graphs.py keeps; None without one."""
    import ctypes
    if not hasattr(graph, "raw_cuda_graph"):
        return None
    try:
        handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    except RuntimeError:
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        return None
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    counts = collections.Counter({e: 0 for e in KERNEL_NAMES})
    counts["other"] = 0
    kind = ctypes.c_int()
    params = (ctypes.c_uint64 * 16)()      # CUDA_KERNEL_NODE_PARAMS_v2
    name = ctypes.c_char_p()
    for node in nodes:
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                 # not CU_GRAPH_NODE_TYPE_KERNEL
            continue
        name.value = None
        cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params)
        func, kern = params[0], params[7]
        if not (func and cu.cuFuncGetName(ctypes.byref(name),
                                          ctypes.c_void_p(func)) == 0):
            if not (kern and cu.cuKernelGetName(
                    ctypes.byref(name), ctypes.c_void_p(kern)) == 0):
                return None
        label = (name.value or b"").decode()
        counts[next((e for e, names in KERNEL_NAMES.items()
                     if any(k in label for k in names)), "other")] += 1
    return counts


def _seg_terms(ins):
    """(rows, terms a row, segments) of a gf_segsum call (x, idx, starts,
    ends): the terms this call's plan sums."""
    x, idx, starts, ends = ins
    rows = math.prod(x.shape[:-1])
    if starts is None:
        return rows, x.shape[-1], 1
    terms = (idx.numel() if idx is not None
             else int((ends - starts).sum()))
    return rows, terms, starts.numel()


def gf_words(entry, ins):
    """The output's words (int64) of an X1 call: gf_mul (x, y), gf_lin (op,
    x, y), gf_table (op, a, r, n, device), gf_segsum (x, idx, starts,
    ends), gf_fft (coefficients, log2 of the order, root[, scale]),
    gf_fri_fold (codeword, w, r), the elementwise ops' from torch's own
    broadcast rule."""
    import torch
    if entry == "gf_mul":
        return 2 * math.prod(torch.broadcast_shapes(ins[0].shape[1:],
                                                    ins[1].shape[1:]))
    if entry == "gf_table":
        a, n = ins[1], ins[3]
        return 2 * n * (math.prod(a.shape[1:]) if hasattr(a, "shape")
                        else 1)
    if entry == "gf_segsum":
        rows, _, segments = _seg_terms(ins)
        return rows * segments
    if entry == "gf_fft":
        return ins[0].numel() // ins[0].shape[-1] << ins[1]
    if entry == "gf_fri_fold":
        return ins[0].numel() // 2
    x, y = ins[1], (ins[2] if len(ins) > 2 else None)   # (op, x) if unary
    return math.prod(x.shape if y is None
                     else torch.broadcast_shapes(x.shape, y.shape))


def gf_launches(entry, ins):
    """The launches the rule gives an X1 call: gf_fft's
    ``fft.launches(lg_coef)``, one for the others; none for an empty
    output."""
    if not gf_words(entry, ins):
        return 0
    if entry == "gf_fft":
        from virgo_plus_tpu_torch.pc import fft
        return fft.launches(ins[0].shape[-1].bit_length() - 1)
    return 1


def gf_size(entry, ins):
    """The words an X1 call's size bucket counts: its output's, or the
    terms it reads (gf_segsum)."""
    if entry == "gf_segsum":
        rows, terms, _ = _seg_terms(ins)
        return rows * terms
    return gf_words(entry, ins)


def gf_bucket(words):
    """(2^k,) for an X1 call of more than 2^(k-1) and at most 2^k words
    (gf_size's; (0,) when none)."""
    return (1 << (words - 1).bit_length() if words else 0,)


def gf_cost(entry, ins):
    """(bytes, 32-bit integer operations) of one X1 call on `ins`: each
    input (as the view the kernel reads) read once, the output written
    once; a segment sum's terms read once a row, with their index."""
    words = gf_words(entry, ins)
    if entry == "gf_segsum":
        rows, terms, segments = _seg_terms(ins)
        x, idx, starts, _ = ins
        read = rows * terms + (terms if idx is not None else 0) + (
            2 * segments if starts is not None else 0)
        return 8 * (read + words), GF_LIN_INT32_OPS * rows * terms
    if entry == "gf_table":
        read = sum(t.numel() for t in (ins[1], ins[2])
                   if hasattr(t, "numel"))
        return 8 * (read + words), GF_TABLE_INT32_OPS * words
    if entry == "gf_fft":
        # the coefficients read, the evaluations written (the twiddles are
        # gf_table's); words / 4 butterflies a stage, and the 1/n product
        lg_coef = ins[0].shape[-1].bit_length() - 1
        scaled = len(ins) > 3 and ins[3] is not None
        return 8 * (ins[0].numel() + words), (
            GF_FFT_INT32_OPS * words // 4 * lg_coef
            + (GF_MUL_INT32_OPS * words if scaled else 0))
    if entry == "gf_fri_fold":
        return (8 * (ins[0].numel() + ins[1].numel() + 2 + words),
                GF_FOLD_INT32_OPS * words // 2)
    read = [t for t in ins if hasattr(t, "numel")]   # y is None if unary
    ops = GF_MUL_INT32_OPS if entry == "gf_mul" else GF_LIN_INT32_OPS
    return 8 * (sum(t.numel() for t in read) + words), ops * words


def init_reads(plan, rows):
    """(values columns a row, c0 columns, beta entries) that one GKR init
    call of `plan` reads, each counted once: phase 1 the y gathers and the
    previous layers' blocks, the bg, bsig and Liu bt entries; phase 2 the
    masked values[dg], the bg and bu entries and the claims; both the
    assert_r and stacked-challenge columns of c0."""
    import torch
    from virgo_plus_tpu_torch.gkr import inits
    tab = plan.tab.cpu()
    starts = plan.starts.cpu().long()
    rec = tab[plan.slot_tab.cpu().long()]
    s = torch.arange(plan.n_slots) - rec[:, inits.T_SLOT]
    term = rec[torch.repeat_interleave(torch.arange(plan.n_slots),
                                       starts[1:] - starts[:-1])]
    gate = plan.gate.cpu().long() & (inits.ASSERT_BIT - 1)
    idx = plan.idx.cpu().long()
    refs = [term[:, inits.T_BG] + gate]
    asserts = tab[:, inits.T_ASSERT]
    c0_cols = [plan.rs[0].cpu().long(), asserts[asserts >= 0]]
    if plan.stage == 1:
        live = s < rec[:, inits.T_SIZE]
        refs += [(rec[:, inits.T_B2] + s)[live], plan.liu_ref.cpu()]
        cols = torch.cat([idx, rec[:, inits.T_VOFF] + s])
    else:
        refs.append(term[:, inits.T_B2] + idx)
        dg = plan.dg.cpu().long()
        cols = dg[dg >= 0]
        layers = torch.unique(tab[:, inits.T_CLAIM])
        c0_cols.append(plan.nc_static + (layers[:, None] * rows
                                         + torch.arange(rows)).reshape(-1))
    n = lambda xs: int(torch.unique(torch.cat(xs)).numel())
    return n([cols]), n(c0_cols), n(refs)


def init_cost(entry, ins):
    """(bytes, 32-bit integer operations) of one GKR init call (plan,
    values, c0, betas): the values, c0 words and beta entries it gathers
    (init_reads) and the plan tensors its kernel reads, each read once,
    the output buffer written once; each term's products and sums on
    each row."""
    plan, values, _c0, _betas = ins
    rows = math.prod(values.shape[1:-1])
    cols, c0_cols, entries = init_reads(plan, rows)
    read = 16 * (rows * cols + c0_cols + entries)
    read += sum(t.numel() * t.element_size()
                for t in (plan.tab, plan.slot_tab, plan.starts, plan.coef,
                          plan.idx, plan.gate, plan.lists, plan.rs))
    read += sum(t.numel() * t.element_size()
                for t in ((plan.liu_starts, plan.liu_ref) if plan.stage == 1
                          else (plan.dg,)))
    products, sums = INIT_TERM_OPS[entry]
    asserts = int((plan.gate < 0).sum())
    ops = rows * (GF_PRODUCT_INT32_OPS * (products * plan.n_terms + asserts)
                  + GF_SUM_INT32_OPS * (sums * plan.n_terms + plan.n_liu))
    return read + 8 * plan.out_words(rows), ops


def fused_cost(entry, ins):
    """(bytes, 32-bit integer operations) of one gf_eval_layer call
    (values, x_idx, y_idx, co, x_off, out_off), fg_stage_tables call
    (phase, bg, xp, src, vu, dep0), fg_build_circuit call (build_cost) or
    pc_virtual_oracle call (l, q, h, c0, srec, xn1, inv_x: l's and h's data
    slices, q's 64 slices, c0 and both tables read, vo and h_full written;
    ORACLE_OPS an element): each word read once (a layer's
    coefficients and indices, the distinct values columns it gathers on
    each row; the stages' bg tables, the V or bu words and twiddles their
    items take, vu), each output word written once (a layer's gates on
    each row; both tables of every stage); the products and sums of each
    gate a row or item."""
    import torch
    if entry == "fg_build_circuit":
        return build_cost(ins[0])
    if entry == "pc_virtual_oracle":
        l_eval, _q, h_eval, c0, _srec, _xn1, _inv = ins
        cols = l_eval.shape[-1]
        elems = h_eval.numel() // 2
        products, sums = ORACLE_OPS
        return (8 * (2 * (2 * elems + POINTS * cols + 2 * cols) + c0.numel()
                     + 2 * l_eval.numel()),
                elems * (GF_PRODUCT_INT32_OPS * products
                         + GF_SUM_INT32_OPS * sums))
    if entry == "gf_eval_layer":
        values, x_idx, y_idx, co, x_off, _ = ins
        rows = values.numel() // (2 * values.shape[-1])
        size = x_idx.numel()
        cols = int(torch.unique(torch.cat([x_idx + x_off, y_idx])).numel())
        products, sums = EVAL_OPS
        return (16 * rows * (cols + size) + 8 * (co.numel() + 2 * size),
                rows * size * (GF_PRODUCT_INT32_OPS * products
                               + GF_SUM_INT32_OPS * sums))
    phase, bg, _xp, _src, _vu, dep0 = ins
    stages, n = bg.shape[1], bg.shape[2]
    items = stages * n // 2
    twiddles = sum(n >> (dep + 1) for dep in range(dep0, dep0 + stages))
    read = bg.numel() + 2 * (items + twiddles + (stages if phase == 2
                                                 else 0))
    products, sums = STAGE_OPS[phase]
    return (8 * (read + 4 * stages * n),
            items * (GF_PRODUCT_INT32_OPS * products
                     + GF_SUM_INT32_OPS * sums))


def build_cost(lg):
    """(bytes, 32-bit integer operations) of a 2^lg-point fft_gkr circuit:
    r, the points and the twiddles read, every layer and the power table
    written; the tensor layers' 2(n - 1) products, each ifft stage's n / 2
    products and n sums, the scale's n products, each point's n - 1 power
    products and lg squarings, its n expansion products and n - 1 sums."""
    n = 1 << lg
    words = 2 * ((2 * n - 1) + (lg + 1) * n + 2 * POINTS * n + POINTS)
    products = (2 * (n - 1) + lg * n // 2 + n
                + POINTS * (n - 1 + lg) + POINTS * n)
    sums = lg + lg * n + POINTS * (n - 1)
    return (8 * (2 * (lg + POINTS + n - 1) + words),
            GF_PRODUCT_INT32_OPS * products + GF_SUM_INT32_OPS * sums)


def shape_of(entry, ins):
    """(bl, K) of a K1 call; (N,) of a SHA3 call; (steps, leaves) of a
    chain call; the tree sizes of a forest call; (rows, slots) of a GKR
    init call; (rows, gates) of a circuit layer; (phase, stages, lg) of a
    stage tables call; (lg,) of an fft_gkr circuit; (instances, columns) of
    a virtual oracle (a field op's is its gf_bucket)."""
    if entry == "fg_build_circuit":
        return (ins[0],)
    if entry == "pc_virtual_oracle":
        return (math.prod(ins[0].shape[1:-2]), ins[0].shape[-1])
    if entry == "gf_eval_layer":
        return (ins[0].numel() // (2 * ins[0].shape[-1]), ins[1].numel())
    if entry == "fg_stage_tables":
        return (ins[0], ins[1].shape[1], ins[1].shape[2].bit_length() - 1)
    if entry in INIT_ENTRIES:
        return (math.prod(ins[1].shape[1:-1]), ins[0].n_slots)
    if entry == "sumcheck_fold":
        return (ins[3].shape[2], ins[0].shape[1])
    if entry == "sha3_256_x64":
        return (ins[0].shape[1],)
    if entry == "sha3_chain_x64":
        return (ins[0].shape[0], ins[0].shape[2])
    return tuple(ins[1])


def circuit_differences(a, b):
    """The fields in which two LayeredCircuits differ, as "layer.field"."""
    import numpy as np
    if a.size != b.size:
        return ["depth"]
    out = [] if np.array_equal(a.input_values, b.input_values) else ["inputs"]
    for i, (x, y) in enumerate(zip(a.layers, b.layers)):
        for k in ("ty", "u", "v", "l", "lv", "c_real", "c_img", "is_assert",
                  "size", "bit_length", "dad_size", "dad_bit_length",
                  "max_dad_size", "max_dad_bit_length"):
            if not np.array_equal(np.asarray(getattr(x, k)),
                                  np.asarray(getattr(y, k))):
                out.append(f"{i}.{k}")
        if len(x.dad_id) != len(y.dad_id) or not all(
                np.array_equal(p, q) for p, q in zip(x.dad_id, y.dad_id)):
            out.append(f"{i}.dad_id")
    return out


def shape_label(entry, shp):
    """A shape as printed: a forest of many trees by its tree count and
    leaves."""
    if entry == "merkle_forest" and len(shp) > 12:
        return f"{len(shp)} trees, {sum(shp)} leaves"
    return shp


def cost(entry, shp, ins):
    """(bytes, 32-bit integer operations) one call on inputs `ins` of shape
    `shp` needs: each input read once, each output written once."""
    if entry in GF_ENTRIES:
        return gf_cost(entry, ins)
    if entry in INIT_ENTRIES:
        return init_cost(entry, ins)
    if entry in FUSED_ENTRIES:
        return fused_cost(entry, ins)
    if entry == "sumcheck_fold":
        bl, k = shp
        n = 1 << bl
        return (3 * 16 * k * n + 16 * k * bl + 48 * bl * k + 48 * k,
                K1_PRODUCTS_PER_PAIR * k * (n - 1) * IMAD_PER_PRODUCT)
    if entry == "sha3_256_x64":
        return 96 * shp[0], KECCAK_INT32_OPS * shp[0]
    if entry == "sha3_chain_x64":
        steps, n = shp
        return 32 * steps * n + 32 * n, KECCAK_INT32_OPS * steps * n
    leaves = sum(shp)        # leaves in, heaps (2N nodes) out, 40 B a tree
    return (32 * leaves + 64 * leaves + 40 * len(shp),
            KECCAK_INT32_OPS * (leaves - len(shp)))


def kept(a):
    """A copy of one wrapper argument: a tensor copied with its sizes and
    strides (a strided or expanded view stays such a view, over a copy of
    the storage it reads), a list copied, an op code or None as it is."""
    if not hasattr(a, "clone"):
        return list(a) if isinstance(a, (list, tuple)) else a
    if a.numel() == 0 or a.is_contiguous():
        return a.clone()
    span = 1 + sum((n - 1) * st for n, st in zip(a.shape, a.stride()))
    base = a.as_strided((span,), (1,)).clone()
    return base.as_strided(a.shape, a.stride())


class Recorder:
    """While active, every call of the kernel wrappers is recorded, to be
    held against its plain twin by compare_calls.  A K1 or K2 call keeps a
    copy of its inputs and outputs and the device launches it made.  An X1
    call (a field op, chain or transform: thousands a prove, up to 2^26
    words each in a batched call at B = 64) runs its twin at once on the
    same inputs and keeps a device-side count of the words that differ, its
    launches and the rule's (gf_launches), its size (gf_size), its cost
    and, for the first call of its size bucket, a copy of its inputs.  The
    wrappers' launch and plain-call counts are left as the wrappers made
    them.  Calls made while a graph is captured are not recorded (they run
    nothing); a replay calls no wrapper."""

    def __init__(self, kernels, wrappers, twin):
        self.kernels = kernels
        self.wrappers = wrappers     # entry -> (module, attribute name)
        self.twin = twin
        # (entry, inputs or None, outputs or (size, output words, cost) of
        # an X1 call, launches)
        self.calls = []
        self.gf_diff = {e: [] for e in GF_ENTRIES}   # per call, on the card

    def _record(self, entry, fn):
        import torch
        buckets = set()

        def rec(*args):
            if torch.cuda.is_current_stream_capturing():
                # a capture runs nothing: the eager call just before it on
                # the same inputs is the one recorded (graphs.py)
                return fn(*args)
            gf_call = entry in GF_ENTRIES
            ins = None if gf_call else tuple(kept(a) for a in args)
            before = self.kernels.LAUNCHES[entry]
            out = fn(*args)
            launched = self.kernels.LAUNCHES[entry] - before
            if not gf_call:
                self.calls.append((entry, ins, tuple(
                    t.clone() for t in flatten(out)), launched))
                return out
            plain = dict(self.kernels.PLAIN_CALLS)
            want = self.twin[entry](*args)
            self.kernels.PLAIN_CALLS.update(plain)
            if want.shape != out.shape:
                fail(f"{entry} gave shape {tuple(out.shape)} against its "
                     f"plain twin's {tuple(want.shape)}")
            self.gf_diff[entry].append((out != want).sum())
            size = gf_size(entry, args)
            if gf_bucket(size) not in buckets:
                buckets.add(gf_bucket(size))
                ins = tuple(kept(a) for a in args)
            self.calls.append((entry, ins, (size, gf_launches(entry, args),
                                            gf_cost(entry, args)), launched))
            return out
        return rec

    def __enter__(self):
        self.saved = {e: getattr(m, a) for e, (m, a) in self.wrappers.items()}
        for e, (m, a) in self.wrappers.items():
            setattr(m, a, self._record(e, self.saved[e]))
        return self

    def __exit__(self, *exc):
        for e, (m, a) in self.wrappers.items():
            setattr(m, a, self.saved[e])


def kernel_tables():
    """The port's kernel wrappers and plain twins: (kernels module,
    {entry: (module, wrapper name)}, {entry: twin}, expected_launches)."""
    from virgo_plus_tpu_torch import kernels
    from virgo_plus_tpu_torch.circuits import compile as circuit
    from virgo_plus_tpu_torch.field import chains, gf
    from virgo_plus_tpu_torch.gkr import inits, sumcheck
    from virgo_plus_tpu_torch.pc import fft, fft_gkr, keccak, merkle, virgo_pc

    wrappers = {"sumcheck_fold": (sumcheck, "fold_cuda"),
                "sha3_256_x64": (keccak, "sha3_256_x64_cuda"),
                "sha3_chain_x64": (keccak, "sha3_chain_x64_cuda"),
                "merkle_forest": (merkle, "forest_cuda"),
                "gf_mul": (gf, "mul_cuda"),
                "gf_lin": (gf, "lin_cuda"),
                "gf_table": (chains, "table_cuda"),
                "gf_segsum": (chains, "segsum_cuda"),
                "gf_fft": (fft, "fft_cuda"),
                "gf_fri_fold": (virgo_pc, "fold_step_cuda"),
                "gkr_p1_inits": (inits, "p1_inits_cuda"),
                "gkr_p2_inits": (inits, "p2_inits_cuda"),
                "gf_eval_layer": (circuit, "eval_layer_cuda"),
                "fg_stage_tables": (fft_gkr, "stage_tables_cuda"),
                "fg_build_circuit": (fft_gkr, "build_circuit_cuda"),
                "pc_virtual_oracle": (virgo_pc, "virtual_oracle_cuda")}
    twin = {"sumcheck_fold": sumcheck.fold_plain,
            "sha3_256_x64": keccak.sha3_256_x64_plain,
            "sha3_chain_x64": keccak.sha3_chain_x64_plain,
            "merkle_forest": merkle.forest_plain,
            "gf_mul": gf.mul_plain,
            "gf_lin": gf.lin_plain,
            "gf_table": chains.table_plain,
            "gf_segsum": chains.segsum_plain,
            "gf_fft": fft.fft_plain,
            "gf_fri_fold": virgo_pc.fold_step_plain,
            "gkr_p1_inits": inits.p1_inits_plain,
            "gkr_p2_inits": inits.p2_inits_plain,
            "gf_eval_layer": circuit.eval_layer_plain,
            "fg_stage_tables": fft_gkr.stage_tables_plain,
            "fg_build_circuit": fft_gkr.build_circuit_plain,
            "pc_virtual_oracle": virgo_pc.virtual_oracle_plain}

    def expected_launches(entry, ins):
        if entry == "sumcheck_fold":
            return sumcheck.fold_launches(ins[3].shape[2])
        if entry in GF_ENTRIES:
            return gf_launches(entry, ins)
        if entry in INIT_ENTRIES:
            return 1
        if entry == "gf_eval_layer":
            return 1 if ins[1].numel() and ins[0].numel() else 0
        if entry == "fg_stage_tables":
            return 1 if ins[1].shape[1] else 0
        if entry == "fg_build_circuit":
            return fft_gkr.circuit_launches(ins[0])
        if entry == "pc_virtual_oracle":
            return 1 if ins[0].numel() else 0
        n = ins[0].shape[-1]
        return 1 if n else 0

    return kernels, wrappers, twin, expected_launches


def compare_calls(torch, rec, twin, expected_launches, what):
    """Hold every call `rec` recorded against its twin on the same inputs
    and its launches against the rule; fail at the first difference.  The
    field ops were held as they ran: their counts of differing words are
    read here, once.  The SHA3 twin hashes each message column on its
    own, so the recorded sha3_256_x64 calls (thousands of one-message
    sponge calls in an FS prove) are held together: one twin call on all
    their messages side by side.  Returns ({entry: Counter of shapes},
    {entry: max_abs_err}, {(entry, shape): the inputs of one call},
    {entry: Counter of (bytes, operations) of each call})."""
    shapes = {e: collections.Counter() for e in KERNEL_NAMES}
    costs = {e: collections.Counter() for e in KERNEL_NAMES}
    err = {e: 0.0 for e in KERNEL_NAMES}
    example, sponge = {}, []
    for entry, ins, outs, launched in rec.calls:
        if entry in GF_ENTRIES:
            size, want, cst = outs
            shp = gf_bucket(size)
        else:
            shp = shape_of(entry, ins)
            want, cst = expected_launches(entry, ins), cost(entry, shp, ins)
        if launched != want:
            fail(f"{entry} made {launched} launches on the {what}'s call at "
                 f"shape {shp}, expected {want}")
        shapes[entry][shp] += 1
        costs[entry][cst] += 1
        if ins is not None:
            example.setdefault((entry, shp), ins)
        if entry in GF_ENTRIES:
            continue
        if entry == "sha3_256_x64":
            sponge.append((ins[0], outs[0]))
            continue
        e = max_abs_err(torch, outs, flatten(twin[entry](*ins)))
        if e != 0.0:
            fail(f"{entry} differs from its plain twin on the {what}'s call "
                 f"at shape {shp}")
        err[entry] = max(err[entry], e)
    if sponge:
        msgs = torch.cat([m for m, _ in sponge], dim=1)
        e = max_abs_err(torch, (torch.cat([d for _, d in sponge], dim=1),),
                        (twin["sha3_256_x64"](msgs),))
        if e != 0.0:
            fail(f"sha3_256_x64 differs from its plain twin on one of the "
                 f"{what}'s {len(sponge)} calls")
        err["sha3_256_x64"] = e
    for entry, diffs in rec.gf_diff.items():
        if diffs and int(torch.stack(diffs).sum()) != 0:
            bad = next(i for i, d in enumerate(diffs) if int(d))
            fail(f"{entry} differs from its plain twin on the {what}'s "
                 f"call {bad} of {len(diffs)}")
        diffs.clear()
    rec.calls.clear()
    return shapes, err, example, costs


def bound_ms(costs, int32_rate):
    """The least device time of the calls counted in `costs` ((bytes,
    operations) -> calls): each call bound by its bytes or its
    operations, whichever takes longer."""
    return sum(n * max(b / HBM_BYTES_S, o / int32_rate) * 1e3
               for (b, o), n in costs.items())


def random_inputs(torch, np, gf, entry, shp, dev, rng):
    """Random inputs of one kernel call at shape `shp` (shape_of's); a GKR
    init call's inputs are a circuit's, so every path's shapes are
    profiled on a recorded call."""
    if entry in INIT_ENTRIES:
        raise ValueError(f"{entry}: no random inputs of a circuit's plan")
    M = gf.MOD
    canon = lambda *s: gf.tensor(rng.integers(0, M, size=s, dtype=np.uint64),
                                 dev)
    if entry == "gf_eval_layer":   # a layer reading a block of 2^k values
        rows, size = shp
        p = 1 << max(size - 1, 0).bit_length()
        idx = lambda: torch.from_numpy(rng.integers(0, p, size=size)).to(dev)
        values = torch.cat([canon(2, rows, p), torch.zeros(
            (2, rows, p), dtype=torch.int64, device=dev)], -1)
        return (values, idx(), idx(), canon(4, 2, size), 0, p)
    if entry == "fg_build_circuit":
        lg, = shp
        return (lg, canon(2, lg), canon(2, POINTS))
    if entry == "pc_virtual_oracle":   # B instances of L columns, random
        # tables and q of 65 slices
        b, cols = shp
        lead = (b,) if b > 1 else ()
        return (canon(2, *lead, 65, cols), canon(2, 65, cols),
                canon(2, *lead, 64, cols), canon(2, *lead, 64), 128,
                canon(2, cols), canon(2, cols))
    if entry == "fg_stage_tables":  # the last `stages` stages of lg
        from virgo_plus_tpu_torch.pc import fft_gkr
        phase, stages, lg = shp
        n = 1 << lg
        return (phase, canon(2, stages, n), fft_gkr.stage_powers(lg, dev),
                canon(2, stages, n), canon(2, stages) if phase == 2 else None,
                lg - stages)
    if entry == "sumcheck_fold":
        bl, k = shp
        return tuple(gf.tensor(rng.integers(0, M, size=(2, k, 1 << bl),
                                            dtype=np.uint64), dev)
                     for _ in range(3)) + (gf.tensor(rng.integers(
                         0, M, size=(2, k, bl), dtype=np.uint64), dev),)
    words = lambda *s: gf.tensor(rng.integers(0, 2 ** 64, size=s,
                                              dtype=np.uint64), dev)
    if entry == "gf_fft":          # 128 coefficients onto n / 2 points
        order = max(shp[0] // 2, 1)
        rows = 64 if order >= 64 * 128 else 1
        lg = (order // rows).bit_length() - 1
        x = gf.tensor(rng.integers(0, M, size=(2, rows, min(order // rows,
                                                            128)),
                                   dtype=np.uint64), dev)
        return (x, lg, gf.root_of_unity_int(lg))
    if entry == "gf_fri_fold":     # a fold onto n / 2 points
        half = max(shp[0] // 2, 1)
        rows = 65 if half >= 65 * 64 else 1
        n = 2 << max((half // rows).bit_length() - 1, 0)
        return tuple(gf.tensor(rng.integers(0, M, size=s, dtype=np.uint64),
                               dev) for s in ((2, rows, n), (2, n // 2),
                                              (2,)))
    if entry in GF_ENTRIES:        # (2, n / 2) words: a product, a sum, a
        # beta table, one segment
        x, y = (gf.tensor(rng.integers(0, M, size=(2, max(shp[0] // 2, 1)),
                                       dtype=np.uint64), dev)
                for _ in range(2))
        if entry == "gf_table":
            from virgo_plus_tpu_torch.field.chains import BETA
            k = max(shp[0] // 2, 1).bit_length() - 1
            return (BETA, x[:, 0], y[:, :k], 1 << k, dev)
        if entry == "gf_segsum":
            return (x, None, None, None)
        return (x, y) if entry == "gf_mul" else (gf.ADD, x, y)
    if entry == "sha3_256_x64":
        return (words(8, shp[0]),)
    if entry == "sha3_chain_x64":
        return (words(shp[0], 4, shp[1]),)
    return (words(4, sum(shp)), list(shp))


def sharded_rank(mesh, circuit, transcripts, runs):
    """Phase 9 on one rank: per transcript, compile, then one prove with
    the launch counts reset just before and read just after (rank 0
    recording every kernel call and holding it against its twin), then
    `runs` timed proves.  Returns {transcript: results}."""
    import torch
    import torch.distributed
    from virgo_plus_tpu_torch.parallel import fs_sharded, gkr_sharded

    kernels, wrappers, twin, expected_launches = kernel_tables()
    out = {}
    for tr in transcripts:
        if tr == "fs":
            comp = fs_sharded.compile_fs_sharded(circuit, mesh)
            prove = lambda: fs_sharded.prove_fs_sharded(circuit, mesh,
                                                        compiled=comp)
        else:
            comp = gkr_sharded.compile_sharded(circuit, mesh)
            prove = lambda: gkr_sharded.prove_sharded(circuit, mesh,
                                                      compiled=comp)
        torch.cuda.synchronize()
        with Recorder(kernels, wrappers if mesh.rank == 0 else {},
                      twin) as rec:
            kernels.reset_counts()
            t0 = time.perf_counter()
            full, info = prove()
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            plain = dict(kernels.PLAIN_CALLS)
        shapes, err, _, _ = compare_calls(
            torch, rec, twin, expected_launches,
            f"rank 0's sharded {tr} prove at S = {mesh.sp}")
        # rank 0's twin checks above hold the others in their first
        # collective: start the timed proves together
        torch.distributed.barrier()
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prove()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[tr] = dict(full=full if mesh.rank == 0 else None,
                       launches=launches, plain=plain, first_s=first,
                       wall_ms=walls, backend=mesh.backend,
                       device=str(mesh.device),
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       pc_bytes=info.get("per_rank_pc_bytes"),
                       shapes=shapes, err=err)
    return out


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
    from virgo_plus_tpu_torch import driver, fused, graphs, native, proof_io
    from virgo_plus_tpu_torch.circuits.compile import (compile_circuit,
                                                       eval_arrays, evaluate,
                                                       input_buffer)
    from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
    from virgo_plus_tpu_torch.field import chains, gf
    from virgo_plus_tpu_torch.gkr import fs, protocol
    from virgo_plus_tpu_torch.gkr import sumcheck
    from virgo_plus_tpu_torch.parallel import mesh as pmesh
    from virgo_plus_tpu_torch.parallel.sharded import make_batched_full_prover
    from virgo_plus_tpu_torch.pc import fft, fft_gkr, virgo_pc
    from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

    kernels, wrappers, twin, expected_launches = kernel_tables()
    cuda_fn = {e: getattr(m, a) for e, (m, a) in wrappers.items()}

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
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Compiling entry" in ln]
        say(f"phase 1 build {src}: {'; '.join(regs) or log.strip()}")
    say(f"phase 1 ok: kernels built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(2024)
    M = gf.MOD
    err = {e: 0.0 for e in KERNEL_NAMES}

    def held(entry, ins, what):
        """Run one kernel call and its twin on the same inputs; fail unless
        equal bit for bit and the call made its expected launches.  An
        entry that writes in place gets a copy of the inputs for its
        twin."""
        twin_ins = (tuple(kept(a) for a in ins) if entry in IN_PLACE
                    else ins)
        before = kernels.LAUNCHES[entry]
        got = flatten(cuda_fn[entry](*ins))
        launched = kernels.LAUNCHES[entry] - before
        want = flatten(twin[entry](*twin_ins))
        torch.cuda.synchronize()
        e = max_abs_err(torch, got, want)
        err[entry] = max(err[entry], e)
        if e != 0.0:
            fail(f"{entry} differs from its plain twin at {what}")
        if launched != expected_launches(entry, ins):
            fail(f"{entry} made {launched} launches at {what}, expected "
                 f"{expected_launches(entry, ins)}")
        return got

    # ---- phase 2: K1 against its plain twin -------------------------------
    k1_sizes = (1, 3, 7, 12, 13, 14, 17)
    for bl in k1_sizes:
        for k in (1, 3, 26):
            n = 1 << bl
            ins = [gf.tensor(rng.integers(0, M, size=(2, k, n),
                                          dtype=np.uint64), dev)
                   for _ in range(3)]
            rs = gf.tensor(rng.integers(0, M, size=(2, k, bl),
                                        dtype=np.uint64), dev)
            held("sumcheck_fold", (*ins, rs), f"bl={bl} K={k}")
    for shp in K1_SHARDED:
        held("sumcheck_fold", random_inputs(torch, np, gf, "sumcheck_fold",
                                            shp, dev, rng),
             f"the sharded shape (bl, K) = {shp}")
    say(f"phase 2 ok: K1 == plain twin bit for bit, bl in {k1_sizes} x K in "
        f"(1, 3, 26) and at the sharded shapes (bl, K) {K1_SHARDED}; "
        f"launches per call == fold_launches(bl) "
        f"{[sumcheck.fold_launches(b) for b in k1_sizes]}")

    # ---- phase 3: K2's entries against their plain twins ------------------
    for n in (1, 1000, 4096, 6128, 65536):
        w = rng.integers(0, 2 ** 64, size=(8, n), dtype=np.uint64)
        wt = gf.tensor(w, dev)
        o = gf.to_numpy(held("sha3_256_x64", (wt,), f"N={n}")[0])
        wc = np.ascontiguousarray(w.T)
        oc = np.ascontiguousarray(o.T)
        for i in range(n):
            if hashlib.sha3_256(wc[i].tobytes()).digest() != oc[i].tobytes():
                fail(f"K2 differs from hashlib.sha3_256 at N={n}, message {i}")
    chain_widths = (1, 1000, 2048, 6128)
    for n in chain_widths:
        xs = gf.tensor(rng.integers(0, 2 ** 64, size=(CHAIN_STEPS, 4, n),
                                    dtype=np.uint64), dev)
        held("sha3_chain_x64", (xs,), f"steps={CHAIN_STEPS} leaves={n}")
    forests = [MAIN_FOREST, [2048], [8192], [1, 2, 4, 1], [65536, 16]]
    for sizes in forests:
        leaves = gf.tensor(rng.integers(0, 2 ** 64, size=(4, sum(sizes)),
                                        dtype=np.uint64), dev)
        held("merkle_forest", (leaves, sizes), f"trees {sizes}")
    say(f"phase 3 ok: sha3_256_x64 == plain twin == hashlib.sha3_256, N in "
        f"(1, 1000, 4096, 6128, 65536); sha3_chain_x64 == plain twin, "
        f"{CHAIN_STEPS} steps x leaves {chain_widths}; merkle_forest == plain "
        f"twin in one launch, trees {forests}")

    # ---- phase 3, X1: the field ops against their plain versions ----------
    # (label, x's shape, y's shape, x strided on its last axis): the paths'
    # call patterns, a size past one grid of blocks, a ragged edge
    gf_patterns = [
        ("same shape", (2, 64), (2, 64), False),
        ("(2, K, 1) against (2, K, n)", (2, 26, 1), (2, 26, 4096), False),
        ("(2, K, n) against (2, K, 1)", (2, 26, 4096), (2, 26, 1), False),
        ("strided x[..., 0::2]", (2, 63, 512), (2, 63, 512), True),
        ("scalar (2,) against (2, n)", (2,), (2, 8192), False),
        ("rank 5", (2, 4, 3, 5, 64), (2, 4, 3, 5, 64), False),
        ("rank 5, broadcast", (2, 4, 1, 5, 1), (2, 1, 3, 1, 64), True),
        ("empty", (2, 0), (2, 0), False),
        ("2^18 elements", (2, 1 << 18), (2, 1 << 18), False),
        ("3 * 2^17 + 7 elements", (2, 3 * 2 ** 17 + 7), (2, 1), False),
        ("(bl, K, 2, 3) round polynomials (sums only)", (12, 26, 2, 3),
         (12, 26, 2, 3), False)]
    n_gf = 0
    for high, values in ((M, "canonical"), (2 ** 64, "any int64")):
        for label, sx, sy, strided in gf_patterns:
            wx = sx[:-1] + (2 * sx[-1],) if strided else sx
            x = gf.tensor(rng.integers(0, high, size=wx, dtype=np.uint64),
                          dev)
            x = x[..., 0::2] if strided else x
            y = gf.tensor(rng.integers(0, high, size=sy, dtype=np.uint64),
                          dev)
            what = f"{label}, {values} inputs"
            calls = [("gf_mul", (x, y))] if sx[0] == sy[0] == 2 else []
            calls += [("gf_lin", (op, x, y if op in (gf.ADD, gf.SUB)
                                  else None))
                      for op in range(len(gf.LIN_OPS))
                      if len(sx) == len(sy) or op not in (gf.ADD, gf.SUB)]
            for entry, ins in calls:
                held(entry, ins, what)
                n_gf += 1
    say(f"phase 3 X1 ok: gf_mul and gf_lin ({', '.join(gf.LIN_OPS)}) == "
        f"their plain versions bit for bit in {n_gf} calls, on canonical and "
        f"on any int64 inputs, at {[p[0] for p in gf_patterns]}; one launch "
        f"a call, none for the empty output")
    # the wrappers' output shape (gf._broadcast) against torch's rule, and
    # the host time of one such computation, at the products' patterns
    # (mul_cuda broadcasts the shapes after the plane axis)
    pairs = [(torch.Size(sx[1:]), torch.Size(sy[1:]))
             for _, sx, sy, _ in gf_patterns if sx[0] == sy[0] == 2]
    for sx, sy in pairs:
        if gf._broadcast(sx, sy) != tuple(torch.broadcast_shapes(sx, sy)):
            fail(f"gf._broadcast{sx, sy} differs from torch.broadcast_shapes")
    host_us = {}
    for label, rule in (("gf._broadcast", gf._broadcast),
                        ("torch.broadcast_shapes", torch.broadcast_shapes)):
        t0 = time.perf_counter()
        for _ in range(BROADCAST_REPS):
            for sx, sy in pairs:
                rule(sx, sy)
        host_us[label] = ((time.perf_counter() - t0) * 1e6
                          / (BROADCAST_REPS * len(pairs)))
    say(f"phase 3 X1 host time of one output shape ({card} host), us a "
        f"call over {BROADCAST_REPS} rounds of the {len(pairs)} patterns: "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_us.items())
        + "; the same shapes")

    # ---- phase 3, X1 chains: gf_table and gf_segsum against their twins --
    canon = lambda *shape: gf.tensor(rng.integers(0, M, size=shape,
                                                  dtype=np.uint64), dev)
    n_chain = 0

    def chain(entry, ins, what):
        nonlocal n_chain
        held(entry, ins, what)
        n_chain += 1

    largest = {}       # the largest shapes, timed below
    # gf_table's edges: a warp task of 2^7 entries (2^6-2^8), a block of
    # eight tasks (2^9-2^11), the task sizes of the large tables (2^17-2^20)
    beta_bits = (0, 1, 5, 6, 7, 8, 9, 10, 11, 13, 17, 18, 20)
    for k in beta_bits:
        r = canon(2, 2 * k + 1)[:, ::2]                # strided r[:, :k]
        ins = (chains.BETA, canon(2), r[:, :k], 1 << k, dev)
        chain("gf_table", ins, f"a beta table of 2^{k} entries")
        if k == beta_bits[-1]:
            largest[f"a beta table of 2^{k} entries"] = ("gf_table", ins)
        if k <= 13:
            rs = canon(2, 3, 2 * k + 2)[..., ::2]
            chain("gf_table", (chains.BETA, canon(2, 3), rs, 1 << k, dev),
                  f"3 beta tables of 2^{k} entries, strided rs")
    chain("gf_table", (chains.BETA, canon(2, 63), canon(2, 63, 13), 1 << 10,
                       dev), "63 beta tables of 2^10 entries")
    # host factors at k = 0..20 bits (n = 2^k), and n not a power of two
    power_n = tuple(1 << k for k in range(21)) + (0, 7, 1000, 4097,
                                                   (1 << 20) - 3)
    for n in power_n:
        base = tuple(int(v) for v in rng.integers(0, M, 2, dtype=np.uint64))
        ins = (chains.POWER, base, None, n, dev)
        chain("gf_table", ins, f"powers of a by-value base, n = {n}")
        if n == power_n[-1]:
            largest[f"powers of a by-value base, n = {n}"] = ("gf_table",
                                                             ins)
    for n in (1, 100, 128, 300):
        chain("gf_table", (chains.POWER, canon(2, 64), None, n, dev),
              f"powers of 64 elements, n = {n}")
        chain("gf_table", (chains.POWER, canon(2, 5)[:, 3], None, n, dev),
              f"powers of one element, n = {n}")
    tree_n = (0, 1, 7, 16, 17, 600, 8192, 1 << 18)
    for n in tree_n:
        for rows in ((2,), (2, 3)):
            chain("gf_segsum", (canon(*rows, n), None, None, None),
                  f"a tree sum of {rows} rows of {n}")
    chain("gf_segsum", (canon(2, 128, 64).transpose(1, 2), None, None,
                        None), "tree sums over a transposed (2, 64, 128)")
    # plans: a scatter with empty segments (lead (4,)), one segment of
    # 2^18 terms, one long segment among short ones, and means at the
    # summers' thresholds
    idx = rng.integers(0, 1 << 16, 1 << 18)
    plans = {"a scatter of 2^18 terms onto 2^17 (half empty), lead (4,)":
             (canon(2, 4, 1 << 18), sumcheck.ScatterPlan.build(
                 idx, 1 << 17).arrays(dev)),
             "one segment of 2^18 terms":
             (canon(2, 1 << 18), (torch.randperm(1 << 18, device=dev),
                                  torch.zeros(1, dtype=torch.int64,
                                              device=dev),
                                  torch.full((1,), 1 << 18, device=dev)))}
    skew = np.concatenate([rng.integers(0, 1 << 15, 1 << 16),
                           np.full(1 << 16, 7)])
    plans["2^15 short segments and one of 2^16 terms"] = (
        canon(2, 1 << 17), sumcheck.ScatterPlan.build(skew, 1 << 15)
        .arrays(dev))
    skew = np.concatenate([rng.integers(0, 1000, 4000)]
                          + [np.full(100 * j, 333 * j) for j in (1, 2, 3)])
    plans["1000 segments, 3 of 100-300 terms, lead (3,)"] = (
        canon(2, 3, len(skew)), sumcheck.ScatterPlan.build(skew, 1000)
        .arrays(dev))
    for mean in (chains.THREAD_MEAN, chains.THREAD_MEAN + 1,
                 chains.WARP_MEAN, chains.WARP_MEAN + 1):
        plans[f"segments of mean length {mean}"] = (
            canon(2, 3, 64 * mean), sumcheck.ScatterPlan.build(
                rng.integers(0, 64, 64 * mean), 64).arrays(dev))
    for what, (x, arrs) in plans.items():
        chain("gf_segsum", (x, *arrs), what)
    largest.update({what: ("gf_segsum", (x, *arrs)) for what, (x, arrs)
                    in list(plans.items())[:3]})
    largest["a tree sum of 2 rows of 2^18"] = ("gf_segsum", (
        canon(2, 1 << 18), None, None, None))
    say(f"phase 3 X1 chains ok: gf_table and gf_segsum == their plain twins "
        f"bit for bit in {n_chain} calls on canonical inputs: beta tables of "
        f"2^k entries, k in {beta_bits} (k <= 13 also 3 tables, strided), "
        f"63 of 2^10; power tables of a by-value base (its squarings from "
        f"the host), n in {power_n}, of tensor bases; tree sums of lengths "
        f"{tree_n}, rank 2 and 3, "
        f"transposed; plans: {list(plans)}; one launch a call, none for an "
        f"empty output")
    def time_largest(largest):
        """Each shape's time beside its bound: CUDA events around
        back-to-back calls.  The profiler is kept for the per-shape rows at
        the end (profiles here make the closing ones miss launches); a call
        whose host issue takes longer than its device time (gf_table's
        2^20-entry tables) reads as its host issue, and
        scripts/check_transforms.py profiles those."""
        timed = []
        for what, (entry, ins) in largest.items():
            ms = event_ms(torch, lambda: cuda_fn[entry](*ins),
                          PROFILE_REPS[entry])
            nbytes, ops = gf_cost(entry, ins)
            bound = max(nbytes / HBM_BYTES_S, ops / int32_rate) * 1e3
            timed.append(f"{what}: {ms * 1e3:.3f} us (bound "
                         f"{bound * 1e3:.3f} us)")
        return "; ".join(timed)

    say(f"phase 3 X1 chains, time of the largest shapes ({card}; CUDA "
        f"events over {PROFILE_REPS['gf_table']} calls each): "
        + time_largest(largest))

    # ---- phase 3, X1 transforms: gf_fft and gf_fri_fold against twins ----
    largest, n_tr = {}, 0

    def transform(entry, ins, what, timed=False):
        nonlocal n_tr
        held(entry, ins, what)
        n_tr += 1
        if timed:
            largest[what] = (entry, ins)

    rou = gf.root_of_unity_int
    # (what, coefficients' shape, log2 of the order, inverse, timed): the
    # paths' shapes, orders past one block's tile, two-launch transforms
    fft_shapes = [
        ("128 coefficients onto 2^12 points, 64 rows", (2, 64, 128), 12,
         False, False),
        ("an IFFT at 2^7, 64 rows", (2, 64, 128), 7, True, False),
        ("an IFFT at 2^8, 64 rows", (2, 64, 256), 8, True, False),
        ("128 onto 2^12, lead (16, 64)", (2, 16, 64, 128), 12, False,
         False),
        ("an IFFT at 2^7, lead (16, 64)", (2, 16, 64, 128), 7, True, False),
        ("128 onto 2^12, lead (64, 64)", (2, 64, 64, 128), 12, False, True),
        ("128 onto 2^16, 64 rows", (2, 64, 128), 16, False, False),
        ("128 onto 2^19, 64 rows", (2, 64, 128), 19, False, True),
        ("an IFFT at 2^11, 64 rows", (2, 64, 2048), 11, True, False),
        ("an IFFT at 2^12, 16 rows (2 launches)", (2, 16, 4096), 12, True,
         False),
        ("an IFFT at 2^16, 4 rows (2 launches)", (2, 4, 1 << 16), 16, True,
         True),
        ("2^19 onto 2^19, 2 rows (2 launches)", (2, 2, 1 << 19), 19, False,
         True),
        ("one coefficient onto 2^5 points, 3 rows", (2, 3, 1), 5, False,
         False),
        ("one point", (2, 1), 0, False, False),
        ("an empty lead", (2, 0, 128), 12, False, False)]
    # the radix-4 passes: odd and even stage counts, one launch
    fft_shapes += [(f"2^{lg} onto 2^{lg}, 3 rows", (2, 3, 1 << lg), lg,
                    lg % 2 == 0, False) for lg in range(1, 13)]
    for what, shape, lg, inverse, timed in fft_shapes:
        x = canon(*shape)
        transform("gf_fft", (x,) + fft._inverse(shape[-1], rou(lg))
                  if inverse else (x, lg, rou(lg)), what, timed)
    # a root's twiddles are made outside a capture, never during one: a
    # root no call has used yet raises on the capturing stream
    fresh = gf.pow_int(rou(9), 3)
    if (fresh, 9, dev) in fft._TWIDDLES or any(
            k[0] == fresh for k in fft._TWIDDLES):
        fail("phase 3: the fresh root's twiddles exist already")
    graph, x = torch.cuda.CUDAGraph(), canon(2, 4, 512)
    try:
        with torch.cuda.graph(graph):
            fft.fft_cuda(x, 9, fresh)
        fail("gf_fft made a twiddle table inside a capture")
    except RuntimeError as exc:
        if "capturing" not in str(exc):
            raise
    del graph
    transform("gf_fft", (x, 9, fresh), "a fresh root of order 2^9 after "
              "the refused capture")
    transform("gf_fft", (canon(2, 64, 256)[..., 128:], 12, rou(12)),
              "strided rows x[..., 128:] onto 2^12")
    transform("gf_fft", (canon(2, 64, 16, 128).transpose(1, 2), 12, rou(12)),
              "a transposed lead (16, 64) onto 2^12")
    # (what, codeword shape, timed: a call the card takes longer over
    # than its host issue); w and r random, canonical
    fold_shapes = [("a fold of (2, 65, 4096)", (2, 65, 4096), False),
                   ("a fold of (2, 65, 64)", (2, 65, 64), False),
                   ("a fold of (2, 65, 2)", (2, 65, 2), False),
                   ("a fold of (2, 64, 65, 4096)", (2, 64, 65, 4096), True),
                   ("an empty batch", (2, 0, 65, 8), False)]
    for what, shape, timed in fold_shapes:
        transform("gf_fri_fold", (canon(*shape), canon(2, shape[-1] // 2),
                                  canon(2)), what, timed)
    transform("gf_fri_fold", (canon(2, 65, 4096)[..., ::2],
                              canon(2, 2048)[:, ::2], canon(4)[::2]),
              "a codeword, w and r read at stride 2")
    say(f"phase 3 X1 transforms ok: gf_fft and gf_fri_fold == their plain "
        f"twins bit for bit in {n_tr} calls on canonical inputs: "
        f"{[f[0] for f in fft_shapes]}, strided and transposed rows, a "
        f"fresh root after a capture that asked for its twiddles raised; "
        f"folds "
        f"{[f[0] for f in fold_shapes]}, strided; launches as "
        f"fft.launches(lg_coef), one a fold, none for an empty output")
    say(f"phase 3 X1 transforms, time of the largest shapes ({card}; CUDA "
        f"events over {PROFILE_REPS['gf_fft']} calls each; gf_fft's "
        f"twiddles made before): " + time_largest(largest))

    # ---- phase 3, X1 inits: gkr_p1_inits and gkr_p2_inits at fixed shapes -
    def init_circuit(layers, bits, seed, long=0):
        """randomize(layers, bits, seed); with `long`, assert gates on four
        gates of layer 2 and `long` of its gates reading node 0 of layer 1
        on the left and node 3 of layer 0 on the right (one long phase-1
        and one long phase-2 segment)."""
        circ = randomize(layers, bits, seed=seed)
        if long:
            top = circ.layers[2]
            top.is_assert[[1, 5, 9, 12]] = True
            top.u[:long] = 0
            top.l[:long], top.v[:long] = 0, 3
        subset_init(circ)
        return circ

    # (what, circuit, lead): randomize(4, 3) (empty and bound-below-mdb
    # segments), asserts with warp segments, asserts with block segments,
    # the same over 65 rows (several row tiles, a short last pass)
    long_asserts = init_circuit(3, 11, 3, 1500)
    init_fixed = [
        ("randomize(4, 3, seed=5)", init_circuit(4, 3, 5), ()),
        ("randomize(3, 6) with assert gates and 40-term segments, lead (3,)",
         init_circuit(3, 6, 7, 40), (3,)),
        ("randomize(3, 11) with assert gates and 1,500-term segments, lead "
         "(2, 2)", long_asserts, (2, 2)),
        ("the same, lead (5, 13)", long_asserts, (5, 13))]
    init_classes = {}
    for what, circ, lead in init_fixed:
        fcc = compile_circuit(circ)
        fplans = protocol.build_plans(fcc)
        farrs = protocol.circuit_arrays(fcc, fplans, dev)
        fch = protocol.make_challenges(fcc, GlibcRandom(3396), dev)
        fvals = evaluate(fcc, input_buffer(fcc, None, dev), farrs)
        rows = math.prod(lead)
        noise = gf.tensor(rng.integers(0, M, size=(2, rows, fvals.shape[-1]),
                                       dtype=np.uint64), dev)
        fvals = (gf.add(fvals[:, None], noise).reshape(
            (2,) + lead + (-1,)).contiguous() if lead else fvals)
        with Recorder(kernels, {e: wrappers[e] for e in INIT_ENTRIES},
                      twin) as rec:
            fproof = protocol.prove(fcc, fplans, fvals, fch, farrs)
            torch.cuda.synchronize()
        if not rec.calls:
            fail(f"{what}: the prove made no GKR init call")
        _, e_init, _, _ = compare_calls(torch, rec, twin, expected_launches,
                                        what)
        for entry in INIT_ENTRIES:
            err[entry] = max(err[entry], e_init[entry])
        if not lead and not bool(protocol.verify(fcc, fproof, fch)[0]):
            fail(f"{what}: the card proof is rejected")
        init_classes[what] = (farrs["p1I"].classes, farrs["p2I"].classes)
    if not all(any(c[k] for c, _ in init_classes.values())
               and any(c[k] for _, c in init_classes.values())
               for k in range(3)):
        fail(f"the fixed GKR init shapes miss a summer class: "
             f"{init_classes}")
    say(f"phase 3 X1 inits ok: gkr_p1_inits and gkr_p2_inits == their plain "
        f"twins bit for bit, one launch a stage, on {[f[0] for f in init_fixed]}"
        f"; slots by thread / warp / block summer (phase 1, phase 2): "
        f"{init_classes}")

    # ---- phase 3, X1 fused: gf_eval_layer and fg_stage_tables ------------
    eval_shapes = ((1, 8192), (64, 8192))
    for shp in eval_shapes:
        held("gf_eval_layer", random_inputs(torch, np, gf, "gf_eval_layer",
                                            shp, dev, rng),
             f"(rows, gates) = {shp}")

    def eval_circuit():
        """randomize(4, 10, seed=2) with layer 2 cut to 1,000 gates and,
        on layer 3, unary gates (Mulc, Addc, Not, Copy) and right inputs
        from layer 0."""
        from virgo_plus_tpu_torch.circuits.gates import GateType
        circ = randomize(4, 10, seed=2)
        L2, L3 = circ.layers[2], circ.layers[3]
        for k in ("ty", "u", "v", "l", "lv", "c_real", "c_img",
                  "is_assert"):
            setattr(L2, k, getattr(L2, k)[:1000].copy())
        L2.size = 1000
        L3.u %= 1000
        L3.v[L3.l == 2] %= 1000
        L3.l[100:400] = 0
        for g, ty in enumerate((GateType.Mulc, GateType.Addc, GateType.Not,
                                GateType.Copy) * 20):
            L3.ty[g], L3.l[g], L3.v[g] = int(ty), -1, 0
            L3.c_real[g], L3.c_img[g] = rng.integers(0, M, size=2,
                                                     dtype=np.uint64)
        subset_init(circ)
        return circ

    ecc = compile_circuit(eval_circuit())
    for lead in ((), (3,)):
        rows = math.prod(lead)
        wit = np.asarray(ecc.source.input_values, dtype=np.uint64)
        wit = np.stack([wit] * rows).reshape(lead + wit.shape) if lead else wit
        with Recorder(kernels, {"gf_eval_layer": wrappers["gf_eval_layer"]},
                      twin) as rec:
            evals = evaluate(ecc, input_buffer(ecc, wit, dev),
                             eval_arrays(ecc, dev))
            torch.cuda.synchronize()
        _, e_eval, _, _ = compare_calls(torch, rec, twin, expected_launches,
                                        f"cut circuit, lead {lead}")
        err["gf_eval_layer"] = max(err["gf_eval_layer"],
                                   e_eval["gf_eval_layer"])
        cpu_evals = evaluate(ecc, input_buffer(ecc, wit, "cpu"),
                             eval_arrays(ecc, "cpu"))
        if not torch.equal(evals.cpu(), cpu_evals):
            fail(f"the cut circuit's card evaluation (lead {lead}) differs "
                 f"from the CPU's")
        for i, L in enumerate(ecc.layers):
            off = int(ecc.value_off[i])
            if bool(evals[..., off + L.size:off + L.padded].any()):
                fail(f"gf_eval_layer wrote layer {i}'s padding")
    stage_shapes = [(phase, lg, lg) for lg in (1, 7, 12) for phase in (1, 2)]
    for shp in stage_shapes:
        held("fg_stage_tables", random_inputs(torch, np, gf,
                                              "fg_stage_tables", shp, dev,
                                              rng),
             f"(phase, stages, lg) = {shp}")
    for shp in FIXED_SHAPES["fg_build_circuit"]:
        held("fg_build_circuit", random_inputs(torch, np, gf,
                                               "fg_build_circuit", shp, dev,
                                               rng), f"lg = {shp[0]}")
    for shp in FIXED_SHAPES["pc_virtual_oracle"][:3]:
        held("pc_virtual_oracle", random_inputs(torch, np, gf,
                                                "pc_virtual_oracle", shp,
                                                dev, rng),
             f"(instances, columns) = {shp}")
    canon = lambda *s: gf.tensor(rng.integers(0, M, size=s, dtype=np.uint64),
                                 dev)
    for S, rank in ORACLE_RANKS:   # a rank's columns: q's 64 data slices,
        # the rank's own tables of 2^12 points
        cols = 4096 // S
        xn1, inv_x = virgo_pc.oracle_tables(12, 128, cols, dev, S, rank)
        held("pc_virtual_oracle", (canon(2, 65, cols), canon(2, 64, cols),
                                   canon(2, 64, cols), canon(2, 64), 128,
                                   xn1, inv_x),
             f"rank {rank} of {S}'s {cols} columns")
    say(f"phase 3 X1 fused ok: gf_eval_layer == its plain twin bit for bit, "
        f"one launch a call, at (rows, gates) {eval_shapes} and on every "
        f"layer of randomize(4, 10) with a layer of 1,000 gates, unary gates "
        f"and right inputs from layer 0, lead () and (3,): == the CPU "
        f"evaluation, padding untouched; fg_stage_tables == its plain twin "
        f"at (phase, stages, lg) {stage_shapes}; fg_build_circuit == its "
        f"plain twin in every layer and the power table at lg "
        f"{[s[0] for s in FIXED_SHAPES['fg_build_circuit']]} (launches "
        f"{[fft_gkr.circuit_launches(s[0]) for s in FIXED_SHAPES['fg_build_circuit']]}"
        f"); pc_virtual_oracle == its plain twin (vo and h_full) at "
        f"(instances, columns) {FIXED_SHAPES['pc_virtual_oracle'][:3]} and on "
        f"the columns of (rank, S) "
        f"{[(r, S) for S, r in ORACLE_RANKS]}, one launch a call")

    # ---- phase 4: small1200 pins on the card; card proof == CPU proof -----
    # first the native frontend, which driver.load_circuit uses from here on
    t0 = time.perf_counter()
    if not native.available():
        fail("no C++ compiler: the native frontend cannot be built")
    c = native.load_circuit(str(FIXTURE))
    t_native = time.perf_counter() - t0
    differ = circuit_differences(c, driver.load_circuit(str(FIXTURE),
                                                        prefer_native=False))
    if differ:
        fail(f"small1200: the native frontend differs from the Python "
             f"frontend in {differ}")
    say(f"phase 4 native frontend ok: small1200 through "
        f"build/native/{native._target().name} (built and parsed in "
        f"{t_native:.2f} s) == the Python frontend in every layer field; "
        f"driver.load_circuit uses it")
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
    example = {}     # (entry, shape) -> the inputs of one recorded call

    def check_path(what, launches, plain, entries=PATH_ENTRIES):
        missing = [e for e in entries if launches[e] == 0]
        if missing or any(plain.values()):
            fail(f"{what} did not run through the kernels: launches "
                 f"{launches}, plain twin calls {plain}")

    def check_calls(rec, what):
        """compare_calls, keeping one call's inputs per shape and each
        entry's largest error; returns (shapes, costs)."""
        shapes, e, ex, costs = compare_calls(torch, rec, twin,
                                             expected_launches, what)
        for entry in err:
            err[entry] = max(err[entry], e[entry])
        for key, ins in ex.items():
            example.setdefault(key, ins)
        return shapes, costs

    def listing(shapes, short=False):
        return "; ".join(
            f"{e} " + str({shape_label(e, s) if short else s: n
                           for s, n in sorted(shapes[e].items())})
            for e in KERNEL_NAMES if shapes[e])

    c = randomize(14, 13, seed=0)
    subset_init(c)
    cp = driver.compile_prover(c)
    # the eager twin of cp: phases 5-7 time the eager walls through it
    eager_cp = driver.compile_prover(c, graphed=False)
    cc = cp.cc
    # the first prove and verify of a compiled circuit build their graphs
    # (an eager warm-up call, the capture, a replay): the warm-up's kernel
    # calls are the ones recorded and held against the twins
    with Recorder(kernels, wrappers, twin) as rec:
        kernels.reset_counts()
        t0 = time.perf_counter()
        full, info = driver.prove(c, cp)
        torch.cuda.synchronize()
        t_prove_first = time.perf_counter() - t0
        first_launches = dict(kernels.LAUNCHES)
        check_path("the first prove", first_launches,
                   dict(kernels.PLAIN_CALLS))
        kernels.reset_counts()
        t0 = time.perf_counter()
        if not driver.verify(c, full, cp).ok:
            fail("the first full-width proof is rejected")
        torch.cuda.synchronize()
        t_verify_first = time.perf_counter() - t0
        first_verify_launches = dict(kernels.LAUNCHES)
        if any(kernels.PLAIN_CALLS.values()):
            fail(f"the first verify made plain twin calls "
                 f"{kernels.PLAIN_CALLS}")
    # the main path: one more prove, through the graphs' replays, and its
    # verify; the end's profile of a driver.prove holds these counts
    kernels.reset_counts()
    full_main, _ = driver.prove(c, cp)
    torch.cuda.synchronize()
    prove_launches = dict(kernels.LAUNCHES)
    rep = driver.verify(c, full_main, cp)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_CALLS)
    verify_launches = {e: launches[e] - prove_launches[e] for e in launches}
    if not rep.ok:
        fail(f"full-width proof rejected: {rep}")
    check_path("the main path", launches, plain)
    a, b = (proof_arrays(proof_io, np, f) for f in (full, full_main))
    if a.keys() != b.keys() or any(not np.array_equal(a[k], b[k]) for k in a):
        fail("the main path's prove differs from the first prove")
    del full_main
    say(f"phase 5 main path ok: randomize(14, 13) proved and verified; the "
        f"first prove ({t_prove_first:.3f} s, with the graphs' warm-up calls "
        f"and captures: launches {first_launches}) == the next one in all "
        f"{len(a)} proof arrays; the first verify {t_verify_first:.3f} s "
        f"(launches {first_verify_launches}); device launches of the next "
        f"prove {prove_launches}, of its verify {verify_launches}, plain twin "
        f"calls {plain}; transcript hash {transcript_hash(cc, full)}")
    driver_shapes, _ = check_calls(rec, "driver prove and verify")
    say(f"phase 5 recorded calls ok: every kernel call of the first driver "
        f"prove and of the first (graphed) driver.verify == its plain twin on "
        f"the same inputs, launches as the rule says; calls per shape: "
        f"{listing(driver_shapes)}")

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

    def draws(seed):
        """The challenges, the fft_gkr schedule and the fold challenges of
        a prove, drawn from GlibcRandom(seed)."""
        grng = GlibcRandom(seed)
        ch = protocol.make_challenges(cc, grng, dev)
        sched = fft_gkr.draw_schedule(n_folds, grng)
        fold_rands = []
        for _ in range(n_folds):
            r, i = grng.field_element()
            fold_rands.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                          dev).reshape(2))
        return ch, sched, fold_rands

    ch, sched, fold_rands = draws(3396)
    inputs = input_buffer(cc, None, dev)

    def timed_prove():
        out = fused.prove_e2e(cc, cp.plans, inputs, ch, fold_rands, cp.arrs)
        fused.fg_tape(n_folds, sched, dev)
        return out

    with Recorder(kernels, wrappers, twin) as rec:
        kernels.reset_counts()
        out = timed_prove()
        torch.cuda.synchronize()
        timed_launches = dict(kernels.LAUNCHES)
        timed_plain = dict(kernels.PLAIN_CALLS)
    check_path("the timed prove", timed_launches, timed_plain)
    if timed_launches["sha3_chain_x64"] + timed_launches["merkle_forest"] != 2:
        fail(f"the timed prove's leaf chains and trees took "
             f"{timed_launches} launches, not one each")
    timed_shapes, timed_costs = check_calls(rec, "timed prove")
    root_l_fused = [int(x) for x in gf.to_numpy(out[1].tree[:, 1])]
    if root_l_fused != [int(x) for x in full.root_l]:
        fail("fused.prove_e2e's l-oracle root differs from driver.prove's")
    say(f"phase 5 timed prove ok: device launches {timed_launches}, plain "
        f"twin calls {timed_plain}; every call == its plain twin; calls per "
        f"shape: {listing(timed_shapes)}; l-oracle root == driver.prove's")
    tape_card = fused.fg_tape(n_folds, sched, dev)
    tape_cpu = fused.fg_tape(n_folds, sched, "cpu")
    if len(tape_card) != len(tape_cpu) or not all(
            torch.equal(a.cpu(), b) for a, b in zip(tape_card, tape_cpu)):
        fail("the timed prove's fft_gkr tape differs from the CPU's")
    ours = {e: n for e, n in timed_launches.items() if n}
    say(f"phase 5 timed prove: the fft_gkr tape == the CPU's in all "
        f"{len(tape_cpu)} messages; launches by entry {ours}, "
        f"{sum(ours.values())} of the port's entries")

    t_e2e = wall_ms(torch, timed_prove, TIMED_RUNS)
    t_verify = wall_ms(torch, lambda: driver.verify(c, full, eager_cp),
                       EAGER_VERIFY_RUNS)
    t_driver = wall_ms(torch, lambda: driver.prove(c, cp), VERIFY_RUNS)
    say(f"phase 5 timing ({card}): timed prove {spread(t_e2e)}; "
        f"driver.verify (eager) {spread(t_verify)}; driver.prove "
        f"{spread(t_driver)}")


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
    rep = driver.verify(c, full, eager_cp)
    vph = {k: round(v * 1e3, 3) for k, v in rep.details["phases"].items()}
    say(f"phase 6 verify spans, eager (ms): {vph}; GKR fast "
        f"{eager_cp.verifier.last_split[0] * 1e3:.3f}, predicate sweeps "
        f"{eager_cp.verifier.last_split[1] * 1e3:.3f}")

    # ---- phase 7: Fiat-Shamir ---------------------------------------------
    small = randomize(3, 7, seed=9)
    subset_init(small)
    for label, cs in (("randomize(3, 7, seed=9)", small),
                      ("small1200", driver.load_circuit(str(FIXTURE)))):
        card_fs, _ = driver.prove_fs(cs, device=dev)
        cpu_fs, _ = driver.prove_fs(cs, device="cpu")
        got = proof_arrays(proof_io, np, card_fs)
        want = proof_arrays(proof_io, np, cpu_fs)
        differ = sorted(k for k in set(got) | set(want)
                        if k not in got or k not in want
                        or got[k].dtype != want[k].dtype
                        or not np.array_equal(got[k], want[k]))
        if differ:
            fail(f"{label}: the card's FS proof differs from the CPU's in "
                 f"{differ}")
        if not driver.verify_fs(cs, card_fs, device=dev).ok:
            fail(f"{label}: the card's FS proof is rejected")
        say(f"phase 7 ok: {label} card FS proof == CPU FS proof in all "
            f"{len(got)} arrays; verify_fs accepts")

    # the first prove_fs and verify_fs of the compiled circuit build their
    # graphs (phase 11): the warm-up calls' kernel calls are the ones
    # recorded and held against the twins
    with Recorder(kernels, wrappers, twin) as rec:
        kernels.reset_counts()
        t0 = time.perf_counter()
        full_fs_first, _ = driver.prove_fs(c, cp)
        torch.cuda.synchronize()
        t_fs_first = time.perf_counter() - t0
        first_fs_launches = dict(kernels.LAUNCHES)
        if not driver.verify_fs(c, full_fs_first, cp).ok:
            fail("the first full-width FS proof is rejected")
    # the main path: one more prove_fs (through the replays) and its
    # verify_fs, the counts reset just before and read just after
    kernels.reset_counts()
    full_fs, _ = driver.prove_fs(c, cp)
    torch.cuda.synchronize()
    fs_launches = dict(kernels.LAUNCHES)
    fs_plain = dict(kernels.PLAIN_CALLS)
    rep_fs = driver.verify_fs(c, full_fs, cp)
    torch.cuda.synchronize()
    fs_path_launches = dict(kernels.LAUNCHES)
    fs_path_plain = dict(kernels.PLAIN_CALLS)
    if not rep_fs.ok:
        fail(f"the full-width FS proof is rejected: {rep_fs}")
    missing = [e for e in FS_ENTRIES if fs_launches[e] == 0]
    if missing or any(fs_path_plain.values()):
        fail(f"the FS prove did not run through every kernel: launches "
             f"{fs_launches}, plain twin calls {fs_path_plain}")
    a, b = (proof_arrays(proof_io, np, f) for f in (full_fs_first, full_fs))
    if a.keys() != b.keys() or any(not np.array_equal(a[k], b[k]) for k in a):
        fail("the main path's prove_fs differs from the first prove_fs")
    del full_fs_first
    say(f"phase 7 FS path ok: randomize(14, 13) prove_fs and verify_fs; the "
        f"first prove_fs ({t_fs_first:.3f} s, with the FS graphs' warm-up "
        f"calls and captures: launches {first_fs_launches}) == the next one "
        f"in all {len(a)} proof arrays; device launches of the next "
        f"prove_fs {fs_launches}, plain twin calls {fs_plain}; with its "
        f"verify_fs {fs_path_launches}, plain {fs_path_plain}")
    fs_shapes, fs_costs = check_calls(rec, "FS prove")
    say(f"phase 7 recorded calls ok: every kernel call of the first prove_fs "
        f"and verify_fs == its plain twin on the same inputs, launches as the "
        f"rule says; calls per shape: {listing(fs_shapes)}")

    def bumped(a, idx):
        a = a.copy()
        a[idx] = np.uint64((int(a[idx]) + 1) % M)
        return a

    layers = list(full_fs.layers)
    layers[-1] = dict(layers[-1],
                      p1_polys=bumped(layers[-1]["p1_polys"], (0, 0, 1)))
    for what, bad in (
            ("p1_polys coefficient", dataclasses.replace(full_fs,
                                                         layers=layers)),
            ("all_sum entry", dataclasses.replace(
                full_fs, all_sum=bumped(full_fs.all_sum, (0, 0))))):
        if driver.verify_fs(c, bad, cp).ok:
            fail(f"an FS proof with one {what} changed was accepted")
    say("phase 7 tamper ok: FS proofs with one p1_polys coefficient or one "
        "all_sum entry changed are rejected")

    fs_prove_spans, fs_verify_spans = [], []
    t_fs_prove = wall_ms(torch, lambda: fs_prove_spans.append(
        driver.prove_fs(c, eager_cp)[1]["phases"]), FS_RUNS)
    t_fs_verify = wall_ms(torch, lambda: fs_verify_spans.append(
        driver.verify_fs(c, full_fs, eager_cp).details["phases"]), FS_RUNS)
    say(f"phase 7 timing ({card}), eager: prove_fs {spread(t_fs_prove)}; "
        f"verify_fs {spread(t_fs_verify)}")
    for what, spans in (("prove_fs", fs_prove_spans),
                        ("verify_fs", fs_verify_spans)):
        mean = {k: round(sum(sp[k] for sp in spans[1:]) / FS_RUNS * 1e3, 3)
                for k in spans[-1]}
        say(f"phase 7 {what} spans, eager (ms, mean of the {FS_RUNS} timed "
            f"runs{', synchronised' if what == 'prove_fs' else ''}): {mean}")

    # ---- phase 8: batched proving -----------------------------------------
    t8 = time.perf_counter()
    final_point = ch.layers[1].r_liu[:, :bl0]
    # phase 8 holds the eager batched prove; phase 10 its graphs
    run_batch = make_batched_full_prover(cc, cp.plans, graphed=False)
    base = gf.to_numpy(inputs)

    def witness_batch(b):
        """b witnesses: the circuit's inputs plus default_rng(7) integers
        in [0, 5) on the real plane (benches/batched_full.py)."""
        xs = np.stack([base] * b)
        xs[:, 0, :] = (xs[:, 0, :] + np.random.default_rng(7).integers(
            0, 5, xs[:, 0, :].shape, dtype=np.uint64)) % np.uint64(M)
        return xs

    def batched(xs):
        return run_batch(xs, ch, final_point, fold_rands)

    def single_arrays(out):
        proof, l_or, h_or, a_sum, _q, ldt = out
        d = {"root_l": l_or.tree[:, 1], "root_h": h_or.tree[:, 1],
             "all_sum": a_sum, "final_codeword": ldt.final_codeword,
             "level_roots": torch.stack([o.tree[:, 1] for o in ldt.oracles]),
             "vres": proof.vres}
        for i in range(1, cc.depth):
            for k, t in vars(proof.layers[i]).items():
                if t is not None:
                    d[f"{k}[{i}]"] = t
        return {k: gf.to_numpy(t) for k, t in d.items()}

    def instance_arrays(out, b):
        proofs, root_l, root_h, a_sum, level_roots, final_cw = out
        d = {"root_l": root_l[b], "root_h": root_h[b], "all_sum": a_sum[b],
             "final_codeword": final_cw[b], "level_roots": level_roots[b],
             "vres": proofs.vres[b]}
        for i in range(1, cc.depth):
            for k, t in vars(proofs.layers[i]).items():
                if t is not None:
                    d[f"{k}[{i}]"] = t[b]
        return {k: gf.to_numpy(t) for k, t in d.items()}

    def identity(out, xs, b, what):
        want = single_arrays(fused.prove_e2e(
            cc, cp.plans, input_buffer(cc, xs[b], dev), ch, fold_rands,
            cp.arrs))
        got = instance_arrays(out, b)
        differ = sorted(k for k in set(got) | set(want)
                        if k not in got or k not in want
                        or got[k].shape != want[k].shape
                        or not np.array_equal(got[k], want[k]))
        if differ:
            fail(f"batched {what}: instance {b} differs from prove_e2e of "
                 f"its witness in {differ}")
        return len(got)

    n_arr = identity(batched(witness_batch(1)), witness_batch(1), 0, "B = 1")
    xs16 = witness_batch(16)
    out16 = batched(xs16)
    for b in (0, 15):
        identity(out16, xs16, b, "B = 16")
    del out16
    say(f"phase 8 identity ok: a B = 1 batched call == prove_e2e on the same "
        f"witness in all {n_arr} arrays; at B = 16 instances 0 and 15 each "
        f"== prove_e2e of their own witness in all {n_arr} arrays")

    per_b = {}
    for b in BATCHES:
        xs = witness_batch(b)
        kernels.reset_counts()
        batched(xs)
        torch.cuda.synchronize()
        per_b[b] = dict(launches=dict(kernels.LAUNCHES),
                        plain=dict(kernels.PLAIN_CALLS))
        torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated()
        ts = wall_ms(torch, lambda: batched(xs), BATCH_RUNS)
        peak = torch.cuda.max_memory_allocated()
        per_b[b].update(wall_ms=ts, peak_bytes=peak,
                        call_peak_bytes=peak - held_bytes,
                        proofs_per_s=b / statistics.median(ts) * 1e3)
        say(f"phase 8 timing ({card}): B = {b}: batched call {spread(ts)}; "
            f"{per_b[b]['proofs_per_s']:.3f} proofs/s at the median; "
            f"max_memory_allocated {peak / 2 ** 30:.3f} GiB, "
            f"{(peak - held_bytes) / 2 ** 30:.3f} GiB above the "
            f"{held_bytes / 2 ** 30:.3f} GiB held before the calls; device "
            f"launches {per_b[b]['launches']}")

    batched_shapes = {e: collections.Counter() for e in KERNEL_NAMES}
    recorded = {}
    for b in (4, 64):
        xs = witness_batch(b)
        with Recorder(kernels, wrappers, twin) as rec:
            kernels.reset_counts()
            batched(xs)
            torch.cuda.synchronize()
            recorded[b] = (dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS))
        check_path(f"the batched call at B = {b}", *recorded[b],
                   BATCH_ENTRIES)
        for e, n in check_calls(rec, f"batched call at B = {b}")[0].items():
            batched_shapes[e].update(n)
    batched_launches, batched_plain = recorded[4]
    say(f"phase 8 recorded calls ok: every kernel call of one batched call "
        f"at B = 4 and of one at B = 64 == its plain twin on the same inputs, "
        f"launches as the rule says; B = 4 device launches "
        f"{batched_launches}, plain twin calls {batched_plain}; calls per "
        f"shape: {listing(batched_shapes, short=True)}")

    first = per_b[BATCHES[0]]["launches"]
    if any(per_b[b]["launches"] != first or any(per_b[b]["plain"].values())
           for b in BATCHES) or any(recorded[b][0] != first
                                    for b in recorded):
        fail(f"launches per batched call depend on B: "
             f"{ {b: per_b[b]['launches'] for b in BATCHES} }")
    if (first["sha3_chain_x64"], first["merkle_forest"],
            first["sha3_256_x64"]) != (1, 1, 0):
        fail(f"a batched call launched {first}, not one chain, one forest "
             f"and no single SHA3")
    say(f"phase 8 ok in {time.perf_counter() - t8:.1f} s: launches per "
        f"batched call {first} at every B in {BATCHES}, no plain twin call")

    # ---- phase 9: the sharded provers, S ranks sharing the card ----------
    t9 = time.perf_counter()
    sharded = {}          # (transcript, S) -> [per-rank results]
    for S, transcripts in SHARDED:
        t0 = time.perf_counter()
        ranks = pmesh.spawn(sharded_rank, 1, S,
                            args=(c, transcripts, SHARDED_RUNS))
        for tr in transcripts:
            sharded[(tr, S)] = [r[tr] for r in ranks]
        r0 = ranks[0][transcripts[0]]
        say(f"phase 9 ranks ok: {S} ranks on {r0['device']} over "
            f"{r0['backend']} ({', '.join(transcripts)}) in "
            f"{time.perf_counter() - t0:.1f} s with start-up and compile")
    sharded_shapes = {e: collections.Counter() for e in KERNEL_NAMES}
    for (tr, S), per_rank in sharded.items():
        r0 = per_rank[0]
        label = f"{'prove_fs_sharded' if tr == 'fs' else 'prove_sharded'} "\
                f"at S = {S}"
        got = proof_arrays(proof_io, np, r0["full"])
        want = proof_arrays(proof_io, np, full_fs if tr == "fs" else full)
        if int(got.pop("meta_mesh_shards")) != S:
            fail(f"{label}: meta mesh_shards is not {S}")
        differ = sorted(k for k in set(got) | set(want)
                        if k not in got or k not in want
                        or got[k].dtype != want[k].dtype
                        or not np.array_equal(got[k], want[k]))
        if differ:
            fail(f"{label} differs from the single-device card proof in "
                 f"{differ}")
        ok = (driver.verify_fs(c, r0["full"], cp) if tr == "fs"
              else driver.verify(c, r0["full"], cp)).ok
        if not ok:
            fail(f"{label}: the proof is rejected")
        # K1, K2 and the field chains launch the same on every rank; the
        # elementwise field ops follow each rank's share (a prefix sum over
        # its own contributions, the eq factor of its own bits), so their
        # counts differ by rank
        launches9 = [r["launches"] for r in per_rank]
        k_launches9 = [{e: n for e, n in l.items() if e not in ELEMENTWISE}
                       for l in launches9]
        if any(any(r["plain"].values()) for r in per_rank) or any(
                l != k_launches9[0] for l in k_launches9) or any(
                l[e] == 0 for l in launches9 for e in FS_ENTRIES):
            fail(f"{label}: launches per rank {launches9}, plain twin calls "
                 f"{[r['plain'] for r in per_rank]}: K1, K2 and the chains "
                 f"not the same on every rank, or an entry not launched on a "
                 f"rank, or a plain twin call")
        for e in KERNEL_NAMES:
            sharded_shapes[e].update(r0["shapes"][e])
            err[e] = max(err[e], r0["err"][e])
        say(f"phase 9 ok: {label} == the single-device card proof in all "
            f"{len(want)} arrays and verifies; every kernel call of rank 0 "
            f"== its plain twin; K1, K2 and chain launches per rank (the "
            f"same on all {S}) {k_launches9[0]}, field ops by rank "
            f"{[{e: l[e] for e in ELEMENTWISE} for l in launches9]}, plain "
            f"twin calls 0; calls per shape (rank 0): "
            f"{listing(r0['shapes'])}")
        say(f"phase 9 timing ({card}; {S} ranks sharing one card over "
            f"{r0['backend']}, not a scaling number): {label}: first prove "
            f"{[round(r['first_s'], 3) for r in per_rank]} s by rank; "
            f"timed proves by rank "
            f"{[[round(t, 1) for t in r['wall_ms']] for r in per_rank]} ms; "
            f"max_memory_allocated by rank "
            f"{[round(r['peak_bytes'] / 2 ** 30, 4) for r in per_rank]} GiB"
            + (f"; PC state held by rank "
               f"{[round(r['pc_bytes'] / 2 ** 20, 2) for r in per_rank]} MiB"
               if r0["pc_bytes"] else ""))
    bad = sharded[("glibc", 2)][0]["full"]
    lp = bad.layers[cc.depth - 1]
    lp["p1_polys"] = lp["p1_polys"].copy()
    lp["p1_polys"][0, 0, 1] = np.uint64((int(lp["p1_polys"][0, 0, 1]) + 1)
                                        % M)
    if driver.verify(c, bad, cp).ok:
        fail("a tampered sharded proof was accepted")
    say(f"phase 9 ok in {time.perf_counter() - t9:.1f} s: a sharded proof "
        f"with one p1_polys coefficient changed is rejected")

    # ---- phase 10: the compiled programs as CUDA graphs -------------------
    t10 = time.perf_counter()
    held_graphs = {}          # holder name -> its record

    def eager_call(eager):
        """(result, launches) of one eager call."""
        kernels.reset_counts()
        want = eager()
        torch.cuda.synchronize()
        return want, dict(kernels.LAUNCHES)

    def graph_check(label, makers, first, eager, phase="phase 10"):
        """Build the makers' graphs by calling them once (on a new shape: a
        warm-up call, the capture, a replay), then hold one more replay
        against the eager call (eager: the function, or eager_call's
        result): every array equal, launches per replay equal to the eager
        call's, no plain twin call, and each graph's kernel nodes by entry
        equal to the launches its capture counted.  Returns the replayed
        outputs."""
        want, eager_launches = (eager if isinstance(eager, tuple)
                                else eager_call(eager))
        first()
        new = [h for m in makers for h in graphs.holders(m)
               if h.name not in held_graphs]
        kernels.reset_counts()
        got = first()
        torch.cuda.synchronize()
        replay_launches = dict(kernels.LAUNCHES)
        plain = dict(kernels.PLAIN_CALLS)
        n, ok = same_arrays(torch, got, want)
        if not ok:
            fail(f"{phase} {label}: the replay differs from the eager call")
        if replay_launches != eager_launches or any(plain.values()):
            fail(f"{phase} {label}: launches per replay {replay_launches} "
                 f"against {eager_launches} eager, plain twin calls {plain}")
        for h in new:
            nodes = graph_kernel_nodes(h.graph)
            if nodes is None:
                fail(f"{phase} {h.name}: this PyTorch keeps no cudaGraph_t, "
                     f"so its kernel nodes cannot be counted")
            ours = {e: nodes[e] for e in KERNEL_NAMES if nodes[e]}
            if ours != h.launches:
                fail(f"{phase} {h.name}: kernel nodes {ours} against the "
                     f"capture's launches {h.launches}")
            held_graphs[h.name] = dict(
                launches=h.launches, kernel_nodes=sum(nodes.values()),
                capture_s=h.capture_s, warmup_s=h.warmup_s,
                pool_bytes=h.pool_bytes)
        say(f"{phase} ok ({card}): {label}: the replay == the eager call "
            f"in all {n} arrays; launches per replay {replay_launches} == the "
            f"eager "
            f"call's, plain twin calls 0; graphs " + "; ".join(
                f"{h.name}: {held_graphs[h.name]['kernel_nodes']} kernel "
                f"nodes (the port's {h.launches} == the capture's count), "
                f"capture + instantiate {h.capture_s:.3f} s, pool "
                f"{h.pool_bytes / 2 ** 20:.1f} MiB" for h in new))
        return got

    def other_inputs_check(label, first_out, replay, eager,
                           phase="phase 10", other="another witness, other "
                           "challenges and fold challenges"):
        """A replay on other inputs == the eager call on those inputs, its
        result differs from the earlier replay's, and the earlier replay's
        result is unchanged after it."""
        kept = graphs.clone(first_out)
        got = replay()
        want = eager()
        n, ok = same_arrays(torch, got, want)
        if not ok:
            fail(f"{phase} {label}: a replay on other inputs differs from "
                 f"the eager call on them")
        if same_arrays(torch, got, first_out)[1]:
            fail(f"{phase} {label}: other inputs gave the same result")
        if not same_arrays(torch, first_out, kept)[1]:
            fail(f"{phase} {label}: a later replay changed the result an "
                 f"earlier one returned")
        say(f"{phase} ok: {label} on {other}: the replay == the eager call "
            f"in all {n} arrays; the earlier replay's result is unchanged")

    e2e = fused.make_e2e_prover(cc, cp.plans)
    tape = fused.make_fg_tape(n_folds)
    # the graphs' warm-up calls and the eager calls held against the twins
    with Recorder(kernels, wrappers, twin) as rec:
        first10 = graph_check(
            "make_e2e_prover + make_fg_tape", (e2e, tape),
            lambda: (e2e(inputs, ch, fold_rands), tape(sched)),
            lambda: (fused.prove_e2e(cc, cp.plans, inputs, ch, fold_rands,
                                     cp.arrs),
                     fused.fg_tape(n_folds, sched, dev)))
    check_calls(rec, "e2e and tape graphs' warm-ups and eager calls")
    ch2, sched2, fold_rands2 = draws(4242)
    final_point2 = ch2.layers[1].r_liu[:, :bl0]
    inputs2 = input_buffer(cc, witness_batch(2)[1], dev)
    other_inputs_check(
        "make_e2e_prover + make_fg_tape", first10,
        lambda: (e2e(inputs2, ch2, fold_rands2), tape(sched2)),
        lambda: (fused.prove_e2e(cc, cp.plans, inputs2, ch2, fold_rands2,
                                 cp.arrs),
                 fused.fg_tape(n_folds, sched2, dev)))
    del first10
    values10 = graph_check("make_evaluator (driver's)", (cp.evaluator,),
                           lambda: cp.evaluator(inputs),
                           lambda: evaluate(cc, inputs, cp.arrs))
    nodes = {what: [held_graphs[h.name]["kernel_nodes"]
                    for h in graphs.holders(m)]
             for what, m in (("evaluator", cp.evaluator), ("tape", tape),
                             ("e2e prover", e2e))}
    say(f"phase 10 kernel nodes by graph: {nodes}")
    staged = protocol.make_prover(cc, cp.plans)
    # every kernel call of the eager provers and of the staged graphs'
    # warm-up calls held against its twin
    with Recorder(kernels, wrappers, twin) as rec:
        for label, prover in (("make_prover unstaged (driver's)", cp.prover),
                              ("make_prover staged", staged)):
            graph_check(label, (prover,), lambda: prover(values10, ch),
                        lambda: protocol.prove(cc, cp.plans, values10, ch,
                                               cp.arrs))
    prover_shapes, _ = check_calls(rec, "staged and one-graph provers")
    say(f"phase 10 recorded calls ok: every kernel call of the eager provers "
        f"and of the staged prover's warm-up == its plain twin; calls per "
        f"shape: {listing(prover_shapes)}")
    # each stage's time apart: its graph replayed on the buffers of the
    # call above, between CUDA events
    stage_ms = {h.name: event_ms(torch, h.replay, 5)
                for h in graphs.holders(staged) + graphs.holders(cp.prover)}
    one_graph = stage_ms.pop(graphs.holders(cp.prover)[0].name)
    say(f"phase 10 timing ({card}): the prover's stages, ms per replay "
        f"(CUDA events over 5 replays): {stage_ms}; together "
        f"{sum(stage_ms.values()):.3f} against {one_graph:.3f} for the one "
        f"graph")
    fns = cp.pc_fns
    eager_fns = cp.pc.compile(bl0, dev, graphed=False)

    def pc_check(name, *args):
        return graph_check(f"VirgoPC {name} (driver's)", (fns[name],),
                           lambda: fns[name](*args),
                           lambda: eager_fns[name](*args))

    l_oracle10, _ = pc_check("commit", inputs)
    q10 = pc_check("q_prepare", final_point)
    pub10 = pc_check("commit_pub", l_oracle10.codeword, q10[0])
    pc_check("folds", pub10[4], fold_rands)
    del values10, l_oracle10, q10, pub10
    driver_graphs = [h for obj in (cp.evaluator, cp.prover, fns)
                     for h in graphs.holders(obj)]
    used = {h.name: h.replays for h in driver_graphs}
    if len(used) != 6 or not all(used.values()) or any(
            h.graph is None for h in driver_graphs):
        fail(f"phase 10: driver.prove did not run through its 6 graphs: "
             f"replays {used}")
    say(f"phase 10 driver ok: driver.prove runs through the graphs of "
        f"compile_prover (so phases 4-5 held them: small1200 pins, card "
        f"proof == CPU proof, full width verified); replays by graph {used}")

    run_graphs = make_batched_full_prover(cc, cp.plans)
    replay_batch = {}
    for b in BATCHES:
        xs = witness_batch(b)
        got = graph_check(f"make_batched_full_prover at B = {b}",
                          (run_graphs,),
                          lambda: run_graphs(xs, ch, final_point, fold_rands),
                          lambda: batched(xs))
        if b == 4:
            xs2 = witness_batch(5)[1:]
            other_inputs_check(
                "make_batched_full_prover at B = 4", got,
                lambda: run_graphs(xs2, ch2, final_point2, fold_rands2),
                lambda: run_batch(xs2, ch2, final_point2, fold_rands2))
        del got
        ts = wall_ms(torch, lambda: run_graphs(xs, ch, final_point,
                                               fold_rands), BATCH_RUNS)
        replay_batch[b] = dict(wall_ms=ts, proofs_per_s=b / statistics.median(
            ts) * 1e3)
        say(f"phase 10 timing ({card}): B = {b}: batched replay {spread(ts)};"
            f" {replay_batch[b]['proofs_per_s']:.3f} proofs/s at the median "
            f"against {per_b[b]['proofs_per_s']:.3f} eager (phase 8)")
    pools = sum(h.pool_bytes for h in graphs.holders(run_graphs))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graphs.release(run_graphs)
    torch.cuda.empty_cache()
    released = reserved - torch.cuda.memory_reserved()
    say(f"phase 10 release: graphs.release of the batched maker gave back "
        f"{released / 2 ** 20:.1f} MiB of reserved device memory; its "
        f"graphs' pools at B = {BATCHES} were {pools / 2 ** 20:.1f} MiB")

    t_replay = wall_ms(torch, lambda: (e2e(inputs, ch, fold_rands),
                                       tape(sched)), TIMED_RUNS)
    t_driver_eager = wall_ms(torch, lambda: driver.prove(c, eager_cp),
                             VERIFY_RUNS)
    t_driver_graphs = wall_ms(torch, lambda: driver.prove(c, cp), VERIFY_RUNS)

    def one_shot(graphed):
        """compile_prover and one prove, as a process that proves once:
        (ms of both, ms of compile_prover)."""
        t0 = time.perf_counter()
        compiled = driver.compile_prover(c, graphed=graphed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        driver.prove(c, compiled)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    t_one_shot = {"graphed": [], "eager": []}
    t_one_shot_compile = {"graphed": [], "eager": []}
    for _ in range(2):
        for k in t_one_shot:
            both, compile_ms = one_shot(k == "graphed")
            t_one_shot[k].append(both)
            t_one_shot_compile[k].append(compile_ms)
    say(f"phase 10 timing ({card}): timed prove replayed (e2e + tape) "
        f"{spread(t_replay)} against eager {statistics.median(t_e2e):.3f} "
        f"(phase 5); driver.prove through the graphs {spread(t_driver_graphs)}"
        f", eager {spread(t_driver_eager)}; compile_prover + one prove "
        f"(ms): graphed {t_one_shot['graphed']}, eager {t_one_shot['eager']}"
        f", of which compile_prover: graphed {t_one_shot_compile['graphed']}"
        f", eager {t_one_shot_compile['eager']}")
    say(f"phase 10 ok in {time.perf_counter() - t10:.1f} s: {len(held_graphs)}"
        f" graphs held against their eager calls")

    # ---- phase 11: the FS and verifier programs as CUDA graphs -----------
    t11 = time.perf_counter()
    p11 = "phase 11"
    graphed11 = {}            # maker label -> maker, released at the end

    def fs_inputs(inp):
        """(values, root_l, l codeword) of a witness, through the driver's
        evaluator and commit graphs."""
        values = cp.evaluator(inp)
        l_or, _ = cp.pc.commit_private(cp.pc_fns, inp)
        return values, l_or.tree[:, 1], l_or.codeword

    # each eager call once, on the two witnesses; the PC half's inputs come
    # from the GKR walk's
    eager_fs = fs.make_fs_prover(cc, cp.plans, cp.arrs, dev, graphed=False)
    eager_pc = fs.make_fs_pc_prover(bl0, dev, graphed=False)
    fs_in = {1: fs_inputs(inputs), 2: fs_inputs(inputs2)}
    gkr_ref = {k: eager_call(lambda: eager_fs(v, r))
               for k, (v, r, _) in fs_in.items()}
    pc_in = {k: (fs_in[k][2], gkr_ref[k][0][1].layers[1].r_liu[:, :bl0],
                 gkr_ref[k][0][2]) for k in fs_in}
    pc_ref = {k: eager_call(lambda: eager_pc(*a)) for k, a in pc_in.items()}
    replay_ms = {}
    for what, make, args, ref in (
            ("make_fs_prover",
             lambda st: fs.make_fs_prover(cc, cp.plans, cp.arrs, dev, st),
             {k: v[:2] for k, v in fs_in.items()}, gkr_ref),
            ("make_fs_pc_prover",
             lambda st: fs.make_fs_pc_prover(bl0, dev, st), pc_in, pc_ref)):
        for staged in (True, False):
            ours = staged == driver.FS_STAGED
            maker = ((cp.fs_prover if what == "make_fs_prover"
                      else cp.fs_pc_prover) if ours else make(staged))
            mine = " (driver's)" if ours else ""
            label = f"{what} {'staged' if staged else 'unstaged'}{mine}"
            if not ours:
                graphed11[label] = maker
            got = graph_check(label, (maker,), lambda: maker(*args[1]),
                              ref[1], p11)
            other_inputs_check(label, got, lambda: maker(*args[2]),
                               lambda: ref[2][0], p11, "another witness")
            del got
            replay_ms[label] = wall_ms(torch, lambda: maker(*args[1]),
                                       VERIFY_RUNS)
            say(f"{p11} timing ({card}): {label} replay "
                f"{spread(replay_ms[label])}")
    del gkr_ref, pc_in, pc_ref

    # the verifier, on phase 5's proof under the glibc stream
    def port_proof(layers):
        return protocol.Proof(vres=gf.tensor(full.vres, dev), layers=[None] + [
            driver._layer_proof_from(layers[i], dev)
            for i in range(1, cc.depth)])

    vch = protocol.make_challenges(cc, GlibcRandom(3396), dev)
    vproof = port_proof(full.layers)
    bad_layers = list(full.layers)
    bad_layers[-1] = dict(bad_layers[-1], p1_polys=bumped(
        bad_layers[-1]["p1_polys"], (0, 0, 1)))
    bad_proof = port_proof(bad_layers)
    out_block = fs_in[1][0][:, int(cc.value_off[cc.depth - 1]):]
    wrong_block = out_block.roll(1, dims=1)
    eager_v = protocol.make_verifier(cc, dev, graphed=False)

    def with_ok(r):
        """A verifier's (ok, claim, point) with ok as a tensor, so that
        same_arrays holds it too."""
        return (torch.tensor(r[0]),) + tuple(r[1:])

    v_ref = {out is None: eager_call(
        lambda: with_ok(eager_v(vproof, vch, out)))
        for out in (None, out_block)}
    for staged in (True, False):
        ours = staged      # compile_prover's verifier is the staged one
        v = cp.verifier if ours else protocol.make_verifier(cc, dev, False)
        mine = " (driver's)" if ours else ""
        label = f"make_verifier {'staged' if staged else 'unstaged'}{mine}"
        if not ours:
            graphed11[label] = v
        for out in (None, out_block):
            which = f"{label}, {'no' if out is None else 'with'} output block"
            got = graph_check(which, (v,),
                              lambda: with_ok(v(vproof, vch, out)),
                              v_ref[out is None], p11)
            if not bool(got[0]):
                fail(f"{p11} {which}: the proof is rejected")
        n_holders = len(graphs.holders(v))
        rejects = {"p1_polys coefficient": v(bad_proof, vch, None)[0],
                   "p1_polys coefficient, with the block":
                       v(bad_proof, vch, out_block)[0],
                   "wrong output block": v(vproof, vch, wrong_block)[0]}
        if any(rejects.values()) or len(graphs.holders(v)) != n_holders:
            fail(f"{p11} {label}: accepted a tampered proof {rejects}, or "
                 f"built a holder for it")
        say(f"{p11} ok: {label} rejects a proof with one p1_polys "
            f"coefficient changed (with and without the output block) and a "
            f"wrong output block, by replaying its {n_holders} graphs")
    del fs_in

    # verify_fs through the graphs rejects a tampered FS proof
    layers = list(full_fs.layers)
    layers[-1] = dict(layers[-1],
                      p1_polys=bumped(layers[-1]["p1_polys"], (0, 0, 1)))
    replays = sum(h.replays for h in graphs.holders(cp.verifier))
    if driver.verify_fs(c, dataclasses.replace(full_fs, layers=layers),
                        cp).ok:
        fail(f"{p11}: graphed verify_fs accepted a tampered FS proof")
    if sum(h.replays for h in graphs.holders(cp.verifier)) == replays:
        fail(f"{p11}: verify_fs did not run through the verifier's graphs")
    say(f"{p11} ok: verify_fs through the graphs rejects an FS proof with "
        f"one p1_polys coefficient changed")

    # the driver's paths through a graphed compile_prover, beside phases
    # 5 and 7's eager runs
    splits = []

    def verify_split(fn):
        def run():
            fn()
            splits.append(cp.verifier.last_split)
        return run

    t_fs_graphs = wall_ms(torch, lambda: driver.prove_fs(c, cp), VERIFY_RUNS)
    t_verify_graphs = wall_ms(torch, verify_split(
        lambda: driver.verify(c, full, cp)), VERIFY_RUNS)
    verify_splits = splits[1:]
    splits.clear()
    t_fs_verify_graphs = wall_ms(torch, verify_split(
        lambda: driver.verify_fs(c, full_fs, cp)), VERIFY_RUNS)
    fs_verify_splits = splits[1:]
    fmt = lambda sp: [[round(f * 1e3, 3), round(s_ * 1e3, 3)]
                      for f, s_ in sp]
    say(f"{p11} timing ({card}): through a graphed compile_prover: prove_fs "
        f"{spread(t_fs_graphs)} against eager median "
        f"{statistics.median(t_fs_prove):.3f} (phase 7); driver.verify "
        f"{spread(t_verify_graphs)} against eager median "
        f"{statistics.median(t_verify):.3f} (phase 5), its last_split (ms, "
        f"fast/slow) by run {fmt(verify_splits)}; verify_fs "
        f"{spread(t_fs_verify_graphs)} against eager median "
        f"{statistics.median(t_fs_verify):.3f} (phase 7), last_split "
        f"{fmt(fs_verify_splits)}")
    pools = sum(h.pool_bytes for m in graphed11.values()
                for h in graphs.holders(m))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    for m in graphed11.values():
        graphs.release(m)
    torch.cuda.empty_cache()
    released11 = reserved - torch.cuda.memory_reserved()
    say(f"{p11} release ({card}): graphs.release of {list(graphed11)} gave "
        f"back "
        f"{released11 / 2 ** 20:.1f} MiB of reserved device memory; their "
        f"pools were {pools / 2 ** 20:.1f} MiB")
    del graphed11
    say(f"{p11} ok in {time.perf_counter() - t11:.1f} s ({card})")

    # ---- the launches of every path, by entry -----------------------------
    fs_verify_launches = {e: fs_path_launches[e] - fs_launches[e]
                          for e in KERNEL_NAMES}
    paths = {"timed prove": timed_launches, "driver.prove": prove_launches,
             "driver.verify": verify_launches, "prove_fs": fs_launches,
             "verify_fs": fs_verify_launches,
             "batched call (any B)": batched_launches}
    for (tr, S), per_rank in sharded.items():
        paths[f"{tr} S = {S}, per rank"] = per_rank[0]["launches"]
    for entry in KERNEL_NAMES:
        say(f"launches of {entry} by path (main paths through the graphs, "
            f"counted alone; plain twin calls 0 on each): "
            + ", ".join(f"{k} {v[entry]}" for k, v in paths.items()))

    # ---- each kernel entry at every shape the paths gave it, profiled -----
    rows = {}
    for entry, names in KERNEL_NAMES.items():
        per = {}
        found = (set(driver_shapes[entry]) | set(timed_shapes[entry])
                 | set(fs_shapes[entry]) | set(batched_shapes[entry])
                 | set(sharded_shapes[entry])
                 | set(FIXED_SHAPES.get(entry, ())))
        for shp in sorted(found):
            ins = example.get((entry, shp)) or random_inputs(
                torch, np, gf, entry, shp, dev, rng)
            nl = expected_launches(entry, ins)
            ms = profiled_ms(torch, lambda: cuda_fn[entry](*ins),
                             PROFILE_REPS[entry], names, nl)
            if ms is None:
                fail(f"the profiler missed launches of {entry} at "
                     f"{list(shp)} in every try: its device time is not "
                     f"measured")
            nbytes, ops = cost(entry, shp, ins)
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = ops / int32_rate * 1e3
            per[shp] = dict(driver=driver_shapes[entry][shp],
                            timed=timed_shapes[entry][shp],
                            fs=fs_shapes[entry][shp],
                            batched=batched_shapes[entry][shp],
                            sharded=sharded_shapes[entry][shp], ms=ms,
                            launches=nl, bound=max(t_bytes, t_ops),
                            by="bytes" if t_bytes >= t_ops else "operations")
        # the shape that takes the most kernel time in one timed prove (in
        # one FS prove for the sponge's SHA3)
        top = max(per, key=lambda s: (per[s]["timed"] * per[s]["ms"],
                                      per[s]["driver"] * per[s]["ms"],
                                      per[s]["fs"] * per[s]["ms"]))
        plain_ms = event_ms(torch, lambda: twin[entry](*example[(entry, top)]),
                            3)
        # a field op's bucket holds calls of up to twice the size and of
        # other broadcast patterns: its paths' device times are the whole
        # profiles' (phases 6 and 7), not a bucket's time times its calls
        exact = entry not in GF_ENTRIES
        rows[entry] = dict(
            per=per, top=top, plain_ms=plain_ms,
            **{f"{k}_ms": sum(r[k] * r["ms"] for r in per.values())
               if exact else None for k in ("timed", "driver", "fs")},
            timed_bound=bound_ms(timed_costs[entry], int32_rate),
            fs_bound=bound_ms(fs_costs[entry], int32_rate),
            sharded_ms={f"{tr} S={S}": sum(
                n * per[shp]["ms"] for shp, n in
                sharded[(tr, S)][0]["shapes"][entry].items())
                for tr, S in sharded} if exact else None)
        shared = entry in INIT_ENTRIES or entry in FUSED_ENTRIES
        paths = (f"; rank 0 of a sharded prove (ms): "
                 f"{rows[entry]['sharded_ms']}; one timed prove "
                 f"{rows[entry]['timed_ms']:.4f} ms, one "
                 f"driver prove + verify {rows[entry]['driver_ms']:.4f} ms, "
                 f"one FS prove + verify_fs {rows[entry]['fs_ms']:.4f} ms"
                 if exact else "; device time by path: the whole profiles")
        say(f"kernel {entry} (profiled device time"
            f"{'' if exact else ' of the first call of each size bucket'}; "
            f"calls in the first "
            f"driver prove + verify / timed prove / first FS prove + "
            f"verify_fs / batched calls at B = 4 and 64 / rank 0 of the "
            f"sharded runs, ms per call, launches per call, bound ms"
            f"{', the bound over the time' if shared else ''}"
            f"): "
            + "; ".join(
                f"{shape_label(entry, list(s))}: {r['driver']}/{r['timed']}/"
                f"{r['fs']}/{r['batched']}/{r['sharded']}, {r['ms']:.5f}, "
                f"{r['launches']:g}, {r['bound']:.7f} {r['by']}"
                + (f", share {r['bound'] / r['ms']:.3f}" if shared else "")
                for s, r in per.items())
            + paths + f"; bound of every recorded call summed: one timed "
            f"prove {rows[entry]['timed_bound']:.5f} ms, one FS prove + "
            f"verify_fs {rows[entry]['fs_bound']:.5f} ms; top shape "
            f"{list(top)}: plain twin {plain_ms:.3f} ms")
    example.clear()

    # ---- whole-call profiles, after every per-shape profile: a large
    # trace makes later short profiles miss launches (9 of 20 K1 launches
    # after a 120k-launch trace: scripts/torch_profiler_probe.py), so they
    # come last.  The batched and FS ones check their counts of the port's
    # kernels against the launch counters.  The batched call goes first (a
    # batched trace made after the timed prove's missed its chain and
    # forest launches), device activity only, repeated up to 5 times while
    # a launch is missing.
    from torch.profiler import ProfilerActivity, profile
    xs = witness_batch(PROFILED_BATCH)
    batched(xs)
    torch.cuda.synchronize()
    for b_try in range(1, 6):
        kernels.reset_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            batched(xs)
            torch.cuda.synchronize()
        b_launches = dict(kernels.LAUNCHES)
        b_rows = [(device_us(e), e.count, e.key)
                  for e in prof.key_averages() if is_device_row(e)]
        b_profiled = {e: [0.0, 0] for e in KERNEL_NAMES}
        for entry, names in KERNEL_NAMES.items():
            for us, cnt, key in b_rows:
                if any(n in key for n in names):
                    b_profiled[entry][0] += us / 1e3
                    b_profiled[entry][1] += cnt
        held = all(b_profiled[e][1] == b_launches[e] for e in KERNEL_NAMES)
        if held:
            break
    b_busy = sum(r[0] for r in b_rows) / 1e3
    b_idle = None
    if b_busy > 0:
        med = statistics.median(per_b[PROFILED_BATCH]["wall_ms"])
        b_idle = 1 - b_busy / med
        say(f"phase 8 profile of one batched call at B = {PROFILED_BATCH} "
            f"(try {b_try}): {sum(r[1] for r in b_rows)} kernel launches, "
            f"device busy {b_busy:.3f} ms; idle share {b_idle:.4f} of the "
            f"median wall {med:.1f} ms; the port's kernels (device ms, "
            f"launches): {b_profiled}, "
            + ("every launch of the counters held" if held
               else "launches missing against the counters in every try: "
               "device busy is a lower bound"))
        for us, cnt, key in sorted(b_rows, reverse=True)[:8]:
            say(f"phase 8   {us / 1e3:9.3f} ms  x{cnt:6d}  {key[:90]}")
    else:
        say("phase 8 profile: the profiler recorded no device time "
            "(device busy share not measured)")

    # device activity only, as the other whole-call profiles: only device
    # rows are read, and CPU-side op events took most of this profile's time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timed_prove()
        torch.cuda.synchronize()
    prof_rows = sorted(((device_us(e), e.count, e.key)
                        for e in prof.key_averages() if is_device_row(e)),
                       reverse=True)
    busy_ms = sum(r[0] for r in prof_rows) / 1e3
    n_kern = sum(r[1] for r in prof_rows)
    profiled = {e: [0.0, 0] for e in KERNEL_NAMES}
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
        for entry, names in KERNEL_NAMES.items():
            for us, cnt, key in prof_rows:
                if any(n in key for n in names):
                    profiled[entry][0] += us / 1e3
                    profiled[entry][1] += cnt
        held = all(profiled[e][1] == timed_launches[e] for e in KERNEL_NAMES)
        say(f"phase 6 profile, the port's kernels in that prove (device ms, "
            f"launches): {profiled}, " + (
                "every launch of the counters held" if held else
                f"against the counted {timed_launches}: launches missing"))
    else:
        say("phase 6 profile: the profiler recorded no device time "
            "(device busy share not measured)")

    # device activity only: an FS prove also makes ~0.9M CPU-side op
    # events, and a trace of 400k launches took the profiler over 100 s
    # (scripts/torch_profiler_probe.py)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.prove_fs(c, eager_cp)
        torch.cuda.synchronize()
    fs_rows = [(device_us(e), e.count, e.key)
               for e in prof.key_averages() if is_device_row(e)]
    fs_busy = sum(r[0] for r in fs_rows) / 1e3
    fs_idle = None
    fs_profiled = {e: [0.0, 0] for e in KERNEL_NAMES}
    if fs_busy > 0:
        med = statistics.median(t_fs_prove)
        fs_idle = 1 - fs_busy / med
        for entry, names in KERNEL_NAMES.items():
            for us, cnt, key in fs_rows:
                if any(n in key for n in names):
                    fs_profiled[entry][0] += us / 1e3
                    fs_profiled[entry][1] += cnt
        held = all(fs_profiled[e][1] == fs_launches[e] for e in KERNEL_NAMES)
        say(f"phase 7 profile of one eager prove_fs: "
            f"{sum(r[1] for r in fs_rows)} kernel launches, device busy "
            f"{fs_busy:.3f} ms; idle share {fs_idle:.4f} of the median wall "
            f"{med:.1f} ms; the port's kernels (device ms, launches): "
            f"{fs_profiled}, " + ("every launch of the counters held" if held
                                  else "launches missing against the "
                                  "counters: device busy is a lower bound"))
        for us, cnt, key in sorted(fs_rows, reverse=True)[:8]:
            say(f"phase 7   {us / 1e3:9.3f} ms  x{cnt:6d}  {key[:90]}")
    else:
        say("phase 7 profile: the profiler recorded no device time "
            "(device busy share not measured)")

    # phases 10 and 11's replays, profiled last: one replay of the timed
    # prove's two graphs (e2e + tape), one batched replay at B = 16 (its
    # graph made anew, since phase 10 released the maker's), one
    # driver.prove and one driver.prove_fs through their graphs (the main
    # paths of phases 5 and 7).  The profiler's kernels of each
    # port entry must equal the launches the holders added (and the eager
    # calls counted); a profile that missed some is repeated, up to 5 tries.
    xs = witness_batch(PROFILED_BATCH)
    replay_prof = {}
    for label, fn, walls in (
            ("timed prove replay", lambda: (e2e(inputs, ch, fold_rands),
                                            tape(sched)), t_replay),
            (f"batched replay at B = {PROFILED_BATCH}",
             lambda: run_graphs(xs, ch, final_point, fold_rands),
             replay_batch[PROFILED_BATCH]["wall_ms"]),
            ("driver.prove through the graphs",
             lambda: driver.prove(c, cp), t_driver_graphs),
            ("driver.prove_fs through the graphs",
             lambda: driver.prove_fs(c, cp), t_fs_graphs)):
        fn()
        torch.cuda.synchronize()
        for r_try in range(1, 6):
            kernels.reset_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            r_launches = dict(kernels.LAUNCHES)
            r_rows = [(device_us(e), e.count, e.key)
                      for e in prof.key_averages() if is_device_row(e)]
            ours = {e: sum(cnt for _, cnt, key in r_rows
                           if any(n in key for n in KERNEL_NAMES[e]))
                    for e in KERNEL_NAMES}
            if ours == r_launches:
                break
        else:
            fail(f"phase 10-11 profile of one {label}: the profiler's kernels "
                 f"of the port {ours} differ from the counted launches "
                 f"{r_launches} in 5 tries")
        r_busy = sum(r[0] for r in r_rows) / 1e3
        med = statistics.median(walls)
        replay_prof[label] = dict(
            busy_ms=r_busy, kernels=sum(r[1] for r in r_rows),
            idle_share=1 - r_busy / med, port_kernels=ours)
        say(f"phase 10-11 profile of one {label} (try {r_try}): "
            f"{replay_prof[label]['kernels']} kernels, device busy "
            f"{r_busy:.3f} ms; idle share "
            f"{replay_prof[label]['idle_share']:.4f} of the median wall "
            f"{med:.1f} ms; the port's kernels {ours} == the counted "
            f"launches")
    main_prof = replay_prof["driver.prove through the graphs"]["port_kernels"]
    if main_prof != prove_launches:
        fail(f"phase 5's main-path prove launched {prove_launches} by the "
             f"counters, a profiled driver.prove {main_prof}")
    fs_prof = replay_prof["driver.prove_fs through the graphs"]["port_kernels"]
    if fs_prof != fs_launches:
        fail(f"phase 7's main-path prove_fs launched {fs_launches} by the "
             f"counters, a profiled driver.prove_fs {fs_prof}")

    def entry_json(entry):
        row = rows[entry]
        top = row["per"][row["top"]]
        source, replaces = SOURCE_AND_REPLACES[entry]
        return {"name": entry, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (launches[entry] + fs_path_launches[entry]
                             + batched_launches[entry]
                             + sum(r[0]["launches"][entry]
                                   for r in sharded.values())),
                "max_abs_err": err[entry], "ms": top["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": top["bound"],
                "bound_by": top["by"], "library_ms": None,
                "shape": list(row["top"]),
                "timed_prove_launches": timed_launches[entry],
                # the field ops': the timed prove's whole profile
                "timed_prove_kernel_ms": row["timed_ms"] if entry not in
                GF_ENTRIES else profiled[entry][0] or None,
                "timed_prove_bound_ms": row["timed_bound"],
                "profiled_device_ms": profiled[entry][0],
                "glibc_path_launches": launches[entry],
                "driver_prove_launches": prove_launches[entry],
                "verify_launches": verify_launches[entry],
                "fs_verify_launches": fs_verify_launches[entry],
                "fs_prove_launches": fs_launches[entry],
                "fs_prove_kernel_ms": row["fs_ms"],
                "fs_prove_bound_ms": row["fs_bound"],
                "fs_prove_profiled_ms": fs_profiled[entry][0],
                "batched_call_launches": batched_launches[entry],
                "batched_profiled_ms": b_profiled[entry][0],
                "sharded_rank_launches": {
                    f"{tr} S={S}": r[0]["launches"][entry]
                    for (tr, S), r in sharded.items()},
                "sharded_rank0_kernel_ms": row["sharded_ms"]}

    report = {"kernels": [entry_json(e) for e in KERNEL_NAMES],
              "timed_prove_ms": t_e2e, "verify_ms": t_verify,
              "driver_prove_ms": t_driver, "device_busy_ms": busy_ms or None,
              "idle_share_of_median": idle,
              "fs_prove_launches": fs_launches, "fs_prove_ms": t_fs_prove,
              "fs_verify_ms": t_fs_verify, "fs_device_busy_ms": fs_busy or None,
              "fs_idle_share": fs_idle,
              "batched": {str(b): {k: per_b[b][k] for k in
                                   ("wall_ms", "proofs_per_s", "peak_bytes",
                                    "call_peak_bytes")}
                          for b in BATCHES},
              "batched_profiled_b": PROFILED_BATCH,
              "batched_device_busy_ms": b_busy or None,
              "batched_idle_share": b_idle,
              "graphs": held_graphs,
              "timed_prove_replay_ms": t_replay,
              "driver_prove_graphs_ms": t_driver_graphs,
              "driver_prove_eager_ms": t_driver_eager,
              "batched_replay": {str(b): r for b, r in replay_batch.items()},
              "batched_released_bytes": released,
              "one_shot_prove_ms": t_one_shot,
              "one_shot_compile_ms": t_one_shot_compile,
              "prover_stage_ms": stage_ms, "prover_one_graph_ms": one_graph,
              "main_prove_launches": prove_launches,
              "replay_profiles": replay_prof,
              "fs_prove_graphs_ms": t_fs_graphs,
              "verify_graphs_ms": t_verify_graphs,
              "verify_graphs_splits": verify_splits,
              "fs_verify_graphs_ms": t_fs_verify_graphs,
              "fs_verify_graphs_splits": fs_verify_splits,
              "fs_program_replay_ms": replay_ms,
              "phase11_released_bytes": released11,
              "sharded": {f"{tr} S={S}": {
                  "backend": r[0]["backend"],
                  "first_prove_s": [x["first_s"] for x in r],
                  "wall_ms": [x["wall_ms"] for x in r],
                  "peak_bytes": [x["peak_bytes"] for x in r]}
                  for (tr, S), r in sharded.items()}}
    say(f"card: {card}", stamp=False)
    say(json.dumps(report), stamp=False)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), stamp=False)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as exc:  # any phase failing fails the run
        import traceback
        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
