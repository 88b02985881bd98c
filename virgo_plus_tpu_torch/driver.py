"""End-to-end Virgo++ proving and verification on PyTorch.

Counterpart of ``virgo_plus_tpu/driver.py`` (reference src/main.cpp:145-159,
verifier.cpp:134-189):

  * ``prove``     -> a standalone serialized proof (proof_io.FullProof)
  * ``verify``    -> consumes only the circuit + proof + challenge stream
  * ``prove_fs``  -> a non-interactive (Fiat-Shamir) proof: every challenge
                     squeezed from a SHA3 sponge on the device (gkr/fs.py)
  * ``verify_fs`` -> re-derives those challenges from the proof alone
  * ``run``       -> prove + verify, in either transcript mode, on one
                     device or sharded over a (dp, sp) mesh of ranks
                     (``parallel/``)

glibc-stream challenges come from the reference's exact stream, so
transcripts are bit-identical to the JAX package's and the reference's; FS
proofs are bit-identical to the JAX package's ``prove_fs``.  Every entry
point takes ``device=None``, which means the CUDA card, and raises without
one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np
import torch

from . import device as _device
from . import native, proof_io
from .config import ProtocolConfig
from .field import gf
from .field.ref import Fq2
from .utils import metrics
from .utils.glibc_rand import GlibcRandom
from .circuits.pws import parse_pws
from .circuits.layered import dag_to_layered, subset_init, LayeredCircuit
from .circuits.compile import compile_circuit, input_buffer
from .gkr import fs, protocol
from .pc import fft_gkr, virgo_pc, vpd


@dataclass
class Report:
    ok: bool
    gkr_ok: bool
    pc_ok: bool
    input_size: int
    gkr_proof_size: int        # bytes
    pc_proof_size: int         # bytes
    prove_time: float = 0.0
    verify_time: float = 0.0
    # reference fast/slow verifier split (verifier.cpp:180, verifier.h:45-46):
    # slow = the O(#gates) wiring-predicate sweeps, fast = everything else
    verify_time_fast: float = 0.0
    verify_time_slow: float = 0.0
    details: dict = dc_field(default_factory=dict)


def _check_asserts(cc, values) -> None:
    """prover.cpp:14-25: refuse to prove when an assert gate is nonzero."""
    for i in range(1, cc.depth):
        L = cc.layers[i]
        if not L.has_assert:
            continue
        off = int(cc.value_off[i])
        block = gf.to_numpy(values[:, off:off + L.size])
        bad = (block != 0).any(axis=0) & L.is_assert
        if bad.any():
            g = int(np.argmax(bad))
            raise ValueError(
                f"assert gate failed: layer {i} gate {g} is nonzero")


def gkr_proof_size_bytes(cc) -> int:
    """Reference accounting: 48B per round poly (prover.cpp:451), 16B per
    claim (500, 512)."""
    total = 0
    for i in range(cc.depth - 1, 0, -1):
        bl_prev = cc.layers[i - 1].bit_length
        total += 48 * bl_prev + 16            # phase 1 + claim_u
        if cc.layers[i].max_dad_bit_length >= 0:
            total += 48 * cc.layers[i].max_dad_bit_length
            total += 16 * i                   # one claim per source layer
        total += 48 * bl_prev                 # Liu
    return total


# the form of the FS programs that prove_fs makes for a compiled prover:
# unstaged (one graph a half), whose replays were the faster on the H100
# once the field ops were kernels, at half the capture time of the staged
# form (a graph a layer, a graph a FRI level; PERF.md section 5)
FS_STAGED = False


@dataclass
class CompiledProver:
    cc: object
    plans: object
    arrs: dict           # prover index/coefficient tensors on the device
    evaluator: object    # protocol.make_evaluator's
    prover: object       # protocol.make_prover's, unstaged
    verifier: object
    pc: object           # pc.interface.VirgoPC
    pc_fns: dict         # its per-size programs
    device: torch.device
    graphed: bool = True       # whether the programs are graphs
    # fs.make_fs_prover's and make_fs_pc_prover's, made at first prove_fs
    fs_prover: object = None
    fs_pc_prover: object = None


def load_circuit(pws_path: str, bug_compat: bool = True,
                 prefer_native: bool = True,
                 config: Optional[ProtocolConfig] = None) -> LayeredCircuit:
    """Parse + layer + subset-init.  Uses the native C++ frontend (built at
    first use) unless no C++ compiler is found; then, or with
    prefer_native=False, the Python frontend, which gives the same
    structures.  A failed native build or parse raises."""
    if config is not None:
        bug_compat = config.bug_compat
    if prefer_native and native.available():
        return native.load_circuit(pws_path, bug_compat=bug_compat)
    c = dag_to_layered(parse_pws(pws_path), bug_compat=bug_compat)
    subset_init(c)
    return c


def compile_prover(c: LayeredCircuit, pc: Optional[object] = None,
                   device=None, graphed: bool = True) -> CompiledProver:
    """Compile the circuit and move its tables to the device.  The
    evaluator, the GKR prover, the verifier, the PC's programs and (made at
    the first ``prove_fs``) the FS programs are graphs, captured at their
    first call (graphs.py); graphed=False keeps them eager, which costs
    less for a caller that proves once, since the first call of a graph
    also pays an eager call and the capture.  pc defaults to the Virgo VPD
    (the reference's USE_VIRGO branch)."""
    from .pc.interface import DEFAULT_PC

    dev = _device.resolve(device)
    cc = compile_circuit(c)
    plans = protocol.build_plans(cc)
    pc = pc or DEFAULT_PC
    return CompiledProver(
        cc=cc, plans=plans, arrs=protocol.circuit_arrays(cc, plans, dev),
        evaluator=protocol.make_evaluator(cc, dev, graphed),
        prover=protocol.make_prover(cc, plans, dev, staged=False,
                                    graphed=graphed),
        verifier=protocol.make_verifier(cc, dev, graphed=graphed), pc=pc,
        pc_fns=pc.compile(cc.layers[0].bit_length, dev, graphed), device=dev,
        graphed=graphed)


def _compiled(circuit, compiled, device) -> CompiledProver:
    """The caller's compiled prover, or an eager one for a single call."""
    return compiled or compile_prover(circuit, device=device, graphed=False)


def _layer_proof_arrays(lp: protocol.LayerProof) -> dict:
    n = lambda t: None if t is None else gf.to_numpy(t)
    return dict(p1_polys=n(lp.p1_polys), claim_u=n(lp.claim_u),
                p2_polys=n(lp.p2_polys), claims_v=n(lp.claims_v),
                liu_polys=n(lp.liu_polys), liu_claim=n(lp.liu_claim))


def _layer_proof_from(arrs: dict, device) -> protocol.LayerProof:
    t = lambda k: (None if arrs.get(k) is None
                   else gf.tensor(arrs[k], device))
    return protocol.LayerProof(
        p1_polys=t("p1_polys"), claim_u=t("claim_u"), p2_polys=t("p2_polys"),
        claims_v=t("claims_v"), liu_polys=t("liu_polys"),
        liu_claim=t("liu_claim"))


def prove(circuit: LayeredCircuit, compiled: Optional[CompiledProver] = None,
          seed: int = 3396, witness: Optional[np.ndarray] = None,
          device=None):
    """Produce a standalone proof.  Returns (FullProof, info dict)."""
    cp = _compiled(circuit, compiled, device)
    cc = cp.cc
    bl0 = cc.layers[0].bit_length
    t0 = time.time()

    inputs = input_buffer(cc, witness, cp.device)
    values = cp.evaluator(inputs)
    _check_asserts(cc, values)
    rng = GlibcRandom(seed)

    pc_state, root_l = cp.pc.commit_private(cp.pc_fns, inputs)
    ch = protocol.make_challenges(cc, rng, cp.device)
    proof = cp.prover(values, ch)
    final_point = ch.layers[1].r_liu[:, :bl0]

    fields, pc_proof_size, flags = cp.pc.open(cp.pc_fns, pc_state,
                                              final_point, rng)
    full = proof_io.FullProof(
        vres=gf.to_numpy(proof.vres),
        layers=[None] + [_layer_proof_arrays(proof.layers[i])
                         for i in range(1, cc.depth)],
        root_l=root_l,
        meta=dict(seed=seed, bl0=bl0, depth=cc.depth),
        **fields)

    info = dict(prove_time=time.time() - t0,
                gkr_proof_size=gkr_proof_size_bytes(cc),
                pc_proof_size=pc_proof_size, **flags)
    return full, info


def verify(circuit: LayeredCircuit, full: proof_io.FullProof,
           compiled: Optional[CompiledProver] = None,
           seed: int = 3396, output_values=None, device=None) -> Report:
    """Standalone verification: uses only circuit + proof + the shared
    challenge stream.  output_values: optional (2, 2^bl_last) claimed
    public-output block; when given, vres is checked against its MLE fold."""
    cp = _compiled(circuit, compiled, device)
    cc = cp.cc
    dev = cp.device
    t0 = time.time()

    pt = metrics.PhaseTimer()
    pt.start("challenges")
    rng = GlibcRandom(seed)
    ch = protocol.make_challenges(cc, rng, dev)
    proof = protocol.Proof(
        vres=gf.tensor(full.vres, dev),
        layers=[None] + [_layer_proof_from(full.layers[i], dev)
                         for i in range(1, cc.depth)])
    pt.stop("challenges")

    # the verifier never re-evaluates the circuit: vres is the claimed
    # output-MLE value, bound to the committed input by the layer walk and
    # the PC opening
    pt.start("gkr_walk")
    gkr_ok, previous_sum, final_point = cp.verifier(
        proof, ch,
        None if output_values is None else gf.tensor(output_values, dev))
    pt.stop("gkr_walk")

    pt.start("pc_opening")
    pc_ok, pc_details = cp.pc.verify_opening(cp.pc_fns, full, final_point,
                                             previous_sum, rng)
    pt.stop("pc_opening")
    vt = time.time() - t0
    slow = cp.verifier.last_split[1]
    return Report(
        ok=gkr_ok and pc_ok, gkr_ok=gkr_ok, pc_ok=pc_ok,
        input_size=cc.n_inputs,
        gkr_proof_size=gkr_proof_size_bytes(cc),
        pc_proof_size=0,
        verify_time=vt, verify_time_fast=vt - slow, verify_time_slow=slow,
        details=dict(pc_details, phases=pt.report()))


def _sync(dev):
    """What PhaseTimer.span calls at both ends of a span: the device's
    synchronize, so each span holds the device work it queued."""
    return torch.cuda.synchronize if dev.type == "cuda" else None


def prove_fs(circuit: LayeredCircuit,
             compiled: Optional[CompiledProver] = None,
             witness: Optional[np.ndarray] = None, device=None):
    """Non-interactive (Fiat-Shamir) proof.  The GKR walk and the PC half
    (public commit, fft_gkr messages, every FRI fold with its challenge and
    level root) run on the device with the sponge state there; only query
    drawing and answering run on the host, from the sponge state read once.
    Returns (FullProof with meta mode=1, info dict)."""
    cp = _compiled(circuit, compiled, device)
    cc = cp.cc
    dev = cp.device
    bl0 = cc.layers[0].bit_length
    sync = _sync(dev)
    t0 = time.time()

    pt = metrics.PhaseTimer()
    with pt.span("eval_commit", sync):
        inputs = input_buffer(cc, witness, dev)
        values = cp.evaluator(inputs)
        l_oracle, root_l_np = cp.pc.commit_private(cp.pc_fns, inputs)

    with pt.span("gkr", sync):
        if cp.fs_prover is None:
            cp.fs_prover = fs.make_fs_prover(cc, cp.plans, cp.arrs, dev,
                                             staged=FS_STAGED,
                                             graphed=cp.graphed)
            cp.fs_pc_prover = fs.make_fs_pc_prover(bl0, dev,
                                                   staged=FS_STAGED,
                                                   graphed=cp.graphed)
        proof, ch, D = cp.fs_prover(values, l_oracle.tree[:, 1])

    with pt.span("pc", sync):
        (h_oracle, all_sum, _q_coefs, fft_msgs, oracles, final_cw,
         _fold_rands, D) = cp.fs_pc_prover(l_oracle.codeword,
                                           ch.layers[1].r_liu[:, :bl0], D)

    with pt.span("queries", sync):
        sp = fs.HostSponge.from_device_state(D)
        l_host = vpd.OracleHost.of(l_oracle)
        h_host = vpd.OracleHost.of(h_oracle)
        level_hosts = [vpd.OracleHost.of(o) for o in oracles]
        pows = vpd.draw_positions(sp, bl0)
        answers, query_size = vpd.answer_queries(pows, bl0, l_host, h_host,
                                                 level_hosts)

    full = proof_io.FullProof(
        vres=gf.to_numpy(proof.vres),
        layers=[None] + [_layer_proof_arrays(proof.layers[i])
                         for i in range(1, cc.depth)],
        root_l=root_l_np,
        root_h=h_host.tree[:, 1].copy(),
        all_sum=gf.to_numpy(all_sum),
        level_roots=np.stack([h.tree[:, 1] for h in level_hosts]),
        final_codeword=gf.to_numpy(final_cw),
        fft_gkr_messages=[gf.to_numpy(m) for m in fft_msgs],
        queries=answers,
        meta=dict(mode=1, bl0=bl0, depth=cc.depth))
    fg_size = fft_gkr.fft_gkr_proof_size(bl0 - virgo_pc.LOG_SLICE)
    info = dict(prove_time=time.time() - t0,
                gkr_proof_size=gkr_proof_size_bytes(cc),
                pc_proof_size=fg_size + query_size + 2 * 32 + 16,
                fft_gkr_ok=True, phases=pt.report())
    return full, info


def verify_fs(circuit: LayeredCircuit, full: proof_io.FullProof,
              compiled: Optional[CompiledProver] = None,
              device=None) -> Report:
    """Verify a Fiat-Shamir proof: every challenge is re-derived from the
    proof's own messages on the host (no shared randomness stream)."""
    cp = _compiled(circuit, compiled, device)
    cc = cp.cc
    dev = cp.device
    bl0 = cc.layers[0].bit_length
    t0 = time.time()

    pt = metrics.PhaseTimer()
    pt.start("challenges")
    host_proof = protocol.Proof(
        vres=full.vres,
        layers=[None] + [protocol.LayerProof(**full.layers[i])
                         for i in range(1, cc.depth)])
    ch, sp = fs.derive_challenges(cc, host_proof, full.root_l, dev)
    proof = protocol.Proof(
        vres=gf.tensor(full.vres, dev),
        layers=[None] + [_layer_proof_from(full.layers[i], dev)
                         for i in range(1, cc.depth)])
    pt.stop("challenges")
    pt.start("gkr_walk")
    gkr_ok, previous_sum, final_point = cp.verifier(proof, ch, None)
    pt.stop("gkr_walk")

    pt.start("q_prepare")
    _q_values, q_coefs = cp.pc.q_prepare(cp.pc_fns, final_point)
    q_coefs = gf.to_numpy(q_coefs)
    pt.stop("q_prepare")

    pt.start("fft_replay")
    sp.absorb_digest_words(full.root_h)
    all_sum_np = np.asarray(full.all_sum)
    sp.absorb_elems([(int(all_sum_np[0, k]), int(all_sum_np[1, k]))
                     for k in range(all_sum_np.shape[1])])
    fg = fft_gkr.run(bl0 - virgo_pc.LOG_SLICE, sp,
                     replay=full.fft_gkr_messages, device=dev)
    pt.stop("fft_replay")

    pt.start("queries")
    rand_fq2 = []
    for k in range(full.level_roots.shape[0]):
        r, i = sp.squeeze()
        rand_fq2.append(Fq2.raw(r, i))
        sp.absorb_digest_words(full.level_roots[k])
    pows = vpd.draw_positions(sp, bl0)
    all_sum_fq2 = [Fq2.raw(int(all_sum_np[0, k]), int(all_sum_np[1, k]))
                   for k in range(virgo_pc.SLICES + 1)]
    lroots = [full.level_roots[k].tobytes()
              for k in range(full.level_roots.shape[0])]
    pc_ok = vpd.check_queries(
        pows, full.queries, bl0, rand_fq2, lroots, q_coefs,
        all_sum_fq2, np.asarray(full.root_l).tobytes(),
        np.asarray(full.root_h).tobytes(), full.final_codeword)
    # the surviving GKR claim must equal the committed inner product
    ps_np = gf.to_numpy(previous_sum)
    tot = Fq2.raw(0, 0)
    for x in all_sum_fq2:
        tot = tot + x
    input_check = (tot == Fq2.raw(int(ps_np[0]), int(ps_np[1])))
    pc_ok = bool(pc_ok) and fg.ok and input_check
    pt.stop("queries")
    vt = time.time() - t0
    slow = cp.verifier.last_split[1]
    return Report(
        ok=gkr_ok and pc_ok, gkr_ok=gkr_ok, pc_ok=pc_ok,
        input_size=cc.n_inputs,
        gkr_proof_size=gkr_proof_size_bytes(cc), pc_proof_size=0,
        verify_time=vt, verify_time_fast=vt - slow, verify_time_slow=slow,
        details=dict(fft_gkr_ok=fg.ok, input_check=input_check,
                     phases=pt.report()))


def prove_on_mesh(mesh, circuit: LayeredCircuit, config: ProtocolConfig):
    """One rank's part of a sharded prove (parallel/gkr_sharded for the
    glibc stream, parallel/fs_sharded for the FS sponge).  Every rank
    returns the same (FullProof, info)."""
    if config.transcript == "fs":
        from .parallel.fs_sharded import prove_fs_sharded
        return prove_fs_sharded(circuit, mesh)
    from .parallel.gkr_sharded import prove_sharded
    return prove_sharded(circuit, mesh, config.seed)


def _prove_sharded(circuit, config, device):
    """Prove over config.mesh = (dp, sp): in place when this process is a
    rank of an initialised group of dp·sp ranks (torchrun), else on dp·sp
    spawned ranks.  Returns (FullProof, info, the device to verify on)."""
    import torch.distributed as dist
    from .parallel import mesh as _mesh

    dp, sp = config.mesh
    if dist.is_available() and dist.is_initialized():
        m = _mesh.Mesh.create(dp, sp, device)
        full, info = prove_on_mesh(m, circuit, config)
        return full, info, m.device
    full, info = _mesh.spawn(prove_on_mesh, dp, sp, device,
                             args=(circuit, config))[0]
    return full, info, device


def run(pws_path: Optional[str] = None,
        circuit: Optional[LayeredCircuit] = None,
        compiled: Optional[CompiledProver] = None,
        bug_compat: bool = True, seed: int = 3396,
        config: Optional[ProtocolConfig] = None, device=None) -> Report:
    """Prove + verify in one go.  config selects the transcript ("glibc":
    the reference's stream, "fs": Fiat-Shamir), the seed, bug-compat and a
    mesh (dp, sp); explicit kwargs are ignored when a config is given.
    With sp > 1 the prove is sharded over sp ranks (``_prove_sharded``)
    and the unchanged single-device verify checks it; details["mesh"]
    names the mesh and the backend that ran."""
    if config is None:
        config = ProtocolConfig(seed=seed, bug_compat=bug_compat)
    if circuit is None:
        circuit = load_circuit(pws_path, config.bug_compat)
    sharded = config.mesh is not None and config.mesh[1] > 1
    if sharded:
        full, info, device = _prove_sharded(circuit, config, device)
    cp = _compiled(circuit, compiled, device)
    if not sharded:
        full, info = (prove_fs(circuit, cp) if config.transcript == "fs"
                      else prove(circuit, cp, config.seed))
    rep = (verify_fs(circuit, full, cp) if config.transcript == "fs"
           else verify(circuit, full, cp, config.seed))
    if sharded:
        rep.details["mesh"] = dict(shape=config.mesh, backend=info["backend"])
    rep.pc_proof_size = info["pc_proof_size"]
    rep.prove_time = info["prove_time"]
    ops = metrics.protocol_op_counts(cp.cc)
    rep.details.update(
        root_l=[int(x) for x in full.root_l],
        root_h=[int(x) for x in full.root_h],
        op_counts=(ops.mult, ops.add))
    return rep
