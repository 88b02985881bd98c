"""The device-only end-to-end prove: the composition the benchmark times.

Counterpart of ``virgo_plus_tpu/fused.py``.  The challenge schedule does
not depend on the messages (the reference draws from a fixed srand(3396)
stream), so the whole prover is a feed-forward computation: circuit
evaluation, every GKR sumcheck, the input-codeword commit, the public
commit, every FRI fold level, and the hashing of all oracles.  The fft_gkr
message tape (``fg_tape``) is the other half of the timed prove, matching
the reference's accounting whose prove time includes the fft_gkr prover
(fft_circuit_GKR.cpp:18-19, verifier.cpp:183).
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from . import device as _device
from . import graphs
from .circuits.compile import CompiledCircuit, evaluate
from .gkr import protocol
from .pc import fft_gkr, virgo_pc


def prove_e2e(cc: CompiledCircuit, plans, inputs, ch, fold_rands, arrs,
              timer=None, final_point=None):
    """Full prove on the device of ``inputs``.  fold_rands: list of (2,)
    fold challenges; final_point: the PC's evaluation point, by default
    the input-layer point of ``ch``.  All codewords (l, h, every LDT
    level) are computed first, then every leaf chain and Merkle tree
    hashes as one batch.  timer: optional metrics.PhaseTimer; each phase
    is then timed between device synchronisations (off by default: no
    synchronisation at all).

    inputs (2, N) proves one witness.  A batch (2, B, N) of witnesses,
    under the same challenges, runs through the same calls with every
    tensor carrying the batch after its plane axis (the proof's arrays
    carry it first: ``protocol.prove``), so each kernel launches as often
    as for one witness.

    Returns (proof, l_oracle, h_oracle, all_sum, q_coefs, ldt)."""
    bl0 = cc.layers[0].bit_length
    sync = torch.cuda.synchronize if inputs.is_cuda else None
    span = ((lambda name: nullcontext()) if timer is None
            else (lambda name: timer.span(name, sync)))
    with span("evaluate"):
        values = evaluate(cc, inputs, arrs)
    with span("gkr_prove"):
        proof = protocol.prove(cc, plans, values, ch, arrs)
    with span("commit_encode"):
        l_eval, _l_coefs = virgo_pc._slice_encode(inputs, bl0)
    with span("public_commit"):
        if final_point is None:
            final_point = ch.layers[1].r_liu[:, :bl0]
        q_values, q_coefs = virgo_pc.q_tables(final_point, bl0)
        h_full, _q_eval, _q_coefs2, all_sum, vo = \
            virgo_pc.commit_public_eval(l_eval, q_values, bl0)
    with span("fri_folds"):
        cws = virgo_pc.fold_codewords(vo, bl0, list(fold_rands))
    with span("hash_oracles"):
        oracles = virgo_pc.make_oracles_batched([l_eval, h_full] + cws)
    ldt = virgo_pc.LDTCommitment(oracles=oracles[2:],
                                 randomness=list(fold_rands),
                                 final_codeword=cws[-1])
    return proof, oracles[0], oracles[1], all_sum, q_coefs, ldt


def fg_tape(n_folds: int, schedule: dict, device):
    """The fft_gkr prover-message tape (pc/fft_gkr.prove_messages) for a
    draw_schedule dict."""
    return fft_gkr.prove_messages(n_folds, schedule, device)


def make_fg_tape(n_folds: int, device=None):
    """Returns tape(schedule) -> fg_tape's message list, one graph per
    shape (graphs.py).  The schedule's numpy draws go into the graph's
    static device buffers in the copy-in, so prove_messages sees
    tensors."""
    dev = _device.resolve(device)
    return graphs.Graphed(lambda d: fft_gkr.prove_messages(n_folds, d, dev),
                          dev, "fg_tape")


def make_e2e_prover(cc: CompiledCircuit, plans, device=None):
    """Returns run(inputs, ch, fold_rands) -> the same tuple as prove_e2e,
    as one graph of the whole prove (graphs.py) with the circuit's tables
    made here.  fold_rands: bl0 - LOG_SLICE (2,) challenges.  No timer:
    its spans synchronise the device."""
    dev = _device.resolve(device)
    arrs = protocol.circuit_arrays(cc, plans, dev)
    prove = graphs.Graphed(
        lambda inputs, ch, fold_rands: prove_e2e(cc, plans, inputs, ch,
                                                 list(fold_rands), arrs),
        dev, "e2e_prover")

    def run(inputs, ch, fold_rands):
        return prove(inputs, ch, tuple(fold_rands))

    run.graphs = (prove,)
    return run
