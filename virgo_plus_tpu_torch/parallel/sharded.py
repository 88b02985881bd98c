"""Batched proving on one device: the data-parallel axis as a batch axis.

Counterpart of ``virgo_plus_tpu/parallel/sharded.py:85-166``.  The JAX
package vmaps one instance's prover over a witness batch and shards the
batch over a mesh's ``dp`` axis.  Here the batch is a tensor axis: a batch
of B witnesses of one circuit, proved under the same challenges, runs
through the single prover (``protocol.prove``, ``fused.prove_e2e``) with
every tensor shaped (2, B, ...), so each sumcheck-fold, leaf-chain and
Merkle-forest launch carries all B instances and the launch count does
not grow with B.  Instances are independent: each one's proof equals the
single prover's on its own witness.

No mesh: a ``mesh`` argument raises.  The sharded sumcheck
(``sharded_sumcheck``) needs ``torch.distributed`` and belongs to the
sharded provers, which are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .. import fused
from ..circuits.compile import evaluate, input_buffer
from ..gkr import protocol


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the PyTorch port proves a batch on one device; sharded proving "
            "over a mesh is not ported yet")


def _inputs(cc, inputs_batch, dev):
    """A (B, 2, N) witness batch of u64 bit patterns (numpy), N at most
    2^input_bl -> the (2, B, 2^input_bl) input tensor on `dev`."""
    inputs_batch = np.asarray(inputs_batch)
    if (inputs_batch.ndim != 3 or inputs_batch.shape[1] != 2
            or inputs_batch.shape[2] > cc.layers[0].padded):
        raise ValueError(f"expected a (B, 2, N <= {cc.layers[0].padded}) "
                         f"witness batch, got shape {inputs_batch.shape}")
    return input_buffer(cc, inputs_batch, dev)


def make_batched_prover(cc, plans, arrs, device=None, mesh=None):
    """GKR only.  Returns fn(inputs_batch (B, 2, N), ch) -> a
    ``protocol.Proof`` whose arrays carry the batch first (vres (B, 2),
    layers[i].p1_polys (B, bl, 2, 3), ...).  arrs: the circuit's
    ``protocol.circuit_arrays`` on `device`."""
    _no_mesh(mesh)
    dev = _device.resolve(device)

    def fn(inputs_batch, ch):
        inputs = _inputs(cc, inputs_batch, dev)
        return protocol.prove(cc, plans, evaluate(cc, inputs, arrs), ch,
                              arrs)

    return fn


def make_batched_full_prover(cc, plans, device=None, mesh=None):
    """Batched FULL proving: GKR plus the whole polynomial commitment
    (private commit, public commit, every LDT fold and every oracle hash)
    of a witness batch, as ``fused.prove_e2e`` on (2, B, N) inputs.

    Returns run(inputs_batch (B, 2, N), ch, final_point, fold_rands) ->
    (proofs, root_l (B, 4), root_h (B, 4), all_sum (B, 2, 65),
    level_roots (B, L, 4), final_codewords (B, 2, 65, 2^RATE)), all int64
    tensors of u64 bit patterns on the device; ``proofs`` as
    ``make_batched_prover``'s.  ch, final_point and fold_rands are shared
    by the batch and must be on the device."""
    _no_mesh(mesh)
    dev = _device.resolve(device)
    arrs = protocol.circuit_arrays(cc, plans, dev)

    def root(oracle):
        return oracle.tree[..., 1].movedim(0, -1)       # (4, B) -> (B, 4)

    def run(inputs_batch, ch, final_point, fold_rands):
        inputs = _inputs(cc, inputs_batch, dev)
        proofs, l_oracle, h_oracle, all_sum, _q, ldt = fused.prove_e2e(
            cc, plans, inputs, ch, list(fold_rands), arrs,
            final_point=final_point)
        level_roots = torch.stack([root(o) for o in ldt.oracles], dim=1)
        return (proofs, root(l_oracle), root(h_oracle),
                all_sum.movedim(0, 1), level_roots,
                ldt.final_codeword.movedim(0, 1))

    return run
