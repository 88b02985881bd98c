"""The sp-sharded sumcheck, and batched proving on one device or over dp.

Counterpart of ``virgo_plus_tpu/parallel/sharded.py``.

* **sp**: ``sharded_sumcheck`` runs one sumcheck whose 2^bl tables are
  sharded over the leading index bits: rank q of the sp axis holds entries
  [q·2^(bl - log S), (q+1)·2^(bl - log S)).  The fold pairs (2i, 2i+1), the
  low bit, so the first bl - log S rounds fold locally (K1 on the card);
  the partial round polys are then summed over sp, the bound scalars of the
  S ranks form a 2^log S table, and K1 folds that tail on every rank.

* **dp**: a batch of B witnesses of one circuit, proved under the same
  challenges, is a tensor axis: it runs through the single prover
  (``protocol.prove``, ``fused.prove_e2e``) with every tensor shaped
  (2, B, ...), so each sumcheck-fold, leaf-chain and Merkle-forest launch
  carries all B instances.  With a ``Mesh``, dp rank d proves the d-th
  B/dp instances and the results are gathered over dp, as the JAX
  package's ``NamedSharding(P("dp", ...))`` splits the batch.  Instances
  are independent: each one's proof equals the single prover's on its own
  witness.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from .. import fused, graphs
from ..circuits.compile import evaluate, input_buffer
from ..gkr import protocol
from ..gkr.sumcheck import scan_sumcheck_batched
from .mesh import Mesh


def sharded_fold(v, a, m, rs, mesh: Mesh, axis: str = "sp"):
    """K sumchecks at once on tables sharded over `axis`: v, a, m (2, K,
    2^(bl - log S)) this rank's blocks, rs (2, K, bl) the same on every
    rank.  Returns (polys (bl, K, 2, 3), bound (v, a, m) each (2, K)), the
    same on every rank and equal to scan_sumcheck_batched's on the whole
    tables: one local K1 call, one field sum of the partial polys, one
    gather of the bound scalars and one K1 call on the 2^log S tail."""
    s = mesh.size(axis)
    local_bl = rs.shape[2] - (s.bit_length() - 1)
    if v.shape[2] != 1 << local_bl:
        raise ValueError(f"a {v.shape[2]}-entry block is not 1/{s} of "
                         f"2^{rs.shape[2]} entries")
    polys_l, bound = scan_sumcheck_batched(v, a, m, rs[:, :, :local_bl])
    polys_l = mesh.field_sum(polys_l, axis)
    # shard order is the high bits: row q of the gather is entry q
    vt, at, mt = mesh.all_gather(torch.stack(bound), axis).permute(1, 2, 3, 0)
    polys_t, bound = scan_sumcheck_batched(vt, at, mt, rs[:, :, local_bl:])
    return torch.cat([polys_l, polys_t]), bound


def sharded_sumcheck(mesh: Mesh, axis: str = "sp"):
    """Returns fn(v, a, m, rs) -> (polys (bl, 2, 3), bound (v, a, m) each
    (2,)), the sumcheck of gkr.sumcheck.scan_sumcheck on tables sharded
    over `axis`: v, a, m are this rank's (2, 2^(bl - log S)) block, rs the
    (2, bl) challenges, the same on every rank.  Every rank returns the
    whole result."""

    def fn(v, a, m, rs):
        polys, bound = sharded_fold(v[:, None], a[:, None], m[:, None],
                                    rs[:, None], mesh, axis)
        return polys[:, 0], tuple(b[:, 0] for b in bound)

    return fn


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a virgo_plus_tpu_torch.parallel.mesh"
                        f".Mesh, not {type(mesh).__name__}")


def _inputs(cc, inputs_batch, dev, mesh):
    """A (B, 2, N) witness batch of u64 bit patterns (numpy), N at most
    2^input_bl -> the (2, b, 2^input_bl) input tensor on `dev` of this
    rank's b = B/dp instances (all B without a mesh)."""
    inputs_batch = np.asarray(inputs_batch)
    if (inputs_batch.ndim != 3 or inputs_batch.shape[1] != 2
            or inputs_batch.shape[2] > cc.layers[0].padded):
        raise ValueError(f"expected a (B, 2, N <= {cc.layers[0].padded}) "
                         f"witness batch, got shape {inputs_batch.shape}")
    if mesh is not None:
        b, rest = divmod(len(inputs_batch), mesh.dp)
        if rest:
            raise ValueError(f"a batch of {len(inputs_batch)} does not split "
                             f"over dp = {mesh.dp}")
        inputs_batch = inputs_batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
    return input_buffer(cc, inputs_batch, dev)


def _gathered(t, mesh):
    """A batch-first tensor of this rank's instances -> all B, over dp."""
    if mesh is None or t is None:
        return t
    return mesh.all_gather(t, "dp").flatten(0, 1)


def _gathered_proof(proof, mesh) -> protocol.Proof:
    if mesh is None:
        return proof
    layers = [None] + [protocol.LayerProof(**{
        k: _gathered(t, mesh) for k, t in vars(lp).items()})
        for lp in proof.layers[1:]]
    return protocol.Proof(vres=_gathered(proof.vres, mesh), layers=layers)


def make_batched_prover(cc, plans, arrs, device=None, mesh=None,
                        graphed=True):
    """GKR only.  Returns fn(inputs_batch (B, 2, N), ch) -> a
    ``protocol.Proof`` whose arrays carry the batch first (vres (B, 2),
    layers[i].p1_polys (B, bl, 2, 3), ...).  arrs: the circuit's
    ``protocol.circuit_arrays`` on the device (the mesh's, with a mesh).
    Without a mesh the prove is one graph per B (graphs.py), whose pool
    lives as long as ``fn`` or until ``graphs.release(fn)``; eager with
    graphed=False, or with a mesh, since its collectives are not
    captured."""
    _check_mesh(mesh)
    dev = mesh.device if mesh is not None else _device.resolve(device)

    def prove(inputs, ch):
        return protocol.prove(cc, plans, evaluate(cc, inputs, arrs), ch,
                              arrs)

    prove = graphs.program(prove, dev, "batched prover",
                           graphed and mesh is None)

    def fn(inputs_batch, ch):
        inputs = _inputs(cc, inputs_batch, dev, mesh)
        return _gathered_proof(prove(inputs, ch), mesh)

    fn.graphs = (prove,)
    return fn


def make_batched_full_prover(cc, plans, device=None, mesh=None,
                             graphed=True):
    """Batched FULL proving: GKR plus the whole polynomial commitment
    (private commit, public commit, every LDT fold and every oracle hash)
    of a witness batch, as ``fused.prove_e2e`` on (2, B, N) inputs.

    Returns run(inputs_batch (B, 2, N), ch, final_point, fold_rands) ->
    (proofs, root_l (B, 4), root_h (B, 4), all_sum (B, 2, 65),
    level_roots (B, L, 4), final_codewords (B, 2, 65, 2^RATE)), all int64
    tensors of u64 bit patterns on the device; ``proofs`` as
    ``make_batched_prover``'s.  ch, final_point and fold_rands are shared
    by the batch and must be on the device.  Without a mesh the prove is
    one graph per B (graphs.py), whose pool lives as long as ``run`` or
    until ``graphs.release(run)``; eager with graphed=False.  With a mesh,
    every rank runs it eagerly and returns all B instances."""
    _check_mesh(mesh)
    dev = mesh.device if mesh is not None else _device.resolve(device)
    arrs = protocol.circuit_arrays(cc, plans, dev)

    def root(oracle):
        return oracle.tree[..., 1].movedim(0, -1)       # (4, B) -> (B, 4)

    def prove(inputs, ch, final_point, fold_rands):
        proofs, l_oracle, h_oracle, all_sum, _q, ldt = fused.prove_e2e(
            cc, plans, inputs, ch, list(fold_rands), arrs,
            final_point=final_point)
        level_roots = torch.stack([root(o) for o in ldt.oracles], dim=1)
        return (proofs, root(l_oracle), root(h_oracle),
                all_sum.movedim(0, 1), level_roots,
                ldt.final_codeword.movedim(0, 1))

    prove = graphs.program(prove, dev, "batched full prover",
                           graphed and mesh is None)

    def run(inputs_batch, ch, final_point, fold_rands):
        inputs = _inputs(cc, inputs_batch, dev, mesh)
        proofs, *arrays = prove(inputs, ch, final_point, tuple(fold_rands))
        return (_gathered_proof(proofs, mesh),) + tuple(
            _gathered(t, mesh) for t in arrays)

    run.graphs = (prove,)
    return run
