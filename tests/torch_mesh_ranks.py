"""Rank-side entries of the sharded-prover tests (test_torch_sharded_*.py).

Each function runs on one rank of a mesh that ``parallel.mesh.spawn``
started, on the CPU over gloo, and returns numpy results to the test
process.  This module imports only the port, numpy and torch, so the ranks
never import JAX."""

import numpy as np

from virgo_plus_tpu_torch import convert, driver
from virgo_plus_tpu_torch.circuits.compile import (compile_circuit,
                                                   eval_arrays, evaluate,
                                                   input_buffer)
from virgo_plus_tpu_torch.config import ProtocolConfig
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.parallel import pc_sharded
from virgo_plus_tpu_torch.parallel.fs_sharded import (make_fs_sharded_prover,
                                                      prove_fs_sharded)
from virgo_plus_tpu_torch.parallel.gkr_sharded import (make_sharded_prover,
                                                       prove_sharded)
from virgo_plus_tpu_torch.parallel.sharded import (make_batched_full_prover,
                                                   make_batched_prover,
                                                   sharded_sumcheck)
from virgo_plus_tpu_torch.parallel.sharded_queries import \
    answer_queries_sharded
from virgo_plus_tpu_torch.pc import fft_gkr, virgo_pc
from virgo_plus_tpu_torch.utils.glibc_rand import GlibcRandom

import torch_shared  # noqa: F401  (one torch thread)


def _np(t):
    return None if t is None else gf.to_numpy(t)


def _values(cc, dev):
    return evaluate(cc, input_buffer(cc, None, dev), eval_arrays(cc, dev))


def _block(x, mesh):
    """Rank q's contiguous 1/S of the last axis of a numpy table."""
    n = x.shape[-1] // mesh.sp
    return gf.tensor(x[..., mesh.sp_rank * n:(mesh.sp_rank + 1) * n],
                     mesh.device)


def gkr(mesh, circuit, gkr_circuit, tables=None, in_place=False):
    """sharded_sumcheck on `tables` (v, a, m (2, 2^bl), rs (2, bl)),
    make_sharded_prover on `gkr_circuit` under the seed-3396 challenges,
    prove_sharded of `circuit`, and (in_place) driver.run inside this
    group."""
    dev = mesh.device
    out = {}
    if tables is not None:
        v, a, m, rs = tables
        polys, bound = sharded_sumcheck(mesh)(
            _block(v, mesh), _block(a, mesh), _block(m, mesh),
            gf.tensor(rs, dev))
        out["sumcheck"] = (_np(polys), [_np(b) for b in bound])
    cc = compile_circuit(gkr_circuit)
    plans = protocol.build_plans(cc)
    ch = protocol.make_challenges(cc, GlibcRandom(3396), dev)
    out["gkr"] = convert.proof_to_numpy(
        make_sharded_prover(cc, plans, mesh)(_values(cc, dev), ch))
    out["full"], out["info"] = prove_sharded(circuit, mesh)
    if in_place:
        rep = driver.run(circuit=circuit, device=dev,
                         config=ProtocolConfig(mesh=(mesh.dp, mesh.sp)))
        out["run"] = (rep.ok, rep.details["mesh"])
    return out


def pc(mesh, bl, values, q_values, rands, pows, tiny_cw, tiny_pows):
    """sharded_pc_prove on (values, q_values, rands) with its codewords
    gathered shard-major, answer_queries_sharded at `pows`, and the query
    answers of one tiny tree (the codeword tiny_cw, natural order)."""
    dev = mesh.device
    T = lambda x: gf.tensor(x, dev)
    out = pc_sharded.sharded_pc_prove(mesh, bl)(
        T(values), T(q_values), [T(r) for r in rands])
    strided = lambda o: _np(pc_sharded.gather_strided(o.cw, mesh))
    res = dict(root_l=_np(out["l"].root), root_h=_np(out["h"].root),
               all_sum=_np(out["all_sum"]),
               level_roots=[_np(o.root) for o in out["levels"]],
               l_codeword=strided(out["l"]), h_codeword=strided(out["h"]),
               level_codewords=[strided(o) for o in out["levels"]],
               tiny_levels=[o.tiny for o in out["levels"]])
    res["answers"] = answer_queries_sharded(pows, bl, out["l"], out["h"],
                                            out["levels"], mesh)
    tiny = pc_sharded.sharded_oracle_tree(
        T(tiny_cw[:, :, mesh.sp_rank::mesh.sp]), mesh)
    res["tiny"] = (tiny.tiny, _np(tiny.root), answer_queries_sharded(
        tiny_pows, bl, tiny, tiny, [], mesh)[0])
    return res


def batched(mesh, circuit, xs):
    return batched_outputs(circuit, xs, mesh, mesh.device)


def batched_outputs(circuit, xs, mesh, dev):
    """make_batched_full_prover and make_batched_prover on the witness
    batch xs under the seed-3396 glibc draws, as numpy."""
    cc = compile_circuit(circuit)
    plans = protocol.build_plans(cc)
    bl0 = cc.layers[0].bit_length
    n_folds = bl0 - virgo_pc.LOG_SLICE
    rng = GlibcRandom(3396)
    ch = protocol.make_challenges(cc, rng, dev)
    fft_gkr.draw_schedule(n_folds, rng)
    rands = [gf.from_u64(np.uint64(r), np.uint64(i), dev).reshape(2)
             for r, i in [rng.field_element() for _ in range(n_folds)]]
    proofs, *arrays = make_batched_full_prover(cc, plans, dev, mesh)(
        xs, ch, ch.layers[1].r_liu[:, :bl0], rands)
    gkr_only = make_batched_prover(cc, plans, protocol.circuit_arrays(
        cc, plans, dev), dev, mesh)(xs, ch)
    return ([_np(a) for a in arrays], convert.proof_to_numpy(proofs),
            convert.proof_to_numpy(gkr_only))


def fails(mesh):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    mesh.all_sum(gf.zeros((1,)))


def fs(mesh, circuit, gkr_circuit, root_l):
    """make_fs_sharded_prover on `gkr_circuit` seeded by root_l, and
    prove_fs_sharded of `circuit` (when given)."""
    dev = mesh.device
    cc = compile_circuit(gkr_circuit)
    proof, ch, D = make_fs_sharded_prover(cc, protocol.build_plans(cc), mesh)(
        _values(cc, dev), gf.tensor(root_l, dev))
    layers = [None] + [{k: _np(v) for k, v in vars(lc).items()}
                       for lc in ch.layers[1:]]
    out = dict(gkr=convert.proof_to_numpy(proof), r_out=_np(ch.r_out),
               ch_layers=layers, D=_np(D))
    if circuit is not None:
        out["full"], out["info"] = prove_fs_sharded(circuit, mesh)
    return out
