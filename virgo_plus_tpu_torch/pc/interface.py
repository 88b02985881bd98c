"""The polynomial-commitment seam.

Counterpart of ``virgo_plus_tpu/pc/interface.py``.  ``driver`` talks to the
PC only through this interface, and ``VirgoPC`` (virgo_pc + vpd + fft_gkr)
is the one implementation.  The call order follows the reference
(src/verifier.cpp:137, 363-390):

1. ``commit_private`` before any challenge is drawn;
2. ``open`` after the GKR walk reduces to one input-MLE claim at
   ``final_point``: public commit, fft_gkr delegation, LDT folds, query
   answers, consuming the shared challenge stream in that order;
3. ``verify_opening`` checks those fields against the commitment root and
   the surviving claim.

``PolynomialCommitment`` is that seam as an abstract class, as in the JAX
package, so that a second commitment could plug in.
"""

from __future__ import annotations

import abc
from typing import Tuple

import numpy as np

from .. import graphs
from ..field import gf
from ..field.ref import Fq2
from . import fft_gkr, virgo_pc, vpd


class PolynomialCommitment(abc.ABC):
    """Commit/open/verify seam consumed by driver.py."""

    name: str = "abstract"

    @abc.abstractmethod
    def compile(self, bl0: int, device, graphed: bool = True):
        """Per-input-size programs on `device` (opaque to the driver)."""

    @abc.abstractmethod
    def commit_private(self, fns, inputs) -> Tuple[object, np.ndarray]:
        """Commit the witness; returns (prover state, root digest words)."""

    @abc.abstractmethod
    def open(self, fns, state, final_point, rng) -> Tuple[dict, int, dict]:
        """Produce the opening proof for the MLE claim at final_point.
        Returns (FullProof PC fields, pc proof size in bytes, flags)."""

    @abc.abstractmethod
    def verify_opening(self, fns, full, final_point, previous_sum,
                       rng) -> Tuple[bool, dict]:
        """Check an opening against the committed root and the claim
        value previous_sum.  Returns (ok, detail flags)."""


class VirgoPC(PolynomialCommitment):
    """The Virgo VPD + aggregated-FRI commitment (eprint 2019/1482)."""

    name = "virgo"

    def compile(self, bl0: int, device, graphed: bool = True):
        """The per-input-size programs, each a graph per argument shape
        (graphs.py), as the JAX package's four jits: ``commit``
        (private commit), ``commit_pub`` (public commit), ``folds`` (every
        LDT fold and its oracles) and ``q_prepare``; eager functions for
        graphed=False.  fft_gkr.run, the challenge draws and the query
        answers stay host-driven."""
        return dict(
            bl0=bl0, device=device,
            commit=graphs.program(
                lambda v: virgo_pc.commit_private(v, bl0), device,
                "pc commit", graphed),
            commit_pub=graphs.program(
                lambda l_eval, q: virgo_pc.commit_public(l_eval, q, bl0),
                device, "pc commit_pub", graphed),
            folds=graphs.program(
                lambda vo, rands: virgo_pc.commit_phase(vo, bl0, list(rands)),
                device, "pc folds", graphed),
            q_prepare=graphs.program(
                lambda fp: virgo_pc.q_tables(fp, bl0), device,
                "pc q_prepare", graphed))

    @staticmethod
    def q_prepare(fns, final_point):
        """Verifier-side q: beta table at the final point and its per-slice
        IFFT coefficients (verifier.cpp:348-361)."""
        return fns["q_prepare"](final_point)

    def commit_private(self, fns, inputs):
        l_oracle, _ = fns["commit"](inputs)
        return l_oracle, gf.to_numpy(l_oracle.tree[:, 1])

    def open(self, fns, l_oracle, final_point, rng):
        bl0, dev = fns["bl0"], fns["device"]
        q_values, _ = self.q_prepare(fns, final_point)
        h_oracle, _q_eval, _q_coefs, all_sum, vo = fns["commit_pub"](
            l_oracle.codeword, q_values)

        n_folds = bl0 - virgo_pc.LOG_SLICE
        fg = fft_gkr.run(n_folds, rng, device=dev)

        randomness = []
        for _ in range(n_folds):
            r, i = rng.field_element()
            randomness.append(gf.from_u64(np.uint64(r), np.uint64(i),
                                          dev).reshape(2))
        ldt = fns["folds"](vo, randomness)

        l_host = vpd.OracleHost.of(l_oracle)
        h_host = vpd.OracleHost.of(h_oracle)
        level_hosts = [vpd.OracleHost.of(o) for o in ldt.oracles]
        pows = vpd.draw_positions(rng, bl0)
        answers, query_size = vpd.answer_queries(pows, bl0, l_host, h_host,
                                                 level_hosts)
        fields = dict(
            root_h=h_host.tree[:, 1].copy(),
            all_sum=gf.to_numpy(all_sum),
            level_roots=np.stack([h.tree[:, 1] for h in level_hosts]),
            final_codeword=gf.to_numpy(ldt.final_codeword),
            fft_gkr_messages=fg.messages,
            queries=answers)
        pc_proof_size = fg.proof_size + query_size + 2 * 32 + 16
        return fields, pc_proof_size, dict(fft_gkr_ok=fg.ok)

    def verify_opening(self, fns, full, final_point, previous_sum, rng):
        bl0 = fns["bl0"]
        _q_values, q_coefs = self.q_prepare(fns, final_point)

        n_folds = bl0 - virgo_pc.LOG_SLICE
        fg = fft_gkr.run(n_folds, rng, replay=full.fft_gkr_messages,
                         device=fns["device"])

        rand_fq2 = []
        for _ in range(n_folds):
            r, i = rng.field_element()
            rand_fq2.append(Fq2.raw(r, i))

        pows = vpd.draw_positions(rng, bl0)
        all_sum_np = np.asarray(full.all_sum)
        all_sum_fq2 = [Fq2.raw(int(all_sum_np[0, k]), int(all_sum_np[1, k]))
                       for k in range(virgo_pc.SLICES + 1)]
        lroots = [full.level_roots[k].tobytes()
                  for k in range(full.level_roots.shape[0])]
        pc_ok = vpd.check_queries(
            pows, full.queries, bl0, rand_fq2, lroots, gf.to_numpy(q_coefs),
            all_sum_fq2, np.asarray(full.root_l).tobytes(),
            np.asarray(full.root_h).tobytes(), full.final_codeword)

        # claimed inner product == GKR's surviving input claim; additionally
        # bind sum(all_sum) to it (the JAX package's soundness fix)
        ps_np = gf.to_numpy(previous_sum)
        ps = Fq2.raw(int(ps_np[0]), int(ps_np[1]))
        tot = Fq2.raw(0, 0)
        for x in all_sum_fq2:
            tot = tot + x
        input_check = (tot == ps)
        ok = bool(pc_ok) and fg.ok and input_check
        return ok, dict(fft_gkr_ok=fg.ok, input_check=input_check)


DEFAULT_PC = VirgoPC()
