"""K1's plain twin == the TPU kernel it replaces, bit for bit.

The Pallas sumcheck fold (virgo_plus_tpu/pallas_kernels/sumcheck_fold.py)
runs in interpret mode on the CPU, as the JAX package's own tests run it;
the port's plain fold must give the same round polynomials and bound
values, and so must the JAX masked-scan fold.  Inputs from numpy with a
seed; tolerance 0.  Kept in its own file: interpret mode takes minutes."""

import numpy as np
import pytest
import jax.numpy as jnp

from virgo_plus_tpu.gkr.sumcheck import scan_sumcheck_batched
from virgo_plus_tpu.pallas_kernels.sumcheck_fold import (
    scan_sumcheck_batched_pallas)
from virgo_plus_tpu_torch.field import gf
from virgo_plus_tpu_torch.gkr import sumcheck

import torch_shared  # noqa: F401  (one torch thread)

M = gf.MOD


@pytest.mark.parametrize("bl,k", [(7, 3), (9, 2)])
def test_fold_matches_pallas_interpret(bl, k):
    rng = np.random.default_rng(100 + bl)
    n = 1 << bl
    v, a, m = (rng.integers(0, M, size=(2, k, n), dtype=np.uint64)
               for _ in range(3))
    rs = rng.integers(0, M, size=(2, k, bl), dtype=np.uint64)
    polys, bound = sumcheck.scan_sumcheck_batched(
        *(gf.tensor(x) for x in (v, a, m, rs)))
    got = [gf.to_numpy(polys)] + [gf.to_numpy(b) for b in bound]
    jv = [jnp.asarray(x) for x in (v, a, m, rs)]
    for ref in (scan_sumcheck_batched(*jv),
                scan_sumcheck_batched_pallas(*jv, interpret=True)):
        want = [np.asarray(ref[0])] + [np.asarray(b) for b in ref[1]]
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
