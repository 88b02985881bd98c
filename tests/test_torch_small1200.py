"""On the committed fixture circuit small1200, every field of the port's
proof equals the JAX package's ``driver.prove`` output (same glibc seed,
CPU, tolerance 0).  Kept in its own file: the JAX prove compiles for about
a minute on the CPU."""

import numpy as np

from virgo_plus_tpu import driver as jdriver
from virgo_plus_tpu_torch import driver

from test_reference_parity import FIXTURE
from test_torch_prove import _equal_proofs
import torch_shared  # noqa: F401  (one torch thread)


def test_small1200_proof_matches_jax():
    c = driver.load_circuit(FIXTURE)
    full, info = driver.prove(c, device="cpu")
    jc = jdriver.load_circuit(FIXTURE)
    jfull, jinfo = jdriver.prove(jc)
    assert _equal_proofs(full, jfull)
    assert info["pc_proof_size"] == jinfo["pc_proof_size"]
    assert np.array_equal(full.root_l, jfull.root_l)
