"""JAX references of test_torch_tape_oracle.py, each run in a spawned
process: the inputs from numpy with a seed, JAX ``build_circuit`` and
``commit_public_eval``.  This module imports numpy and the JAX package but
not torch, so a reference process starts quickly."""

import numpy as np

M = (1 << 61) - 1
BATCH = 3


def canon(rng, *shape):
    return rng.integers(0, M, size=(2,) + shape, dtype=np.uint64)


def build_inputs(lg):
    """r (2, lg) and the 64 evaluation points (2, 64)."""
    rng = np.random.default_rng(100 + lg)
    return canon(rng, lg), canon(rng, 64)


def oracle_inputs(bl):
    """A batch of l codewords (2, BATCH, 65, 2^(bl-1)) with a zero mask
    slice and q_values (2, 2^bl)."""
    rng = np.random.default_rng(200 + bl)
    l_eval = canon(rng, BATCH, 65, 1 << (bl - 1))
    l_eval[:, :, 64] = 0
    return l_eval, canon(rng, 1 << bl)


def jax_jobs(jobs):
    """For each ("build", lgs) job {("build", lg): JAX build_circuit's
    layers} and for each ("oracle", bl) {("oracle", bl): JAX
    commit_public_eval of each instance}, in one dict; numpy leaves."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from virgo_plus_tpu.pc import fft_gkr, virgo_pc

    out = {}
    for kind, arg in jobs:
        if kind == "build":
            for lg in arg:
                r, ep = build_inputs(lg)
                out[("build", lg)] = jax.jit(
                    lambda r, ep, lg=lg: fft_gkr.build_circuit(lg, r, ep))(
                        r, ep)
        else:
            l_eval, q = oracle_inputs(arg)
            fn = jax.jit(lambda l, q: virgo_pc.commit_public_eval(l, q, arg))
            out[("oracle", arg)] = [fn(l_eval[:, b], q)
                                    for b in range(BATCH)]
    return jax.tree_util.tree_map(np.asarray, out)
