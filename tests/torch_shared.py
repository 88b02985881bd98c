"""What the port's test processes share: one torch intra-op thread, and
expensive reference results made once per pytest session.

The tier-1 command (ROADMAP.md) runs six pytest workers, and several port
tests start processes of their own (JAX references, mesh ranks, the CLI).
torch's default of one intra-op thread a core makes every process spin on
every core: on an 8-core CPU host, six small1200 proves side by side took
220 s each with the default threads and 2.7-3.2 s each with one thread
(one alone: 4.6 s with the default threads).  The field arithmetic is integer and exact, so the thread count
changes no result.  Each ``tests/test_torch_*.py`` imports this module;
spawned processes that run port code import it too, and a test that
starts the CLI in a subprocess passes ``THREAD_ENV``.

``shared`` keeps a result that several files compute identically (a JAX
reference proof) for the whole session, across xdist workers."""

import fcntl
import os

import numpy as np
import torch

torch.set_num_threads(1)

# the environment of a subprocess that runs the port (torch reads it at
# start)
THREAD_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _shared_dir(tmp_path_factory):
    """The directory every process of this pytest session sees: with xdist
    the parent of the worker's base temporary directory, else the base."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def shared(tmp_path_factory, key, make):
    """make() -> {name: numpy array}, made once per session whichever test
    process asks first (under a lock: the others wait, then load it) and
    stored as .npz in the session's shared directory.  `key` names the
    function, circuit, seed and form, so that only identical calls
    share."""
    root = _shared_dir(tmp_path_factory)
    path = root / f"shared-{key}.npz"
    with open(root / f"shared-{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = root / f"shared-{key}.{os.getpid()}.npz"
            np.savez(tmp, **make())
            os.replace(tmp, path)
        with np.load(path) as d:
            return {k: d[k] for k in d.files}


# the fields of a JAX FS LayerProof and LayerChallenges
FS_LAYER_FIELDS = ("p1_polys", "claim_u", "p2_polys", "claims_v",
                   "liu_polys", "liu_claim")
FS_CHALLENGE_FIELDS = ("r_u", "assert_r", "r_v", "sig", "r_liu")


def jax_fs_reference(tmp_path_factory):
    """The JAX package's ``make_fs_prover`` on ``randomize(4, 3, seed=3)``
    with the commitment root (7, 8, 9, 10), once a session: the circuit's
    values, the root, vres, r_out, the final state D and every proof and
    challenge array of layer i as "L{i}.<field>" and "C{i}.<field>" (a
    None field left out).  tests/test_torch_fs_prove.py and
    test_torch_fs_fused.py hold the port against it."""
    def make():
        import jax.numpy as jnp
        from virgo_plus_tpu.circuits.compile import (compile_circuit,
                                                     input_buffer)
        from virgo_plus_tpu.gkr import fs as jfs
        from virgo_plus_tpu.gkr import protocol as jprotocol
        from virgo_plus_tpu_torch.circuits.layered import (randomize,
                                                           subset_init)
        c = randomize(4, 3, seed=3)
        subset_init(c)
        jcc = compile_circuit(c)
        values = jprotocol.make_evaluator(jcc)(input_buffer(jcc))
        root_l = np.arange(4, dtype=np.uint64) + 7
        proof, ch, D = jfs.make_fs_prover(jcc, jprotocol.build_plans(jcc))(
            values, jnp.asarray(root_l))
        out = dict(values=np.asarray(values), root_l=root_l,
                   vres=np.asarray(proof.vres), r_out=np.asarray(ch.r_out),
                   D=np.asarray(D))
        for i in range(1, jcc.depth):
            for tag, obj, fields in (("L", proof.layers[i], FS_LAYER_FIELDS),
                                     ("C", ch.layers[i],
                                      FS_CHALLENGE_FIELDS)):
                for k in fields:
                    if getattr(obj, k) is not None:
                        out[f"{tag}{i}.{k}"] = np.asarray(getattr(obj, k))
        return out
    return shared(tmp_path_factory, "jax-fs-prover-randomize-4-3-3-root-7",
                  make)
