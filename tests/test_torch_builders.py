"""The port's circuit builders == the JAX package's, field by field, and a
builder circuit proves and verifies through the port's driver on the CPU;
a nonzero assert gate makes the prover refuse."""

import numpy as np
import pytest

from virgo_plus_tpu.circuits import builders as jbuilders

from virgo_plus_tpu_torch import driver
from virgo_plus_tpu_torch.circuits.builders import (CircuitBuilder,
                                                    matmul_circuit)
from virgo_plus_tpu_torch.circuits.compile import (compile_circuit,
                                                   eval_arrays, evaluate,
                                                   input_buffer)
from virgo_plus_tpu_torch.field import gf

from test_torch_native import _same
import torch_shared  # noqa: F401  (one torch thread)

MOD = (1 << 61) - 1


def _gadget(cls, n=8):
    """A circuit using every builder call on n inputs, from either
    package's class."""
    cb = cls()
    xs = [cb.input(3 + 2 * v) for v in range(n)]
    y = cb.sum([cb.mul(xs[i], xs[(i + 1) % n]) for i in range(n)])
    z = cb.addc(cb.mulc(y, 12345), 678)
    cb.not_(cb.xor(cb.naab(xs[0], xs[1]), xs[2]))
    cb.add(cb.sub(z, xs[3]), cb.copy(xs[4]))
    return cb


def _asserting(ok: bool):
    cb = CircuitBuilder()
    xs = [cb.input(v) for v in range(2, 130)]  # 128 inputs
    y = cb.sum([cb.mul(xs[i], xs[i + 1]) for i in range(0, 128, 2)])
    d = cb.sub(y, y) if ok else cb.sub(y, xs[0])
    cb.assert_zero(d)
    cb.add(y, d)
    return cb.build()


@pytest.mark.parametrize("bug_compat", [False, True])
def test_builder_matches_jax(bug_compat):
    _same(_gadget(CircuitBuilder).build(bug_compat=bug_compat),
          _gadget(jbuilders.CircuitBuilder).build(bug_compat=bug_compat))


def test_matmul_circuit_matches_jax():
    _same(matmul_circuit(4), jbuilders.matmul_circuit(4))


def test_matmul_circuit_evaluates_correctly():
    k = 4
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 20, (k, k))
    b = rng.integers(0, 1 << 20, (k, k))
    cc = compile_circuit(matmul_circuit(k, a, b))
    values = evaluate(cc, input_buffer(cc, None, "cpu"),
                      eval_arrays(cc, "cpu"))
    out = gf.to_numpy(values[0, int(cc.value_off[cc.depth - 1]):])
    outs = set(int(x) for x in out[:cc.layers[cc.depth - 1].size])
    expect = (a.astype(object) @ b.astype(object)) % MOD
    assert all(int(expect[i, j]) in outs for i in range(k) for j in range(k))


def test_builder_circuit_proves_and_verifies():
    c = _gadget(CircuitBuilder, 128).build()   # the PC needs 2^7 inputs
    cp = driver.compile_prover(c, device="cpu")
    full, _ = driver.prove(c, cp)
    assert driver.verify(c, full, cp).ok


def test_assert_gates():
    c_ok = _asserting(True)
    cp = driver.compile_prover(c_ok, device="cpu")
    full, _ = driver.prove(c_ok, cp)
    assert driver.verify(c_ok, full, cp).ok
    c_bad = _asserting(False)
    with pytest.raises(ValueError, match="assert gate failed"):
        driver.prove(c_bad, driver.compile_prover(c_bad, device="cpu"))
