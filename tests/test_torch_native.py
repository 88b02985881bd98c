"""The port's native C++ frontend == the port's Python frontend == the JAX
package's native frontend, structure for structure.

The port builds its own copy of ``frontend.cpp`` under ``build/native/``;
``driver.load_circuit`` routes through it and falls back to the Python
frontend only when no C++ compiler is found.  Runs on the CPU."""

from pathlib import Path

import numpy as np
import pytest

from virgo_plus_tpu import native as jnative

from virgo_plus_tpu_torch import driver, native
from virgo_plus_tpu_torch.circuits.layered import dag_to_layered, subset_init
from virgo_plus_tpu_torch.circuits.pws import parse_pws

from test_native import PWS
import torch_shared  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
SMALL1200 = ROOT / "tests" / "data" / "small1200.pws"


def _python(path, bug_compat):
    c = dag_to_layered(parse_pws(str(path)), bug_compat=bug_compat)
    subset_init(c)
    return c


def _same(a, b):
    """Every field of two LayeredCircuits equal, layer by layer."""
    assert a.size == b.size
    assert np.array_equal(a.input_values, b.input_values)
    for i, (x, y) in enumerate(zip(a.layers, b.layers)):
        assert x.size == y.size and x.bit_length == y.bit_length, i
        for k in ("ty", "u", "v", "l", "lv", "c_real", "c_img", "is_assert"):
            assert np.array_equal(getattr(x, k), getattr(y, k)), (i, k)
        assert x.max_dad_bit_length == y.max_dad_bit_length, i
        assert x.max_dad_size == y.max_dad_size, i
        assert list(x.dad_size) == list(y.dad_size), i
        assert list(x.dad_bit_length) == list(y.dad_bit_length), i
        assert len(x.dad_id) == len(y.dad_id), i
        for li in range(len(x.dad_id)):
            assert np.array_equal(x.dad_id[li], y.dad_id[li]), (i, li)


@pytest.fixture(params=["gates", "small1200"])
def pws(request, tmp_path):
    if request.param == "small1200":
        return SMALL1200
    p = tmp_path / "c.pws"
    p.write_text(PWS)
    return p


@pytest.mark.parametrize("bug_compat", [True, False])
def test_native_matches_python_and_jax(pws, bug_compat):
    got = native.load_circuit(str(pws), bug_compat=bug_compat)
    _same(got, _python(pws, bug_compat))
    _same(got, jnative.load_circuit(str(pws), bug_compat=bug_compat))


def test_library_builds_under_build_native():
    native.load_circuit(str(SMALL1200))
    target = native._target()
    assert target.parent == ROOT / "build" / "native"
    assert target.name.startswith(f"lib{native.NAME}-")
    assert target.exists()
    assert native.SRC == ROOT / "virgo_plus_tpu_torch" / "native" / \
        "frontend.cpp"


def test_driver_routes_through_native(monkeypatch):
    calls = []
    real = native.load_circuit
    monkeypatch.setattr(native, "load_circuit",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    c = driver.load_circuit(str(SMALL1200))
    assert len(calls) == 1
    _same(c, driver.load_circuit(str(SMALL1200), prefer_native=False))


def test_no_compiler_falls_back_to_python(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "empty")
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load_circuit(str(SMALL1200))
    _same(driver.load_circuit(str(SMALL1200)), _python(SMALL1200, True))


def test_native_parse_error_raises(tmp_path):
    bad = tmp_path / "bad.pws"
    bad.write_text("P V0 = I0 E\nP V1 = V0 ? V0 E\n")
    assert native.available()
    with pytest.raises(ValueError, match="native frontend"):
        driver.load_circuit(str(bad))
