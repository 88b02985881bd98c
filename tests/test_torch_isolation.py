"""The port stands alone: no source of virgo_plus_tpu_torch/ or
chip_smoke.py imports JAX or the JAX package, the package imports with JAX
blocked, and an entry point called with the default device (CUDA) raises
when there is no CUDA instead of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from virgo_plus_tpu_torch import cli, device, driver, fused, kernels
from virgo_plus_tpu_torch.circuits.compile import compile_circuit
from virgo_plus_tpu_torch.circuits.layered import randomize, subset_init
from virgo_plus_tpu_torch.config import ProtocolConfig
from virgo_plus_tpu_torch.gkr import protocol
from virgo_plus_tpu_torch.parallel import sharded

import torch_shared  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "virgo_plus_tpu_torch"


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "virgo_plus_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'virgo_plus_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import virgo_plus_tpu_torch as p\n"
        "for info in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_default_device_without_cuda_raises(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = randomize(2, 7, seed=3)
    subset_init(c)
    before = dict(kernels.PLAIN_CALLS)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.compile_prover(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.prove(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(circuit=c)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.prove_fs(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(circuit=c, config=ProtocolConfig(transcript="fs"))
    assert kernels.PLAIN_CALLS == before      # nothing ran on the CPU
    cpu_proof, _ = driver.prove_fs(c, device="cpu")
    before = dict(kernels.PLAIN_CALLS)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.verify_fs(c, cpu_proof)
    # the command line without --device cpu: an argument error naming CUDA
    with pytest.raises(SystemExit) as exc:
        cli.main(["prove", str(ROOT / "tests/data/small1200.pws"),
                  "-o", str(tmp_path / "p.npz")])
    assert exc.value.code == 2 and "CUDA" in capsys.readouterr().err
    assert kernels.PLAIN_CALLS == before      # nothing ran on the CPU
    assert device.resolve("cpu") == torch.device("cpu")


def test_batched_provers_default_to_cuda(monkeypatch):
    """The batched provers and the other graph makers (graphs.py) raise
    without CUDA instead of holding their programs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = randomize(2, 7, seed=3)
    subset_init(c)
    cc = compile_circuit(c)
    plans = protocol.build_plans(cc)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_batched_prover(cc, plans, {})
    for graphed in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            sharded.make_batched_full_prover(cc, plans, graphed=graphed)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_e2e_prover(cc, plans)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused.make_fg_tape(1)
    for staged in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            protocol.make_prover(cc, plans, staged=staged)
    with pytest.raises(RuntimeError, match="CUDA"):
        protocol.make_evaluator(cc)


def test_sharded_runs_default_to_cuda(monkeypatch):
    """Without CUDA, a mesh run that does not ask for the CPU raises before
    any rank starts; the backend rule picks nccl only for a card a rank."""
    from virgo_plus_tpu_torch.parallel import mesh

    c = randomize(2, 7, seed=3)
    subset_init(c)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.run(circuit=c, config=ProtocolConfig(mesh=(1, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.spawn(mesh.rank_device, 1, 2)
    assert mesh.backend_for(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, world, want in ((1, 2, "gloo"), (2, 2, "nccl"),
                               (4, 2, "nccl"), (2, 4, "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert mesh.backend_for(world) == want, (count, world)
    assert mesh.backend_for(2, "cuda:0") == "gloo"
    assert mesh.rank_device(3) == torch.device("cuda", 3 % 2)
    assert mesh.rank_device(3, "cuda:0") == torch.device("cuda", 0)
    m = mesh.Mesh(dp=1, sp=16, rank=0, device=torch.device("cpu"),
                  backend="gloo", groups={})
    with pytest.raises(ValueError, match="at most 8"):
        m.field_sum(torch.zeros((2, 1), dtype=torch.int64))
