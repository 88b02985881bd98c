"""The port's command line: ``python -m virgo_plus_tpu_torch ... --device
cpu``.  Help and argument errors, prove -> proof file -> verify on the
small1200 fixture in both transcript modes (glibc and --fs), and `run`'s
reference-format output lines.  Help, errors and the cross-mode check call
``cli.main`` in this process; the rest goes through ``python -m``."""

import os
import subprocess
import sys

import pytest

from virgo_plus_tpu_torch import cli

from torch_shared import THREAD_ENV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = "tests/data/small1200.pws"


def _run(args):
    return subprocess.run([sys.executable, "-m", "virgo_plus_tpu_torch"]
                          + args, capture_output=True, text=True, cwd=ROOT,
                          timeout=300, env=THREAD_ENV)


def _main(argv):
    """cli.main in this process -> its exit code."""
    try:
        return cli.main(argv)
    except SystemExit as exc:
        return exc.code


def test_cli_help_and_errors(capsys):
    assert _main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "prove" in out and "verify" in out
    assert _main(["prove", "--help"]) == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--fs" in out
    assert _main(["prove"]) == 2                      # no circuit
    assert _main(["bogus-subcommand"]) == 2
    fixture = os.path.join(ROOT, FIXTURE)
    assert _main(["run", fixture, "--device", "no-such-device"]) == 2
    assert "no-such-device" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["glibc", "fs"])
def test_cli_prove_verify(tmp_path, capsys, mode):
    proof = str(tmp_path / "p.npz")
    fs = ["--fs"] if mode == "fs" else []
    r = _run(["prove", FIXTURE, "-o", proof, "--device", "cpu"] + fs)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "proof written" in r.stdout and "Prove Time" in r.stdout
    r = _run(["verify", FIXTURE, proof, "--device", "cpu"] + fs)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Verification pass" in r.stderr
    # reference-format fast/slow verify-time split (verifier.cpp:180)
    assert "(slow)" in r.stdout
    # a proof checked in the other transcript mode is rejected
    other = [] if fs else ["--fs"]
    fixture = os.path.join(ROOT, FIXTURE)
    assert _main(["verify", fixture, proof, "--device", "cpu"] + other) == 1
    assert "Verification fail" in capsys.readouterr().err


def test_cli_run_prints_reference_lines():
    r = _run(["run", FIXTURE, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Verification pass" in r.stderr
    out = r.stdout
    for line in ("Input size 600", "Prove Time", "(slow)",
                 "proof size = 8.718750 kb",
                 "Polynomial commitment: proof size 75.218750 kb",
                 "mult counter", "add counter"):
        assert line in out, (line, out)
