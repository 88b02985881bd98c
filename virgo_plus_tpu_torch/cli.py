"""Command-line interface.

    python -m virgo_plus_tpu_torch prove  <circuit.pws> -o proof.npz
    python -m virgo_plus_tpu_torch verify <circuit.pws> proof.npz
    python -m virgo_plus_tpu_torch run    <circuit.pws>        # prove + verify

Counterpart of ``virgo_plus_tpu/cli.py``, with one addition: ``--device``
(default ``cuda``; ``--device cpu`` runs the plain PyTorch path).  `run`
mirrors the reference binary's output format (reference
src/verifier.cpp:176-184): input size, prove time, proof sizes, so tooling
that parses the reference's stdout keeps working.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="virgo_plus_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--no-bug-compat", action="store_true",
                        help="faithful Not/Copy semantics instead of the "
                             "reference's fallthrough behaviour")
        sp.add_argument("--device", default="cuda",
                        help="torch device to prove and verify on "
                             "(default cuda; cpu runs the plain path)")

    pp = sub.add_parser("prove", help="prove a .pws circuit")
    pp.add_argument("circuit")
    pp.add_argument("-o", "--out", default="proof.npz")
    pp.add_argument("--seed", type=int, default=3396)
    pp.add_argument("--witness", default=None,
                    help=".npy witness file: (n,) reals or (2, n) "
                         "real/imag uint64 rows (the reference only "
                         "supports random witnesses)")
    pp.add_argument("--fs", action="store_true",
                    help="non-interactive Fiat-Shamir transcript instead "
                         "of the reference's glibc stream")
    common(pp)

    vp = sub.add_parser("verify", help="verify a serialized proof")
    vp.add_argument("circuit")
    vp.add_argument("proof")
    vp.add_argument("--seed", type=int, default=3396)
    vp.add_argument("--fs", action="store_true")
    common(vp)

    rp = sub.add_parser("run", help="prove + verify (reference-style output)")
    rp.add_argument("circuit")
    rp.add_argument("--seed", type=int, default=3396)
    common(rp)

    args = p.parse_args(argv)

    from . import device, driver, proof_io

    try:
        dev = device.resolve(args.device)
    except RuntimeError as exc:
        p.error(f"{exc} (on the command line: --device cpu)")
    circuit = driver.load_circuit(args.circuit,
                                  bug_compat=not args.no_bug_compat)
    # one prove or verify per process: eager, since a graph's first call
    # also pays an eager call and the capture (driver.compile_prover)
    cp = driver.compile_prover(circuit, device=dev, graphed=False)

    if args.cmd == "prove":
        witness = None
        if args.witness:
            import numpy as np
            w = np.load(args.witness)
            witness = w if w.ndim == 2 else np.stack(
                [w, np.zeros_like(w)])
        if args.fs:
            full, info = driver.prove_fs(circuit, cp, witness=witness)
        else:
            full, info = driver.prove(circuit, cp, seed=args.seed,
                                      witness=witness)
        proof_io.save(args.out, full)
        print(f"proof written to {args.out}")
        print(f"Prove Time {info['prove_time']:.6f}")
        print(f"proof size = {info['gkr_proof_size'] / 1024:.6f} kb "
              f"(+ {info['pc_proof_size'] / 1024:.6f} kb PC)")
        return 0

    if args.cmd == "verify":
        full = proof_io.load(args.proof)
        if args.fs:
            rep = driver.verify_fs(circuit, full, cp)
        else:
            rep = driver.verify(circuit, full, cp, seed=args.seed)
        print("Verification pass" if rep.ok else "Verification fail",
              file=sys.stderr)
        print(f"Input size {rep.input_size}")
        # reference format (verifier.cpp:180): total = fast + slow sweeps
        print(f"verify time {rep.verify_time:.6f} = "
              f"{rep.verify_time_fast:.6f} + {rep.verify_time_slow:.6f}(slow)")
        return 0 if rep.ok else 1

    # run
    t0 = time.time()
    rep = driver.run(circuit=circuit, compiled=cp, seed=args.seed)
    print("Verification pass" if rep.ok else "Verification fail",
          file=sys.stderr)
    print(f"Input size {rep.input_size}")
    print(f"Prove Time {rep.prove_time:.6f}")
    print(f"verify time {rep.verify_time:.6f} = "
          f"{rep.verify_time_fast:.6f} + {rep.verify_time_slow:.6f}(slow)")
    print(f"proof size = {rep.gkr_proof_size / 1024:.6f} kb")
    print(f"Polynomial commitment: proof size "
          f"{rep.pc_proof_size / 1024:.6f} kb")
    # op-counter line (main.cpp:157): analytic sumcheck field-op counts of
    # the protocol on this circuit + the resulting throughput
    mult, add = rep.details.get("op_counts", (0, 0))
    print(f"mult counter {mult}, add counter {add}")
    if rep.prove_time > 0 and (mult or add):
        print(f"prover field-ops/s {(mult + add) / rep.prove_time:.3e}")
    print(f"total wall {time.time() - t0:.3f}s")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
