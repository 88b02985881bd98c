"""virgo_plus_tpu_torch: the Virgo++ prover and verifier on PyTorch and CUDA.

The port of ``virgo_plus_tpu`` (JAX) to one NVIDIA H100.  Field elements are
int64 planes with the JAX package's uint64 bit patterns; the sumcheck fold
(K1) and SHA3-256 (K2) are hand-written CUDA kernels under ``csrc/``, each
with a plain PyTorch twin in the module that wraps it.  The package imports
neither JAX nor the JAX package.
"""
