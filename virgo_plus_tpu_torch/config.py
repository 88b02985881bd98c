"""Typed protocol configuration (SURVEY.md §5.6).

The reference hardcodes its parameters as compile-time constants
(reference lib/virgo/src/constants.h:4-13) selected by a CMake cache
variable.  Here the same knobs are a runtime dataclass with the reference
values as defaults.  driver.run / the CLI consume it (transcript mode,
seed, bug-compat); pc/virgo_pc.py's module constants mirror the PC-shape
defaults for the hot paths (changing slice/rate at runtime is unsupported —
edit those constants and start a fresh process for that).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ProtocolConfig:
    # field: GF((2^61-1)^2); the Mersenne prime is load-bearing for the
    # shift-based reductions, so it is intentionally not configurable.
    log_slice_number: int = 6        # constants.h:8
    rs_code_rate: int = 5            # constants.h:10 (rate 1/32)
    ldt_repeat_num: int = 33         # constants.h:5
    max_bit_length: int = 30         # constants.h:11
    max_fri_depth: int = 30          # constants.h:4
    # transcript mode: "glibc" (reference-parity interactive stream) or
    # "fs" (non-interactive, SHA3 sponge)
    transcript: str = "glibc"
    seed: int = 3396                 # fieldElement.cpp:108
    bug_compat: bool = True          # main.cpp:104-110 fallthrough
    # mesh shape for multi-chip runs: (dp, sp); None = single chip.
    # driver.run routes sp > 1 through parallel.gkr_sharded.prove_sharded.
    mesh: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        # The PC-shape constants are compile-time in this build exactly as
        # they are in the reference (constants.h selected by CMake): the
        # PC pipeline reads pc/virgo_pc.py's module constants.
        # Accepting a different value here and silently ignoring it would
        # be a trap, so non-default shapes error loudly at construction.
        ref = dict(log_slice_number=6, rs_code_rate=5, ldt_repeat_num=33,
                   max_bit_length=30, max_fri_depth=30)
        for k, v in ref.items():
            if getattr(self, k) != v:
                raise ValueError(
                    f"ProtocolConfig.{k}={getattr(self, k)} is not "
                    f"supported at runtime: the PC pipelines compile "
                    f"against pc/virgo_pc.py's constants (reference "
                    f"default {v}, constants.h).  Edit those constants "
                    f"and start a fresh process to change the PC shape.")
        if self.transcript not in ("glibc", "fs"):
            raise ValueError(f"unknown transcript mode {self.transcript!r}; "
                             f"choose 'glibc' or 'fs'")
        if self.mesh is not None:
            dp, sp = self.mesh
            if dp < 1 or sp < 1 or (sp & (sp - 1)) != 0:
                raise ValueError(
                    f"mesh={self.mesh}: dp must be >= 1 and sp a power of "
                    f"two (the sharded fold schedule halves over sp)")

    @property
    def slice_number(self) -> int:
        return 1 << self.log_slice_number


DEFAULT = ProtocolConfig()
