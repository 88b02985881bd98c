"""Device selection for the port's entry points.

Entry points take ``device=None``, which means the CUDA card.  There is no
silent fallback: without CUDA the call raises, and a caller that wants the
CPU (the tests) asks for it by name.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "virgo_plus_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
