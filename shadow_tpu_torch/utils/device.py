"""Device resolution for the port's entry points.

Every entry point takes an explicit `device`.  None means the card:
the port runs on CUDA unless the caller asks for the CPU (the tier-1
tests do), and it never drops to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shadow_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (or --device cpu) to run on the CPU")
    return dev
