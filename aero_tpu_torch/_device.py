"""The package's device rule, shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`None` is the CUDA card, and raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "aero_tpu_torch proves on a CUDA card and found none; pass "
            "device='cpu' to prove on the CPU")
    return torch.device("cuda")
