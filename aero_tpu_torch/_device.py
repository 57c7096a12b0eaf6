"""The package's device rule, shared by every entry point, and the calls by
which the host waits for the CUDA stream.

A blocking copy between pageable host memory and the card, a scalar read of
a card tensor and a synchronize each make the host wait until the stream
has drained. Every such wait on the main path goes through a helper here,
which counts it as one `syncs` on the innermost open tracing span; on the
CPU nothing waits and nothing is counted.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.tracing import count


def resolve_device(device) -> torch.device:
    """`None` is the CUDA card, and raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "aero_tpu_torch proves on a CUDA card and found none; pass "
            "device='cpu' to prove on the CPU")
    return torch.device("cuda")


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`: to a card, a blocking copy."""
    out = t.to(device)
    if out.is_cuda and not t.is_cuda:
        count("syncs")
    return out


def index_tensor(values, device) -> torch.Tensor:
    """Integer positions as an int64 tensor on `device`: to a card, a
    blocking copy."""
    t = torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)
    if t.is_cuda:
        count("syncs")
    return t


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the CPU: from a card, a blocking copy."""
    if t.is_cuda:
        count("syncs")
    return t.cpu()


def wait_stream(device) -> None:
    """Wait for the current stream of the CUDA `device`: what a kernel's or
    a non-blocking copy's writes into pinned host memory need before the
    host reads them."""
    torch.cuda.current_stream(device).synchronize()
    count("syncs")


def synchronize(device) -> None:
    """Wait for every stream of the CUDA `device`."""
    torch.cuda.synchronize(device)
    count("syncs")
