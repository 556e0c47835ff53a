"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import numpy as np
import torch

#: Every entry point's default device.
DEFAULT = "cuda"


def resolve(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA one with its index (the
    current device's where none is given, as tensors on it report it, so
    caches keyed on the device see one key); raise for a CUDA device when
    no CUDA device is present, rather than carry on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(iq, device: torch.device) -> torch.Tensor:
    """IQ as a float32 tensor on ``device``: a tensor is moved (not copied
    when it already lies there); a host array — complex, or float pairs —
    crosses once, on a CUDA device from pinned memory with a non-blocking
    copy (the caching host allocator keeps the pinned block alive until
    the copy has run)."""
    if isinstance(iq, torch.Tensor):
        return iq.to(device=device, dtype=torch.float32)
    a = np.asarray(iq)
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], -1)
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
