"""The device an entry point runs on: the card unless the caller asks for
the CPU."""

from __future__ import annotations

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
