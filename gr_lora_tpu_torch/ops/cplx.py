"""Complex arithmetic over real float32 pairs.

The port keeps the reference package's layout at its public functions:
a complex tensor is float32 with a trailing dim of 2 (re, im), which is
also the interleaved layout of gr_complex IQ captures.  Inside, transforms
may view such a tensor as complex64 (``as_complex``) — the card has both
complex dtypes and an FFT.
"""

from __future__ import annotations

import numpy as np
import torch


def to_ri(x: np.ndarray) -> np.ndarray:
    """complex -> [..., 2] float32 (host-side)."""
    x = np.asarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def from_ri(x) -> np.ndarray:
    """[..., 2] float32 -> complex64 (host-side)."""
    x = np.asarray(x, dtype=np.float32)
    return x[..., 0] + 1j * x[..., 1]


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complex multiply of [..., 2] pairs."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def cmag(a: torch.Tensor) -> torch.Tensor:
    """|a| of [..., 2] pairs -> [...] float32."""
    return torch.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2)


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """[..., 2] float32 -> complex64 [...] (a view when contiguous)."""
    return torch.view_as_complex(x.contiguous())


def as_ri(z: torch.Tensor) -> torch.Tensor:
    """complex64 [...] -> contiguous [..., 2] float32."""
    return torch.view_as_real(z).contiguous()
