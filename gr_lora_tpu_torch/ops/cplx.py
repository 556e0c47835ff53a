"""Complex arithmetic over real float32 pairs.

The port keeps the reference package's layout at its public functions:
a complex tensor is float32 with a trailing dim of 2 (re, im), which is
also the interleaved layout of gr_complex IQ captures.  Inside, transforms
may view such a tensor as complex64 (``as_complex``) — the card has both
complex dtypes and an FFT.
"""

from __future__ import annotations

from contextlib import contextmanager

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


def cmag2(a: torch.Tensor) -> torch.Tensor:
    """|a|^2 (cheaper when only comparisons are needed)."""
    return a[..., 0] ** 2 + a[..., 1] ** 2


#: (object, attribute) of the per-backend float32 precision settings of
#: newer PyTorch, next to the legacy ``allow_tf32`` flags.
_NEW_PRECISION = (("cuda.matmul", "fp32_precision"),
                  ("cudnn.conv", "fp32_precision"))


def _flag_owner(path: str):
    obj = torch.backends
    for part in path.split("."):
        obj = getattr(obj, part, None)
    return obj


def _snapshot() -> list:
    """The caller's TF32 settings: the legacy flags where they can be read
    (PyTorch refuses to read them once the two APIs disagree) and the
    per-backend settings where this PyTorch has them."""
    saved = []
    for path in ("cuda.matmul", "cudnn"):
        try:
            saved.append((path, "allow_tf32",
                          getattr(_flag_owner(path), "allow_tf32")))
        except RuntimeError:
            pass
    for path, attr in _NEW_PRECISION:
        owner = _flag_owner(path)
        if owner is not None and hasattr(owner, attr):
            saved.append((path, attr, getattr(owner, attr)))
    return saved


@contextmanager
def f32_precision():
    """Full float32 inside the block for matmuls (cuBLAS) and convolutions
    (cuDNN), whatever the caller's TF32 settings; restored after.

    cuDNN convolutions run in TF32 by default on the card
    (``torch.backends.cudnn.allow_tf32`` is True), and a caller may turn
    TF32 on for matmuls; its 10-bit mantissa would eat into the front
    end's filter stopbands (the channelizer's > 50 dB rejection).  The
    block sets the legacy flags, whose setters keep both of PyTorch's
    APIs in agreement for matmuls (cuBLAS refuses to run while they
    disagree), then the per-backend settings to "ieee" where they exist
    (a convolution left at "none" would inherit a global "tf32")."""
    saved = _snapshot()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path, attr in _NEW_PRECISION:
        owner = _flag_owner(path)
        if owner is not None and hasattr(owner, attr):
            setattr(owner, attr, "ieee")
    try:
        yield
    finally:
        for path, attr, value in saved:
            setattr(_flag_owner(path), attr, value)


def pack_cmatmul_weights(w_re: np.ndarray, w_im: np.ndarray) -> np.ndarray:
    """complex[N, M] -> real [2N, 2M] so one matmul computes the complex
    product: rows [Wr | Wi ; -Wi | Wr], inputs packed [xr | xi]."""
    top = np.concatenate([w_re, w_im], axis=1)
    bot = np.concatenate([-w_im, w_re], axis=1)
    return np.concatenate([top, bot], axis=0)


def _operand(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """f32 operand, rounded through ``compute_dtype`` first when given:
    products of bf16 values are exact in f32, so an f32 matmul of the
    rounded operands is the bf16-operand / f32-accumulate class."""
    x = x.to(torch.float32)
    return x if compute_dtype is None else x.to(compute_dtype).float()


def cmatmul_packed(x: torch.Tensor, w2, compute_dtype=None) -> torch.Tensor:
    """[..., N, 2] @ packed [2N, 2M] -> [..., M, 2] as ONE real matmul.

    One [.., 2N] x [2N, 2M] product replaces the four [.., N] x [N, M]
    matmuls of the naive complex multiply.  ``compute_dtype=torch.bfloat16``
    rounds the operands to bf16 and accumulates in f32.  Runs in full f32
    whatever the TF32 flags (:func:`f32_precision`)."""
    w2 = torch.as_tensor(w2, device=x.device)
    xp = torch.cat([x[..., 0], x[..., 1]], dim=-1)
    with f32_precision():
        y = torch.matmul(_operand(xp, compute_dtype),
                         _operand(w2, compute_dtype))
    m = w2.shape[1] // 2
    return torch.stack([y[..., :m], y[..., m:]], dim=-1)


def cmatmul(x: torch.Tensor, w_re, w_im, compute_dtype=None) -> torch.Tensor:
    """[..., N, 2] @ complex[N, M] -> [..., M, 2] via four real matmuls
    (``compute_dtype`` as in :func:`cmatmul_packed`)."""
    w_re = _operand(torch.as_tensor(w_re, device=x.device), compute_dtype)
    w_im = _operand(torch.as_tensor(w_im, device=x.device), compute_dtype)
    xr = _operand(x[..., 0], compute_dtype)
    xi = _operand(x[..., 1], compute_dtype)
    with f32_precision():
        yr = xr @ w_re - xi @ w_im
        yi = xr @ w_im + xi @ w_re
    return torch.stack([yr, yi], dim=-1)


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """[..., 2] float32 -> complex64 [...] (a view when contiguous)."""
    return torch.view_as_complex(x.contiguous())


def as_ri(z: torch.Tensor) -> torch.Tensor:
    """complex64 [...] -> contiguous [..., 2] float32."""
    return torch.view_as_real(z).contiguous()
