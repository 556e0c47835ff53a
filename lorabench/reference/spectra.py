"""Plain reference spectra: dechirped, zero-padded DFT bands of LoRa frames.

A straightforward evaluation, in plain PyTorch, of what the receivers'
spectra mean: a frame of N = p 2^sf samples is multiplied by the dechirp
table exp(+j phi(i)), phi(i) = pi/p (i - i^2/N), zero-padded to F =
fft_factor N points and transformed; the two bands [0, K) and [F - K, F), K =
fft_factor 2^sf, are kept as magnitudes.  Nothing here imports the
program or takes a table it made.

``precision`` picks the arithmetic:

- ``"f64"``: float64 throughout (the reference);
- ``"bf16"``: every sample, every dechirp coefficient and every product
  rounded to bfloat16, the transform in float32: what a bfloat16 product
  with float32 accumulation does to each term.  It is the control: the
  reference put in the program's place one precision below the float32
  that the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Real ``x`` rounded to ``precision`` and back to float32."""
    if precision != "bf16":
        raise ValueError(f"no precision {precision!r}")
    return x.to(torch.bfloat16).to(torch.float32)


def _rounded_complex(z: torch.Tensor, precision: str) -> torch.Tensor:
    ri = torch.view_as_real(z.to(torch.complex64))
    return torch.view_as_complex(_round(ri, precision).contiguous())


def dechirp(sf: int, p: int, device):
    """exp(+j phi) as complex128 [N] on ``device``."""
    n = p << sf
    i = np.arange(n, dtype=np.float64)
    return torch.from_numpy(np.exp(1j * np.pi / p * (i - i * i / n))).to(
        device)


def bands(frames: torch.Tensor, mod: torch.Tensor, sf: int,
          fft_factor: int, precision: str = "f64"):
    """|DFT| of ``frames * mod`` (complex [..., N]) in the two bands:
    (lo [..., K], hi [..., K]) as float64."""
    n = frames.shape[-1]
    f = fft_factor * n
    k = fft_factor << sf
    if precision == "f64":
        y = torch.fft.fft(frames.to(torch.complex128) * mod, n=f, dim=-1)
    else:
        prod = (_rounded_complex(frames, precision)
                * _rounded_complex(mod, precision))
        y = torch.fft.fft(_rounded_complex(prod, precision), n=f, dim=-1)
    mag = y.abs().to(torch.float64)
    return mag[..., :k], mag[..., f - k:]


def as_complex(iq: torch.Tensor) -> torch.Tensor:
    """float [..., T, 2] IQ -> complex128 [..., T]."""
    iq = iq.to(torch.float64)
    return torch.complex(iq[..., 0], iq[..., 1])


def frames(z: torch.Tensor, n: int, hop: int, count: int,
           start: int = 0) -> torch.Tensor:
    """[count, n] frames of complex [T] at start + f hop, zero past T."""
    need = start + (count - 1) * hop + n
    if need > z.shape[-1]:
        z = torch.nn.functional.pad(z, (0, need - z.shape[-1]))
    return z[start:need].unfold(0, n, hop)


def peak_to_mean(windows: torch.Tensor, sf: int, p: int, fft_factor: int,
                 precision: str = "f64") -> torch.Tensor:
    """Peak over mean of the folded up-chirp spectrum |lo| + |hi| of each
    window (float [P, N, 2]): the detection ratio the FSM records."""
    lo, hi = bands(as_complex(windows), dechirp(sf, p, windows.device), sf,
                   fft_factor, precision)
    folded = lo + hi
    return folded.amax(-1) / folded.mean(-1)
