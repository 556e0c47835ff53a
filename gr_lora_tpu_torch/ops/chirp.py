"""Chirp table synthesis (NumPy twin of gr_lora_tpu/ops/chirp.py).

The original sits in a package whose ``__init__`` imports jax, so the port
keeps this copy; tests/test_torch_twins.py pins it equal to the original.

Two conventions exist in the reference and must interoperate:

- the modulator builds its table by accumulating a linear phase ramp at one
  sample per chip (reference: mod_impl.cc:60-69), giving
  ``up[i] = exp(j * (-pi*(i+1) + pi*i*(i+1)/N))``;
- the demodulators use the closed form ``phi(i) = pi/p * (i - i^2/N)`` with
  ``N = p * 2^sf`` and dechirp by multiplying with ``exp(+j*phi)``
  (reference: demod_impl.cc:123-128).

The two differ by a constant phase and a half-bin frequency offset which the
preamble-relative CFO estimate cancels exactly.  Our TX uses the closed form
(so TX supports any samples-per-chip p natively, a superset of the reference
p=1 modulator).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def chirp_tables(sf: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """(upchirp, downchirp) complex64 tables of length N = p * 2^sf.

    upchirp[i] = exp(-j*phi(i)), downchirp[i] = exp(+j*phi(i)) with
    phi(i) = pi/p * (i - i^2/N).  ``downchirp`` is what the receiver
    multiplies against incoming upchirps (reference: demod_impl.cc:123-128,
    noting the reference names the +phi table "downchirp" likewise).
    """
    n = p << sf
    i = np.arange(n, dtype=np.float64)
    phase = np.pi / p * (i - i * i / n)
    down = np.exp(1j * phase).astype(np.complex64)
    up = np.conj(down)
    up.setflags(write=False)
    down.setflags(write=False)
    return up, down


def symbol_chirp(symbol: int, sf: int, p: int) -> np.ndarray:
    """One modulated upchirp: the base chirp cyclically advanced by
    ``symbol`` chips (= symbol * p samples)."""
    up, _ = chirp_tables(sf, p)
    return np.roll(up, -int(symbol) * p)
