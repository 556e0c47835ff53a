"""Chirp modulator: symbol vector -> complex64 IQ.

NumPy twin of gr_lora_tpu/models/modulator.py, whose package ``__init__``
imports jax; tests/test_torch_twins.py pins it equal to the original.  The
whole packet is one gather from the base chirp table (reference modulator:
mod_impl.cc:80-139).  Supports any samples-per-chip ``p`` (the reference
modulator is fixed at p=1).
"""

from __future__ import annotations

import numpy as np

from ..config import LoraConfig
from ..ops.chirp import chirp_tables

NUM_PREAMBLE_CHIRPS = 8  # reference: mod_impl.h:30


def modulate(symbols: np.ndarray, cfg: LoraConfig, p: int | None = None,
             pad_front: int | None = None, pad_back: int | None = None) -> np.ndarray:
    """Symbols -> IQ at ``p`` samples per chip.

    Layout (reference: mod_impl.cc:88-133): zeros | 8 preamble upchirps |
    2 sync-word chirps at 8*nibble chip offsets | 2.25 SFD downchirps |
    payload upchirps | zeros.
    """
    p = cfg.p if p is None else p
    up, down = chirp_tables(cfg.sf, p)
    n = p << cfg.sf

    if pad_front is None:
        pad_front = 4 * n                    # reference: mod_impl.cc:124
    if pad_back is None:
        pad_back = 4 * n + 128 * p           # reference: mod_impl.cc:133

    chunks = [np.zeros(pad_front, dtype=np.complex64)]

    i = np.arange(n)
    # Preamble: 8 base upchirps.
    chunks.append(np.tile(up, NUM_PREAMBLE_CHIRPS))
    # Sync word: two chirps offset by 8 * nibble chips (mod_impl.cc:97-106).
    for nib in ((cfg.sync_word & 0xF0) >> 4, cfg.sync_word & 0x0F):
        chunks.append(up[(8 * nib * p + i) % n])
    # SFD: 2.25 downchirps (mod_impl.cc:109-112).
    j = np.arange(2 * n + n // 4)
    chunks.append(down[j % n])
    # Payload chirps, advanced by symbol*p samples (mod_impl.cc:115-121).
    syms = np.asarray(symbols, dtype=np.int64)
    if len(syms):
        idx = (syms[:, None] * p + i[None, :]) % n
        chunks.append(up[idx].reshape(-1))

    chunks.append(np.zeros(pad_back, dtype=np.complex64))
    return np.concatenate(chunks).astype(np.complex64)


def packet_duration(num_symbols: int, cfg: LoraConfig, p: int | None = None) -> int:
    """Samples from first preamble sample to last payload sample."""
    p = cfg.p if p is None else p
    n = p << cfg.sf
    return (NUM_PREAMBLE_CHIRPS + 2) * n + (2 * n + n // 4) + num_symbols * n
