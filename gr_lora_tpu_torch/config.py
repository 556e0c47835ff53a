"""Typed configuration for the LoRa PHY pipeline.

The port's own copy of gr_lora_tpu/config.py (same fields, derived
properties, ``replace``, hashing and equality; tests/test_torch_core.py
holds the two equal).  One frozen dataclass replaces the reference's
scattered GRC parameter schemas and compile-time ``#define`` knobs
(reference: grc/*.block.yml, lib/demod_impl.cc:28-36,
include/lora/demod.h:28-36).  Because it is hashable and static, the
port's plan and weight builders cache on it (``functools.lru_cache``).
"""

from __future__ import annotations

import dataclasses
import enum


class PeakSearch(enum.IntEnum):
    """FFT peak-search algorithm (reference: include/lora/demod.h:34-36)."""

    ABS = 0     # magnitude of folded spectrum halves, summed
    PHASE = 1   # k phase-rotated complex sums, best of k
    B = 2       # single complex sum (PHASE with k=1, offset 0)


# FSM tuning constants (reference: include/lora/demod.h:28-33).
DEMOD_HISTORY_DEPTH = 7
REQUIRED_PREAMBLE_CHIRPS = 4
REQUIRED_SFD_CHIRPS = 2
DEMOD_SYNC_RECOVERY_COUNT = (8 - REQUIRED_PREAMBLE_CHIRPS) + (2 - REQUIRED_SFD_CHIRPS) + 8

# Weak-signal demod constants (reference: include/lora/weak_demod.h:27-30).
WEAK_REQUIRED_PREAMBLE_CHIRPS = 5
WEAK_DEMOD_BUFFER_SIZE = 15
WEAK_DEMOD_HISTORY = 7
WEAK_DEMOD_SYNC_RECOVERY_COUNT = 7

# Pyramid collision-decoder constants
# (reference: include/lora/pyramid_demod.h:28-30, lib/pyramid_demod_impl.cc:36,95,111-124).
PYRAMID_OVERLAP_FACTOR = 8
PYRAMID_HISTORY_DEPTH = 3
TIMESTAMP_MOD = 1 << 28
PYRAMID_NUM_PREAMBLE = 6
PYRAMID_TRACK_POOL = 1000
PYRAMID_PACKET_POOL = 40
# Per-track peak cap (beyond-reference): bounds memory under persistent
# interference; a normal packet track holds < ~50 peaks.  A track hitting
# the cap is finalized as if idle (native/src/pyramid_tracker.cc).
PYRAMID_MAX_TRACK_PEAKS = 256


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Static description of one LoRa operating point.

    Mirrors the union of the reference block constructor parameters
    (mod.h:49, encode.h:50-54, demod.h:69-79, pyramid_demod.h:58-63,
    weak_demod.h:63-74, decode.h:52-57).
    """

    sf: int = 8                  # spreading factor, 6..12
    cr: int = 4                  # code rate 4/(4+cr), 1..4
    crc: bool = True             # append/verify payload CRC16
    ldr: bool = False            # low-data-rate optimization (2^sf/bw > 16 ms)
    explicit_header: bool = False
    payload_len: int = 8         # bytes; used in implicit-header mode
    sync_word: int = 0x12

    # Receiver knobs.
    p: int = 2                   # fs/bw ratio (samples per chip at the demod)
    fft_factor: int = 2          # FFT zero-padding zoom factor
    beta: float = 25.0           # Kaiser window beta (pyramid windowed FFT)
    peak_search: PeakSearch = PeakSearch.ABS
    peak_phase_k: int = 4        # k for PeakSearch.PHASE
    threshold: float = 0.005     # pyramid peak threshold
    weak_sym_num: int = 24       # weak demod: known symbol count per packet
    # Weak-demod drift compensation policy.  "reference" reproduces
    # weak_demod_impl.cc:196-217 exactly: the modulus-1 integrator runs even
    # without LDR, where it random-walks on noisy fractional bins and costs
    # several dB of packet-perfect sensitivity (docs/BENCH.md PER table).
    # "ldr-only" (beyond-reference, opt-in) disables it when !ldr — the same
    # rule the reference's own PLAIN demod applies (demod_impl.cc:280).
    weak_compensation: str = "reference"
    precision: str = "highest"   # zoom-DFT matmul precision:
                                 #   "highest" (f32, bit-stable peaks),
                                 #   "default" (XLA default),
                                 #   "bf16" (full-rate MXU, f32 accumulate)

    def __post_init__(self):
        if not (6 <= self.sf <= 12):
            raise ValueError(f"sf must be in [6, 12], got {self.sf}")
        if not (1 <= self.cr <= 4):
            raise ValueError(f"cr must be in [1, 4], got {self.cr}")
        if self.sf == 6 and self.explicit_header:
            raise ValueError("SF6 does not support explicit header mode")
        if self.p < 1 or self.fft_factor < 1:
            raise ValueError("p and fft_factor must be >= 1")
        if self.precision not in ("highest", "default", "bf16"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.weak_compensation not in ("reference", "ldr-only"):
            raise ValueError(
                f"unknown weak_compensation {self.weak_compensation!r}")

    # Derived sizes (reference: demod_impl.cc:112-119).
    @property
    def num_symbols(self) -> int:
        """Chips per symbol == number of symbol values == 2^sf."""
        return 1 << self.sf

    @property
    def num_samples(self) -> int:
        """Samples per symbol period at the receiver rate (p * 2^sf)."""
        return self.p * self.num_symbols

    @property
    def bin_size(self) -> int:
        """Folded spectrum size: fft_factor * 2^sf bins."""
        return self.fft_factor * self.num_symbols

    @property
    def fft_size(self) -> int:
        """Zero-padded FFT length: fft_factor * p * 2^sf."""
        return self.fft_factor * self.num_samples

    @property
    def preamble_drift_max(self) -> int:
        """Max inter-chirp argmax drift during preamble detection
        (reference: demod_impl.cc:119)."""
        return self.fft_factor * (2 if self.ldr else 1)

    @property
    def bin_tolerance(self) -> int:
        """Pyramid peak-track bin matching tolerance
        (reference: pyramid_demod_impl.cc:102)."""
        return self.fft_factor * 2 if self.ldr else self.fft_factor // 2

    @property
    def ppm_payload(self) -> int:
        """Bits per payload symbol after LDR reduction."""
        return self.sf - 2 * int(self.ldr)

    def packet_symbol_len(self, payload_len: int | None = None,
                          cr: int | None = None, crc: bool | None = None) -> int:
        """Total demodulated symbols per packet, header symbols included
        (reference formula: demod_impl.cc:100, encode_impl.cc:107-112)."""
        from .core.header import calc_sym_num

        return calc_sym_num(
            payload_len if payload_len is not None else self.payload_len,
            sf=self.sf,
            cr=cr if cr is not None else self.cr,
            crc=crc if crc is not None else self.crc,
            ldr=self.ldr,
            explicit_header=self.explicit_header,
        )

    def replace(self, **kw) -> "LoraConfig":
        return dataclasses.replace(self, **kw)
