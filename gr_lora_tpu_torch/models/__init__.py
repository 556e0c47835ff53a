"""Receivers and transmitters: the reference blocks, on the card."""

from .decoder import Decoder
from .demodulator import (StreamingDemodulator, demod_fn, demod_stream_fn,
                          demodulate, make_demodulator)
from .modulator import modulate, packet_duration
from .pyramid import PyramidTracker, pyramid_demodulate
from .transceiver import LoopbackResult, loopback
from .weak import StreamingWeakDemodulator, modulate_weak, weak_demodulate

__all__ = [
    "Decoder", "StreamingDemodulator", "demod_fn", "demod_stream_fn",
    "demodulate", "make_demodulator", "modulate", "packet_duration",
    "PyramidTracker", "pyramid_demodulate", "LoopbackResult", "loopback",
    "modulate_weak", "weak_demodulate", "StreamingWeakDemodulator",
]
