"""Streaming front-end: FIR filtering, polyphase resampling, capture replay,
the wideband channelizer, ring ingest and device-resident stream
buffering."""

from .frontend import (
    design_low_pass,
    fir_filter,
    polyphase_resample,
    replay,
    resample_to_receiver_rate,
)

__all__ = [
    "design_low_pass", "fir_filter", "polyphase_resample",
    "resample_to_receiver_rate", "replay",
]
