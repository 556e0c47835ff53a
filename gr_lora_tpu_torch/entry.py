"""The flagship step as (fn, args): the port's counterpart of the repo
root's ``__graft_entry__.entry``.

The single-packet demodulator FSM (``models.demodulator.demod_fn``) over a
modulated SF8 implicit-header LDR packet at fft_factor 2.
"""

from __future__ import annotations

import torch

from .config import LoraConfig
from .core.codec import encode
from .device import DEFAULT as DEFAULT_DEVICE
from .device import resolve as resolve_device
from .models.demodulator import demod_fn
from .models.modulator import modulate
from .ops.cplx import to_ri


def entry(device: str | torch.device = DEFAULT_DEVICE):
    """(fn, args): ``fn(*args)`` runs the FSM on ``device`` (the card
    unless the caller asks for the CPU) and returns its outputs."""
    dev = resolve_device(device)
    cfg = LoraConfig(sf=8, cr=4, crc=True, ldr=True, explicit_header=False,
                     payload_len=6, p=2, fft_factor=2)
    iq_ri = to_ri(modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg))
    fn = demod_fn(cfg, iq_ri.shape[0], 4, device=dev)
    return fn, (torch.from_numpy(iq_ri).to(dev),)
