"""Dense preamble scan for detection-gated demodulation.

Twin of ``make_preamble_scan`` in gr_lora_tpu/dist/triggered.py.  Per SF,
one symbol-strided folded up-chirp spectrum lattice over all channels: a
preamble shows as a run of >= REQUIRED_PREAMBLE_CHIRPS consecutive windows
whose argmax stays put (within the LDR drift tolerance) and whose peak
dominates the spectrum (peak > snr_gate * spectrum mean) — the FSM's
detection predicate evaluated everywhere at once.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import REQUIRED_PREAMBLE_CHIRPS, LoraConfig
from ..ops.cplx import cmag
from ..ops.dechirp import up_plan


class PreambleScan(nn.Module):
    """iq [C, T, 2] -> (starts int32[C, E], valid bool[C, E],
    nhits int32[C]): the window indices where a fresh preamble run begins,
    plus the total hit count (so hits beyond max_events are observable).

    The dechirp plan is the ``plan`` submodule (buffer ``mod``)."""

    def __init__(self, cfg: LoraConfig, num_windows: int, max_events: int = 8,
                 snr_gate: float = 3.0):
        super().__init__()
        self.n = cfg.num_samples
        self.k = cfg.bin_size
        self.drift = cfg.preamble_drift_max
        self.num_windows = num_windows
        self.max_events = max_events
        self.snr_gate = snr_gate
        self.plan = up_plan(cfg.sf, cfg.p, cfg.fft_factor)

    def forward(self, iq: torch.Tensor):
        c = iq.shape[0]
        nw, k, need = self.num_windows, self.k, REQUIRED_PREAMBLE_CHIRPS
        frames = iq[:, :nw * self.n, :].reshape(c, nw, self.n, 2)
        lo, hi = self.plan(frames)
        folded = cmag(lo) + cmag(hi)                     # [C, W, K]
        val, idx = torch.max(folded, dim=-1)
        strong = val > self.snr_gate * folded.mean(dim=-1)

        # Consecutive windows agreeing within the drift tolerance
        # (demod_impl.cc:418-427).
        dis = torch.remainder(idx[:, 1:] - idx[:, :-1] + k, k)
        agree = (dis <= self.drift) | (dis >= k - self.drift)
        agree = torch.cat([torch.zeros_like(agree[:, :1]), agree],
                          dim=1) & strong

        # Run length ending at each window (0 where not agreeing): the
        # distance to the last disagreeing window.
        pos = torch.arange(nw, device=iq.device).expand(c, nw)
        last_off = torch.cummax(torch.where(agree, -1, pos), dim=1).values
        runs = torch.where(agree, pos - last_off, 0)
        # Detection: the FIRST window where the run reaches need-1
        # agreements; later windows of the same preamble have longer runs.
        hit = runs == need - 1
        score = hit.float() * (1.0 + torch.arange(
            nw, 0, -1, device=iq.device, dtype=torch.float32))
        vals, starts = torch.topk(score, min(self.max_events, nw), dim=1)
        valid = vals > 0.0
        starts = torch.clamp(starts - (need - 1), min=0)
        nhits = hit.sum(dim=1, dtype=torch.int32)
        return starts.to(torch.int32), valid, nhits


def make_preamble_scan(cfg: LoraConfig, num_windows: int,
                       max_events: int = 8,
                       snr_gate: float = 3.0) -> PreambleScan:
    """The scan module for one SF, built on the CPU (``.to(device)``)."""
    return PreambleScan(cfg, num_windows, max_events, snr_gate)
