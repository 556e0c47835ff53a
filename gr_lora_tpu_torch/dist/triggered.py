"""Detection-gated demodulation: dense preamble scan + targeted FSM demod.

Port of gr_lora_tpu/dist/triggered.py.

1. **Scan (dense, batched)**: per SF, one symbol-strided folded up-chirp
   spectrum lattice over all channels (``PreambleScan``): a preamble shows
   as a run of >= REQUIRED_PREAMBLE_CHIRPS consecutive windows whose argmax
   stays put (within the LDR drift tolerance) and whose peak dominates the
   spectrum (peak > snr_gate * spectrum mean) — the FSM's detection
   predicate evaluated everywhere at once.
2. **Demod (sparse, targeted)**: a fixed-size packet window is cut around
   each detection and only those windows run the full FSM, one batched
   demod per SF over the events (``TriggeredReceiver``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..config import REQUIRED_PREAMBLE_CHIRPS, LoraConfig
from ..core.codec import DecodeResult, decode
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..models.demodulator import demod_fn, max_packet_symbols
from ..models.modulator import NUM_PREAMBLE_CHIRPS, packet_duration
from ..ops.cplx import cmag
from ..ops.dechirp import up_plan


def device_feed(iq, device: torch.device) -> torch.Tensor:
    """A feed as float32 [C, T, 2] on ``device``: complex or [..., T, 2]
    float IQ, a host array (uploaded once) or a tensor (left where it is
    when it already lies on ``device``)."""
    if isinstance(iq, torch.Tensor):
        x = iq.to(device=device, dtype=torch.float32)
    else:
        if np.iscomplexobj(iq):
            iq = np.stack([np.asarray(iq).real, np.asarray(iq).imag], -1)
        x = torch.from_numpy(np.asarray(iq, np.float32)).to(device)
    return x[None] if x.dim() == 2 else x


def scan_window(cfg: LoraConfig) -> int:
    """Samples cut around each detection: preamble lead-in + the longest
    packet + sync margin."""
    n = cfg.num_samples
    return (NUM_PREAMBLE_CHIRPS + 4) * n \
        + packet_duration(max_packet_symbols(cfg), cfg) + 4 * n


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


@dataclass
class TriggeredPacket:
    channel: int
    sf: int
    position: int            # sample index of the detection window start
    symbols: np.ndarray
    result: DecodeResult
    #: Peak/mean detection ratio (models.demodulator.snr_db_estimate).
    snr_ratio: float = 0.0


class TriggeredReceiver:
    """Scan everywhere, demodulate only where preambles exist.

    The feed crosses to ``device`` (the card unless the caller asks for the
    CPU) once; every SF scans that copy, the event windows are cut from it
    on the device, and one batched demod per SF runs over the events."""

    def __init__(self, base: LoraConfig, sfs=(7, 8, 9, 10, 11, 12),
                 max_events: int = 8, snr_gate: float = 3.0,
                 bw: float = 125e3,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.cfgs = {sf: base.replace(sf=sf, ldr=(1 << sf) / bw > 16e-3)
                     for sf in sfs}
        self.max_events = max_events
        self.snr_gate = snr_gate
        self._scans: dict = {}
        #: Detections beyond the max_events slots (raise it if nonzero).
        self.dropped_events = 0
        #: Demod-FSM packet-slot overflow across all triggered windows.
        self.dropped_packets = 0
        #: Event windows demodulated, over all calls.
        self.events = 0

    def _scan(self, cfg: LoraConfig, num_windows: int) -> PreambleScan:
        key = (cfg.sf, num_windows)
        if key not in self._scans:
            self._scans[key] = make_preamble_scan(
                cfg, num_windows, self.max_events,
                self.snr_gate).to(self.device)
        return self._scans[key]

    def __call__(self, iq) -> list[TriggeredPacket]:
        """Packets of iq: complex or [C, T, 2] / [T, 2] float IQ, on the
        host or already on the device."""
        diq = device_feed(iq, self.device)      # crosses to the device ONCE;
        c, t = diq.shape[0], diq.shape[1]       # every SF scans that copy
        out: list[TriggeredPacket] = []
        for sf, cfg in self.cfgs.items():
            n = cfg.num_samples
            nw = t // n
            if nw < REQUIRED_PREAMBLE_CHIRPS + 1:
                continue
            starts, valid, nhits = (x.cpu().numpy()
                                    for x in self._scan(cfg, nw)(diq))
            self.dropped_events += int(
                np.sum(np.maximum(nhits - self.max_events, 0)))
            win = min(scan_window(cfg), t)
            # Re-trigger suppression: one event per PREAMBLE, not per max
            # packet window — dense back-to-back traffic has many packets
            # inside one window (they all demodulate from the same slice;
            # the output dedupe below collapses cross-window repeats).
            suppress = (NUM_PREAMBLE_CHIRPS + 4) * n
            events = []       # (channel, sample_start)
            for ch in range(c):
                seen: list[int] = []
                for e in sorted(range(starts.shape[1]),
                                key=lambda e: int(starts[ch, e])):
                    if not valid[ch, e]:
                        continue
                    pos = int(starts[ch, e]) * n
                    if any(abs(pos - s) < suppress for s in seen):
                        continue
                    seen.append(pos)
                    # Anchor the slice at ITS trigger (zero-pad past the
                    # capture end) so the triggered packet is always the
                    # first the FSM meets.
                    events.append((ch, max(pos - 2 * n, 0)))
            if not events:
                continue
            self.events += len(events)
            # Lanes padded to a power of two with silent windows (they
            # find no preamble), so a receiver captures one FSM graph per
            # SF and power of two, not one per event count.
            lanes = 1 << (len(events) - 1).bit_length()
            slices = torch.zeros(lanes, win, 2, device=self.device)
            for i, (ch, s) in enumerate(events):
                stop = min(s + win, t)
                slices[i, :stop - s] = diq[ch, s:stop]
            syms, lens, pos, cnt, dropped, snr = (
                x.cpu().numpy()
                for x in demod_fn(cfg, win, 2, self.device)(slices))
            self.dropped_packets += int(np.sum(dropped))
            for i, (ch, s) in enumerate(events):
                for r in range(int(cnt[i])):
                    symbols = syms[i, r, :lens[i, r]].astype(np.uint16)
                    res = decode(symbols, cfg)
                    if res.ok:
                        out.append(TriggeredPacket(
                            ch, sf, s + int(pos[i, r]), symbols, res,
                            float(snr[i, r])))
        # Overlapping event windows demodulate shared packets more than
        # once (a packet is first in its own window and later in earlier
        # windows); detection positions agree only to within a symbol or
        # two of window phase, so merge same-(channel, sf, bytes) packets
        # closer than 4 symbols.
        out.sort(key=lambda p: (p.channel, p.sf, p.position))
        deduped: list[TriggeredPacket] = []
        for p in out:
            n = self.cfgs[p.sf].num_samples
            if deduped:
                q = deduped[-1]
                if (q.channel == p.channel and q.sf == p.sf
                        and abs(p.position - q.position) < 4 * n
                        and bytes(q.result.payload) == bytes(p.result.payload)):
                    continue
            deduped.append(p)
        deduped.sort(key=lambda p: (p.channel, p.position))
        return deduped
