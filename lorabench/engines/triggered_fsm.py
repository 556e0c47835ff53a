"""Entry module: the triggered multi-SF FSM receiver,
``gr_lora_tpu_torch.dist.triggered.TriggeredReceiver.__call__``.

Each call takes one self-contained capture: the preamble scan of every SF,
then one batched FSM demodulation a SF over the event windows.  The feed
is handed over as a pinned CPU tensor: the receiver's upload
(``device.upload``) copies a tensor straight to the card, where a host
array would first be copied once more into a fresh pinned buffer.

The check compares every packet's detection ratio (``snr_ratio``: peak
over mean of the folded up-chirp spectrum of the window at its position)
with the reference's, computed from the pool's own samples.
"""

from __future__ import annotations

import torch

from ..reference import compare, spectra

FEED_AS = "tensor"
#: The FSM is no collision decoder: only the packets that collide with
#: none are owed.
NEED_COLLISIONS = False
TRACE_SECONDS = 2.0


class Engine:
    def __init__(self, config: dict, device):
        from gr_lora_tpu_torch import LoraConfig
        from gr_lora_tpu_torch.config import PeakSearch
        from gr_lora_tpu_torch.dist.triggered import TriggeredReceiver

        lora = dict(config["lora"], peak_search=PeakSearch(
            config["lora"]["peak_search"]))
        self.lora = config["lora"]
        self.rx = TriggeredReceiver(LoraConfig(**lora),
                                    sfs=tuple(config["sfs"]),
                                    bw=config["bw"], device=device,
                                    **config["receiver"])
        self.captures: list = []

    def warm(self, feed):
        return self.rx(feed)

    def attach(self, seed: int, traced: bool) -> None:
        """Nothing to hook: the receiver keeps no state between calls."""

    def feed(self, feed):
        return self.rx(feed)

    def drain(self):
        """Nothing held back: each call returns all its packets."""
        return []

    def pdus(self, outs, call: int, samples_per_feed: int) -> list:
        """The good-CRC PDUs of a call, at its place in the stream of
        calls; the packets' detection ratios are kept for the check."""
        out = []
        for pk in outs:
            if not pk.result.crc_ok:
                continue
            size = pk.result.header.payload_len
            out.append(compare.Pdu(call * samples_per_feed + int(pk.position),
                                   int(pk.channel), int(pk.sf),
                                   bytes(pk.result.payload[3:3 + size])))
            self.captures.append((call, int(pk.channel), int(pk.sf),
                                  int(pk.position), float(pk.snr_ratio)))
        return out

    def release(self) -> None:
        del self.rx

    def numbers(self, run, control: dict | None = None) -> dict:
        """``snr_gap``: the widest relative gap of the detection ratios to
        the reference's; with ``control`` ({"snr": precision}), of the
        reference at that precision in the program's place."""
        precision = control["snr"] if control else "f64"
        p, ff = self.lora["p"], self.lora["fft_factor"]
        worst = 0.0
        for sf in sorted({c[2] for c in self.captures}):
            rows = [c for c in self.captures if c[2] == sf]
            n = p << sf
            wins = torch.stack([_window(run.pool[call % len(run.pool)], ch,
                                        pos, n) for call, ch, _, pos, _ in
                                rows]).to(run.check_device)
            ref = spectra.peak_to_mean(wins, sf, p, ff)
            if precision == "f64":
                got = torch.tensor([r[4] for r in rows], dtype=torch.float64,
                                   device=ref.device)
            else:
                got = spectra.peak_to_mean(wins, sf, p, ff, precision)
            worst = max(worst, compare.snr_gap(got, ref))
        return {"snr_gap": worst}


def _window(feed: torch.Tensor, channel: int, start: int, n: int):
    """feed[channel, start:start + n] (float [T, 2]), zero outside it."""
    t = feed.shape[1]
    out = torch.zeros((n, 2), dtype=torch.float32)
    lo, hi = max(start, 0), min(start + n, t)
    if hi > lo:
        out[lo - start:hi - start] = feed[channel, lo:hi]
    return out
