"""RX front-end: low-pass FIR + polyphase arbitrary resampler + replay.

Port of gr_lora_tpu/pipeline/frontend.py.  Equivalent of the stock GNU
Radio chain every reference RX flowgraph wires before the demodulators
(examples/rx_file.grc: low_pass_filter with cutoff bw/2+10 kHz, width
1 kHz, then pfb_arb_resampler with rrate = 2*bw/samp_rate, nfilts=32,
atten=100):

- the filter designs are the JAX package's NumPy code, bit for bit;
- the FIR is one real-taps ``conv1d`` over the (re, im) pair, pinned to
  full float32 (cuDNN runs f32 convolutions in TF32 by default);
- the arbitrary resampler computes each output's window start, phase
  branch and interpolation weight in float64 on the device (the JAX
  package's host arithmetic), gathers the input windows there and takes
  one dot per output with the two adjacent phase branches, chunked over
  the outputs so the gathered windows stay within a fixed budget.

No kernel: the front end holds no ``pl.pallas_call``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LoraConfig
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..device import upload
from ..ops.cplx import f32_precision, from_ri

#: Bytes one chunk of resampler outputs may hold on the device: its two
#: gathered windows, their branch taps and indices, ~40 bytes a tap.
_RESAMPLE_CHUNK_BYTES = 256 << 20


# ---------------------------------------------------------------------------
# Filter design (host, numpy) — gr::filter::firdes equivalents.
# ---------------------------------------------------------------------------

def _window(kind: str, ntaps: int, beta: float = 6.76) -> np.ndarray:
    kind = kind.lower()
    if kind in ("rect", "rectangular"):
        return np.ones(ntaps)
    if kind == "hamming":
        return np.hamming(ntaps)
    if kind == "hann":
        return np.hanning(ntaps)
    if kind == "blackman":
        return np.blackman(ntaps)
    if kind == "kaiser":
        return np.kaiser(ntaps, beta)
    raise ValueError(f"unknown window {kind!r}")


def design_low_pass(gain: float, fs: float, cutoff: float, transition: float,
                    window: str = "hamming", beta: float = 6.76) -> np.ndarray:
    """firdes.low_pass: windowed-sinc taps, odd length from the transition
    width heuristic (gain at DC normalized)."""
    # GR heuristic: ntaps = 3.3 / (transition/fs) for hamming-class windows.
    ntaps = int(3.3 * fs / transition)
    ntaps |= 1  # odd
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1)
    taps = np.sinc(2 * cutoff / fs * n) * (2 * cutoff / fs)
    taps *= _window(window, ntaps, beta)
    return (gain * taps / taps.sum()).astype(np.float32)


def design_pfb_prototype(nfilts: int, rrate: float, atten: float = 100.0
                         ) -> np.ndarray:
    """Prototype low-pass for the polyphase arbitrary resampler
    (gr pfb_arb_resampler default: kaiser low-pass at the minimum of the
    input/output Nyquist rates, designed at nfilts x input rate)."""
    beta = 0.1102 * (atten - 8.7) if atten > 50 else (
        0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21) if atten >= 21
        else 0.0)
    cutoff = 0.5 * min(1.0, rrate)            # in input-rate units
    ntaps_per_branch = int(np.ceil((atten - 7.95) / (2.285 * 2 * np.pi
                                                     * 0.1 * cutoff)))
    ntaps = nfilts * max(ntaps_per_branch, 8)
    ntaps |= 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1)
    taps = np.sinc(cutoff / nfilts * n * 2) * (cutoff / nfilts * 2)
    taps *= np.kaiser(ntaps, beta)
    taps *= nfilts / taps.sum()
    return taps.astype(np.float32)


# ---------------------------------------------------------------------------
# Device stages.
# ---------------------------------------------------------------------------

def fir_filter(iq, taps: np.ndarray,
               device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """[T, 2] (or complex [T]) x real taps -> [T, 2] float32 on ``device``
    ('same' alignment; the demod FSM re-synchronizes, so group delay only
    shifts detection positions).

    The JAX package reverses the taps and correlates with padding
    (pad, ntaps - 1 - pad); ``conv1d`` also correlates but pads only
    symmetrically, so the asymmetric padding is applied first."""
    x = upload(iq, resolve_device(device)).reshape(-1, 2)
    ntaps = len(taps)
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(taps, np.float32)[::-1])).to(x.device)
    pad = (ntaps - 1) // 2
    xs = F.pad(x.T[:, None, :], (pad, ntaps - 1 - pad))    # [2, 1, T']
    with f32_precision():
        y = F.conv1d(xs, w[None, None, :])
    return y[:, 0, :].T.contiguous()


@lru_cache(maxsize=None)
def _pfb_bank(nfilts: int, rrate_q: float, atten: float):
    proto = design_pfb_prototype(nfilts, rrate_q, atten)
    per = int(np.ceil(len(proto) / nfilts))
    padded = np.zeros(per * nfilts, np.float32)
    padded[: len(proto)] = proto
    # branch j handles phase j/nfilts: taps_j[i] = proto[i*nfilts + j]
    bank = padded.reshape(per, nfilts).T             # [nfilts, per]
    return bank, per


def polyphase_resample(iq, rrate: float, nfilts: int = 32,
                       atten: float = 100.0,
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> torch.Tensor:
    """Arbitrary-rate polyphase resampler, [T, 2] -> [floor(T*rrate), 2]
    float32 on ``device``.

    Output k is taken at input time k/rrate: window dot branch(phase), with
    linear interpolation between the two adjacent phase branches.
    """
    bank, per = _pfb_bank(nfilts, float(round(rrate, 9)), atten)
    x = upload(iq, resolve_device(device)).reshape(-1, 2)
    dev = x.device
    t_in = x.shape[0]
    n_out = int(np.floor(t_in * rrate))
    # Window for output k: samples base+pad-per+1 .. base+pad (causal
    # taps); pad = per zeros each side (+1 for the carry).
    xp = F.pad(x.T, (per, per + 1)).T                # [T + 2 per + 1, 2]
    b = torch.from_numpy(np.ascontiguousarray(bank[:, ::-1])).to(dev)
    span = torch.arange(per, device=dev)
    out = torch.empty((n_out, 2), dtype=torch.float32, device=dev)
    chunk = max(_RESAMPLE_CHUNK_BYTES // (per * 40), 1)
    with f32_precision():
        for lo in range(0, n_out, chunk):
            sl = slice(lo, min(lo + chunk, n_out))
            # Window start, phase branches and weight in float64 (the JAX
            # package's host arithmetic): k / rrate in f32 drifts within
            # seconds.
            pos = torch.arange(sl.start, sl.stop, dtype=torch.float64,
                               device=dev) / rrate
            base = torch.floor(pos)
            phase = (pos - base) * nfilts
            j0 = torch.floor(phase)
            a = (phase - j0).float()[:, None]
            j0 = j0.long()
            j1 = (j0 + 1) % nfilts
            carry = (j0 + 1) // nfilts               # j1 wrap advances base
            win = (base.long() + 1)[:, None] + span[None, :]   # [k, per]
            w0 = xp[win]                             # [k, per, 2]
            w1 = xp[win + carry[:, None]]
            y0 = torch.einsum("kp,kpc->kc", b[j0], w0)
            y1 = torch.einsum("kp,kpc->kc", b[j1], w1)
            out[sl] = y0 * (1 - a) + y1 * a
    return out


def resample_to_receiver_rate(iq, fs: float, cfg: LoraConfig,
                              bw: float = 125e3, nfilts: int = 32,
                              device: str | torch.device = DEFAULT_DEVICE
                              ) -> torch.Tensor:
    """Capture rate fs -> demod rate p*bw (reference rrate = 2*bw/samp_rate)."""
    return polyphase_resample(iq, cfg.p * bw / fs, nfilts=nfilts,
                              device=device)


# ---------------------------------------------------------------------------
# Replay: full RX chain over a capture.
# ---------------------------------------------------------------------------

def replay(iq, fs: float, cfg: LoraConfig, bw: float = 125e3,
           mode: str = "plain", max_packets: int = 8,
           device: str | torch.device = DEFAULT_DEVICE):
    """Capture at rate fs -> [LPF -> resample -> demod -> decode] results,
    every stage on ``device``.

    Mirror of examples/rx_file.grc (mode='plain') and
    examples/rx_file_collision.grc (mode='pyramid').
    Returns list of (symbols, DecodeResult).
    """
    from ..core.codec import decode
    from ..models.demodulator import demodulate
    from ..models.pyramid import pyramid_demodulate

    if mode not in ("plain", "pyramid"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    taps = design_low_pass(1.0, fs, bw / 2 + 10e3, 1e3, window="hamming")
    filtered = fir_filter(iq, taps, dev)
    resampled = resample_to_receiver_rate(filtered, fs, cfg, bw, device=dev)
    if mode == "plain":
        pkts = demodulate(resampled, cfg, max_packets=max_packets,
                          device=dev)
    else:
        pkts = pyramid_demodulate(resampled, cfg, device=dev)
    return [(syms, decode(syms, cfg)) for syms in pkts]


def upsample_to_capture_rate(iq, p_tx: int, fs: float, cfg: LoraConfig,
                             bw: float = 125e3,
                             device: str | torch.device = DEFAULT_DEVICE
                             ) -> np.ndarray:
    """TX helper: modulator output at p_tx samples/chip -> capture rate fs
    as host complex64 (the tx_usrp.grc interpolating-resampler step); used
    to fabricate realistic file captures for replay tests."""
    rrate = fs / (p_tx * bw)
    out = polyphase_resample(iq, rrate, device=device)
    return from_ri(out.cpu().numpy())
