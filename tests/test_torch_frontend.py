"""The port's RX front end (pipeline/frontend.py) against the JAX package's
on the same seeded inputs: the filter designs bit for bit; fir_filter,
polyphase_resample, resample_to_receiver_rate and upsample_to_capture_rate
within 1e-5 of the largest reference value (f32 sums in another order);
replay under tests/test_frontend.py's assertions."""

import numpy as np
import pytest

import jax.numpy as jnp

from gr_lora_tpu.pipeline import frontend as jfront
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.pipeline import frontend as front
from test_torch_core import config_pair

JCFG, CFG = config_pair(sf=8, cr=1, crc=True, ldr=False,
                        explicit_header=True, payload_len=8, p=2,
                        fft_factor=8, threshold=5.0)
PAYLOAD = bytes([1, 2, 3, 4, 5, 6])
PDU = "0630f0010203040506050801"
FS = 1e6
BW = 125e3
RTOL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def _noise(t, seed=0):
    return np.random.default_rng(seed).standard_normal((t, 2)) \
        .astype(np.float32)


@pytest.mark.parametrize("args", [
    (1.0, 1e6, 72.5e3, 1e3, "hamming"), (1.0, 1e6, 75e3, 10e3, "hamming"),
    (2.0, 8e6, 62.5e3, 20e3, "kaiser"), (1.0, 250e3, 50e3, 5e3, "blackman"),
    (1.0, 500e3, 70e3, 10e3, "hann"), (1.0, 500e3, 70e3, 10e3, "rect")])
def test_low_pass_design_bit_exact(args):
    *head, window = args
    a = front.design_low_pass(*head, window=window)
    assert a.dtype == np.float32
    assert np.array_equal(a, jfront.design_low_pass(*head, window=window))


@pytest.mark.parametrize("nfilts,rrate,atten", [
    (32, 0.25, 100.0), (32, 8.0, 100.0), (32, 0.5, 60.0), (16, 1.7, 40.0),
    (32, 0.37, 20.0)])
def test_pfb_prototype_bit_exact(nfilts, rrate, atten):
    assert np.array_equal(front.design_pfb_prototype(nfilts, rrate, atten),
                          jfront.design_pfb_prototype(nfilts, rrate, atten))


def test_low_pass_response():
    taps = front.design_low_pass(1.0, FS, 75e3, 10e3)
    w = np.fft.rfftfreq(8192, 1 / FS)
    h = np.abs(np.fft.rfft(taps, 8192))
    assert abs(h[0] - 1.0) < 1e-3                        # unity DC gain
    assert h[w < 60e3].min() > 0.98                      # passband flat
    assert h[w > 120e3].max() < 0.01                     # stopband down


@pytest.mark.parametrize("ntaps_args", [(1.0, FS, 72.5e3, 1e3),
                                        (1.0, FS, 75e3, 10e3)])
def test_fir_filter_matches_jax(ntaps_args):
    """rx_file's 3301 taps (even split of the asymmetric padding) and a
    short filter, on complex and on [T, 2] input."""
    x = _noise(12000)
    taps = front.design_low_pass(*ntaps_args)
    ref = jfront.fir_filter(jnp.asarray(x), taps)
    _close(front.fir_filter(x, taps, device="cpu"), ref)
    xc = x[:, 0] + 1j * x[:, 1]
    _close(front.fir_filter(xc, taps, device="cpu"), ref)


@pytest.mark.parametrize("rrate", [0.25, 8.0, 0.37, 1.6])
def test_polyphase_resample_matches_jax(rrate):
    x = _noise(6000, seed=1)
    ref = jfront.polyphase_resample(jnp.asarray(x), rrate)
    _close(front.polyphase_resample(x, rrate, device="cpu"), ref)


def test_polyphase_resample_chunked_equals_whole(monkeypatch):
    """Chunking over the outputs (the device-memory budget) changes
    nothing."""
    x = _noise(4000, seed=2)
    whole = front.polyphase_resample(x, 0.25, device="cpu")
    monkeypatch.setattr(front, "_RESAMPLE_CHUNK_BYTES", 1 << 16)
    assert np.array_equal(front.polyphase_resample(x, 0.25, device="cpu"),
                          whole)


def test_resample_to_receiver_rate_matches_jax():
    x = _noise(8000, seed=3)
    ref = jfront.resample_to_receiver_rate(jnp.asarray(x), FS, JCFG, BW)
    _close(front.resample_to_receiver_rate(x, FS, CFG, BW, device="cpu"),
           ref)


def test_resampler_tone_fidelity():
    """A complex tone survives 4x downsampling with correct frequency."""
    f0, rrate = 31e3, 0.25
    t = np.arange(65536) / FS
    x = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
    y = front.polyphase_resample(x, rrate, device="cpu").numpy()
    yc = (y[..., 0] + 1j * y[..., 1])[200:-200]          # trim edges
    spec = np.abs(np.fft.fft(yc * np.hanning(len(yc))))
    fpk = np.fft.fftfreq(len(yc), 1 / (FS * rrate))[np.argmax(spec)]
    assert abs(fpk - f0) < 50.0, fpk
    assert abs(np.abs(yc).mean() - 1.0) < 0.05


def test_upsample_to_capture_rate_matches_jax():
    iq1 = modulate(encode(PAYLOAD, CFG), CFG, p=1)
    got = front.upsample_to_capture_rate(iq1, 1, FS, CFG, BW, device="cpu")
    ref = jfront.upsample_to_capture_rate(iq1, 1, FS, JCFG, BW)
    assert got.dtype == ref.dtype
    _close(np.stack([got.real, got.imag], -1),
           np.stack([ref.real, ref.imag], -1))


def test_replay_single_packet_capture():
    """Fabricated 1 Msps capture -> LPF -> resample -> demod -> golden PDU
    (the rx_file.grc scenario end-to-end)."""
    iq1 = modulate(encode(PAYLOAD, CFG), CFG, p=1)      # 1 samp/chip = bw rate
    cap = front.upsample_to_capture_rate(iq1, 1, FS, CFG, BW, device="cpu")
    cap = (0.3 * cap).astype(np.complex64)
    results = front.replay(cap, FS, CFG, BW, mode="plain", device="cpu")
    pdus = [bytes(r.payload).hex() for _, r in results if r.ok]
    assert PDU in pdus, [(len(s), r.ok) for s, r in results]
    with pytest.raises(ValueError, match="unknown mode"):
        front.replay(cap, FS, CFG, BW, mode="weak", device="cpu")


def test_replay_collision_capture_pyramid():
    """Fabricated collision capture through the pyramid replay path: both
    packets with near-perfect symbol accuracy (the LPF + polyphase chain
    adds sub-bin wobble) and the weak packet's golden PDU byte-exact."""
    syms_a = encode(PAYLOAD, CFG)
    syms_b = encode(bytes([7] * 5), CFG)
    iq_a = modulate(syms_a, CFG, p=1)
    iq_b = modulate(syms_b, CFG, p=1)
    n1 = 1 << CFG.sf
    off = 19 * n1 + (5 * 37) % n1
    mix = np.zeros(off + len(iq_b) + 8 * n1, np.complex64)
    mix[: len(iq_a)] += 0.25 * iq_a
    mix[off: off + len(iq_b)] += 0.12 * iq_b
    cap = front.upsample_to_capture_rate(mix, 1, FS, CFG, BW, device="cpu")
    results = front.replay(cap, FS, CFG, BW, mode="pyramid", device="cpu")
    assert len(results) == 2, f"expected 2 packets, got {len(results)}"

    def accuracy(got, want):
        m = min(len(got), len(want))
        return np.mean(np.asarray(got[:m]) == np.asarray(want[:m]))

    accs = sorted(max(accuracy(s, syms_a), accuracy(s, syms_b))
                  for s, _ in results)
    assert all(a >= 16 / 18 for a in accs), accs
    pdus = {bytes(r.payload).hex() for _, r in results if r.ok}
    assert "053000" + "07" * 5 + "e76b01" in pdus, pdus
