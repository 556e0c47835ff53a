"""The port's wideband channelizer (pipeline/channelizer.py) against the
JAX package's on the same seeded inputs, and twins of
tests/test_channelizer.py: packets on different RF channels of one
stream decode on their channels and nowhere else, the streaming
channelizer equals one whole-capture call, and the gateway CLI decodes
two packets on two channels and SFs of one capture.

Tolerance: ``channelize`` within 1e-5 of the largest reference value (one
f32 product summed in another order); at a sample offset past 2^31 also
within 1e-5 of a float64 NumPy evaluation of the same packed product and
phase (an f32 phase would be off by whole radians there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_lora_tpu.ops import cplx as jcplx
from gr_lora_tpu.pipeline import channelizer as jchan
from gr_lora_tpu_torch.ops import cplx
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models.demodulator import demodulate
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.pipeline.channelizer import (StreamingChannelizer,
                                                    _channelizer_plan,
                                                    channel_frequencies,
                                                    channelize)
from gr_lora_tpu_torch.pipeline.frontend import polyphase_resample
from test_torch_core import config_pair

JCFG, CFG = config_pair(sf=7, cr=1, crc=True, ldr=False,
                        explicit_header=True, payload_len=4, p=2,
                        fft_factor=4)
SPACING = 125e3
NCH = 8
FS_IN = NCH * SPACING          # 1 Msps wideband, 8 channels
RTOL = 1e-5


def _noise_ri(t, seed):
    return np.random.default_rng(seed).standard_normal((t, 2)) \
        .astype(np.float32)


def _f64_reference(x, num_channels, fs_in, sample_offset):
    """float64 NumPy evaluation of channelize's packed product and
    residual phase (from the same f32 weights)."""
    decim = int(round(fs_in / (CFG.p * SPACING)))
    packed, w, offs = _channelizer_plan(num_channels, decim, 16,
                                        SPACING / fs_in)
    m = (len(x) - w) // decim + 1
    idx = np.arange(m)[:, None] * decim + np.arange(w)[None, :]
    xp = np.concatenate([x[idx, 0], x[idx, 1]], axis=1).astype(np.float64)
    y = xp @ packed.astype(np.float64)
    y = y[:, :num_channels] + 1j * y[:, num_channels:]
    turns = (np.arange(m)[:, None] * decim + sample_offset) * offs[None, :]
    y = y * np.exp(-2j * np.pi * (turns - np.floor(turns)))
    return np.stack([y.real, y.imag], -1).transpose(1, 0, 2)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= RTOL * np.abs(ref).max(), err


@pytest.mark.parametrize("bf16", [False, True])
def test_cplx_products_match_jax(bf16):
    """ops/cplx's packed and four-matmul complex products against the JAX
    package's (bf16 operands with f32 accumulation when asked: within 1e-5
    of the peak, sums in another order), pack_cmatmul_weights and cmag2
    bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 40, 2)).astype(np.float32)
    wr, wi = (rng.standard_normal((40, 24)).astype(np.float32)
              for _ in range(2))
    packed = cplx.pack_cmatmul_weights(wr, wi)
    assert np.array_equal(packed, jcplx.pack_cmatmul_weights(wr, wi))
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    xt = torch.from_numpy(x)
    _close(cplx.cmatmul_packed(xt, packed, compute_dtype=td),
           jcplx.cmatmul_packed(jnp.asarray(x), jnp.asarray(packed),
                                compute_dtype=jd))
    _close(cplx.cmatmul(xt, wr, wi, compute_dtype=td),
           jcplx.cmatmul(jnp.asarray(x), jnp.asarray(wr), jnp.asarray(wi),
                         compute_dtype=jd))
    assert np.array_equal(cplx.cmag2(xt).numpy(),
                          np.asarray(jcplx.cmag2(jnp.asarray(x))))


@pytest.mark.parametrize("offset", [0, 12_345 * 8, (1 << 31) + 777 * 8])
def test_channelize_matches_jax(offset):
    x = _noise_ri(20_000, seed=offset % 97)
    got = channelize(x, NCH, FS_IN, SPACING, p=2, sample_offset=offset,
                     device="cpu")
    assert got.shape == (NCH, (20_000 - 129) // 4 + 1, 2)
    _close(got, jchan.channelize(jnp.asarray(x), NCH, FS_IN, SPACING, p=2,
                                 sample_offset=offset))
    if offset > 1 << 31:
        _close(got, _f64_reference(x, NCH, FS_IN, offset))


def test_channelize_complex_input_and_short_block():
    x = _noise_ri(3000, seed=4)
    xc = x[:, 0] + 1j * x[:, 1]
    assert np.array_equal(channelize(xc, NCH, FS_IN, device="cpu"),
                          channelize(x, NCH, FS_IN, device="cpu"))
    assert channelize(x[:100], NCH, FS_IN, device="cpu").shape == (NCH, 0, 2)
    with pytest.raises(ValueError, match="integer multiple"):
        channelize(x, NCH, 1.1e6, device="cpu")


def test_channel_frequencies():
    assert np.array_equal(channel_frequencies(NCH, SPACING),
                          jchan.channel_frequencies(NCH, SPACING))


def test_streaming_channelizer_matches_whole():
    """StreamingChannelizer fed irregular blocks reproduces the one-shot
    channelize output (filter history + phase continuity across block
    seams), and its flush drains the history."""
    total = 40_000
    ri = _noise_ri(total, seed=5)
    whole = channelize(ri, NCH, FS_IN, SPACING, p=CFG.p, device="cpu")

    sc = StreamingChannelizer(NCH, FS_IN, SPACING, p=CFG.p, device="cpu")
    outs = []
    lo = 0
    for size in (7, 1111, 5000, 13, 9000, total):   # irregular seams
        outs.append(sc.feed(ri[lo:lo + size]))
        lo += size
        if lo >= total:
            break
    streamed = np.concatenate([o.numpy() for o in outs], axis=1)
    assert sc.out_pos == streamed.shape[1]
    m = min(whole.shape[1], streamed.shape[1])
    np.testing.assert_allclose(streamed[:, :m], whole[:, :m].numpy(),
                               rtol=0, atol=1e-5)
    assert m >= whole.shape[1] - 1
    tail = sc.flush()
    assert tail.shape[0] == NCH and tail.shape[1] > 0


def _wideband(packets):
    """packets: list of (channel_index, payload, start_sym). Upconvert each
    TX to its channel offset at FS_IN and sum (tests/test_channelizer.py's
    fixture, on the port's resampler)."""
    freqs = channel_frequencies(NCH, SPACING)
    ratio = int(FS_IN / (CFG.p * SPACING))   # demod-rate -> wideband factor
    total = 0
    parts = []
    for ch, payload, start in packets:
        base = modulate(encode(payload, CFG), CFG, pad_front=0, pad_back=0)
        up_ri = polyphase_resample(np.stack([base.real, base.imag], -1),
                                   float(ratio), device="cpu").numpy()
        up = (up_ri[:, 0] + 1j * up_ri[:, 1]).astype(np.complex64)
        t0 = int(start * CFG.num_samples * ratio)
        t = (t0 + np.arange(len(up))) / FS_IN
        rf = up * np.exp(2j * np.pi * freqs[ch] * t)
        parts.append((t0, rf.astype(np.complex64)))
        total = max(total, t0 + len(rf))
    rng = np.random.default_rng(9)
    # A realistic noise floor: without it even -60 dB filter residue
    # "decodes" (LoRa's processing gain has no competing noise to beat).
    iq = (rng.standard_normal(total + 4096)
          + 1j * rng.standard_normal(total + 4096)).astype(np.complex64) * 3e-3
    for t0, rf in parts:
        iq[t0:t0 + len(rf)] += rf
    return iq


def _decode_channel(ch_iq):
    pkts = demodulate(np.ascontiguousarray(ch_iq), CFG, device="cpu")
    return [bytes(decode(s, CFG).payload) for s in pkts
            if decode(s, CFG).ok]


def test_two_channels_simultaneous():
    """Concurrent packets on two different RF channels both decode."""
    pay_a, pay_b = bytes([0x10, 0x20, 0x30, 0x40]), bytes([0x0A, 0x0B, 0x0C,
                                                           0x0D])
    iq = _wideband([(1, pay_a, 2), (5, pay_b, 4)])
    chans = channelize(iq, NCH, FS_IN, SPACING, p=CFG.p, device="cpu")
    assert any(pay_a == g[3:7] for g in _decode_channel(chans[1].numpy()))
    assert any(pay_b == g[3:7] for g in _decode_channel(chans[5].numpy()))


def test_channel_isolation():
    """A packet on channel 2 does not appear on channel 6."""
    iq = _wideband([(2, bytes([1, 2, 3, 4]), 2)])
    chans = channelize(iq, NCH, FS_IN, SPACING, p=CFG.p,
                       device="cpu").numpy()
    assert _decode_channel(chans[2])
    assert not _decode_channel(chans[6])
    # Adjacent-channel leakage is filtered well below the signal level.
    p_sig = np.mean(chans[2] ** 2)
    p_adj = np.mean(chans[3] ** 2)
    assert p_adj < 0.05 * p_sig, (p_sig, p_adj)


def test_gateway_app_wideband_multi_sf(tmp_path, capsys):
    """End-to-end gateway CLI (the FSM engine): two packets, different
    channels AND SFs, one wideband capture."""
    from gr_lora_tpu_torch.apps import gateway

    cfg9 = CFG.replace(sf=9)
    freqs = channel_frequencies(NCH, SPACING)
    ratio = int(FS_IN / (CFG.p * SPACING))

    def rf(cfg, payload, ch, t0):
        base = modulate(encode(payload, cfg), cfg, pad_front=0, pad_back=0)
        up = polyphase_resample(np.stack([base.real, base.imag], -1),
                                float(ratio), device="cpu").numpy()
        sig = (up[:, 0] + 1j * up[:, 1]).astype(np.complex64)
        t = (t0 + np.arange(len(sig))) / FS_IN
        return t0, sig * np.exp(2j * np.pi * freqs[ch] * t)

    parts = [rf(CFG, bytes([1, 2, 3, 4]), 1, 3000),
             rf(cfg9, bytes([5, 6, 7, 8]), 6, 9000)]
    total = max(t0 + len(s) for t0, s in parts) + 8192
    rng = np.random.default_rng(2)
    iq = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
          ).astype(np.complex64) * 3e-3
    for t0, s in parts:
        iq[t0:t0 + len(s)] += s.astype(np.complex64)

    cap = tmp_path / "wideband.cf64"
    iq.tofile(cap)
    rc = gateway.main([str(cap), "--samp-rate", str(FS_IN),
                       "--channels", str(NCH), "--sfs", "7,9",
                       "--fft-factor", "4", "--payload-len", "4"],
                      device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert "ch=1" in out and "sf=7" in out and "01 02 03 04" in out
    assert "ch=6" in out and "sf=9" in out and "05 06 07 08" in out
