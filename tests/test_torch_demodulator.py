"""The port's demodulator FSM (models/demodulator) against the JAX one.

Fixtures are tests/test_loopback.py's and tests/test_overflow.py's, built
with the port's modulator and codec (equal to the JAX package's bit for
bit, tests/test_torch_twins.py).  The same numpy inputs go through the
JAX ``demod_fn`` (jitted, vmapped where batched) and the port's, at
``precision="highest"``.  Counts, lengths, positions, symbols and drop
counters must be equal; the SNR proxy passes through the dechirp
transform (an f32 FFT here, f32 matmuls there) and a mean, so it is held
within rtol 1e-4.  The compensation integrator and the header parse are
held equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_lora_tpu.models import demodulator as jdemod
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models import demodulator as tdemod
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair

CPU = torch.device("cpu")


def _pair(**kw):
    kw.setdefault("precision", "highest")
    return config_pair(**kw)


def _run_both(jcfg, cfg, iq, mp=8):
    """(JAX outputs, port outputs) of demod_fn on iq [T, 2] or [L, T, 2],
    as numpy arrays: (syms, lens, pos, cnt, dropped, snr)."""
    t = iq.shape[-2]
    jfn = jdemod.demod_fn(jcfg, t, mp)
    jfn = jax.jit(jax.vmap(jfn) if iq.ndim == 3 else jfn)
    ref = [np.asarray(x) for x in jax.device_get(jfn(jnp.asarray(iq)))]
    out = [x.numpy() for x in
           tdemod.demod_fn(cfg, t, mp, device="cpu")(torch.from_numpy(iq))]
    return ref, out


def _assert_same(ref, out):
    names = ("syms", "lens", "pos", "cnt", "dropped", "snr")
    for name, a, b in zip(names, ref, out):
        assert a.shape == b.shape, name
        if name == "snr":
            np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=name)
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                (name, a, b)


def _packet(cfg, payload, **kw):
    return to_ri(modulate(encode(payload, cfg), cfg, **kw))


def _awgn(iq, snr_db, seed):
    """tests/test_loopback.py's loopback noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    c = iq[:, 0] + 1j * iq[:, 1]
    npow = 10.0 ** (-snr_db / 10.0)
    noise = rng.standard_normal(len(c)) + 1j * rng.standard_normal(len(c))
    return to_ri((c + np.sqrt(npow / 2) * noise).astype(np.complex64))


README = dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=True, p=2,
              fft_factor=2)
TIGHT = dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
             payload_len=4, p=2, fft_factor=8)


def _fixture(name):
    """(config kwargs, iq [T, 2]) of each test_loopback.py fixture."""
    if name == "readme_explicit":
        _, c = _pair(**README)
        return README, _packet(c, bytes([1, 2, 3, 4, 5, 6]))
    if name == "implicit_ldr":
        kw = dict(sf=8, cr=4, crc=True, ldr=True, explicit_header=False,
                  payload_len=8, p=2, fft_factor=2)
        _, c = _pair(**kw)
        return kw, _packet(c, bytes(range(8)))
    if name in ("sf7", "sf9"):
        sf = int(name[2:])
        kw = dict(sf=sf, cr=2, crc=True, ldr=False, explicit_header=False,
                  payload_len=12, p=2, fft_factor=2)
        _, c = _pair(**kw)
        return kw, _packet(c, bytes((3 * i + 1) % 256 for i in range(12)))
    if name == "p4":
        kw = dict(README, p=4)
        _, c = _pair(**kw)
        return kw, _packet(c, bytes([0xDE, 0xAD, 0xBE, 0xEF]))
    if name == "awgn":
        _, c = _pair(**README)
        return README, _awgn(_packet(c, bytes([1, 2, 3, 4, 5, 6])), 10.0, 0)
    if name == "back_to_back":
        _, c = _pair(**TIGHT)
        n = c.num_samples
        pkt = _packet(c, bytes([5, 6, 7, 8]), pad_front=0, pad_back=0)
        z = lambda k: np.zeros((k * n, 2), np.float32)  # noqa: E731
        return TIGHT, np.concatenate([z(2), pkt, z(8), pkt, z(6)])
    if name == "stream_start":
        _, c = _pair(**TIGHT)
        return TIGHT, _packet(c, bytes([1, 1, 2, 2]), pad_front=0)
    raise KeyError(name)


LOOPBACK = ["readme_explicit", "implicit_ldr", "sf7", "sf9", "p4", "awgn",
            "back_to_back", "stream_start"]


@pytest.mark.parametrize("name", LOOPBACK)
def test_demod_fn_matches_jax_on_loopback_fixtures(name):
    kw, iq = _fixture(name)
    jcfg, cfg = _pair(**kw)
    ref, out = _run_both(jcfg, cfg, iq)
    _assert_same(ref, out)
    assert int(out[3]) >= 1
    assert decode(out[0][0, :out[1][0]].astype(np.uint16), cfg).ok


OVERFLOW = dict(sf=7, cr=1, crc=False, ldr=False, explicit_header=False,
                payload_len=2, p=2, fft_factor=2)


def _overflow_stream(cfg, num_pkts):
    """tests/test_overflow.py's _stream: packets 4 symbols apart."""
    pkt = _packet(cfg, bytes([1, 2]), pad_front=0, pad_back=0)
    gap = np.zeros((4 * cfg.num_samples, 2), np.float32)
    return np.concatenate([x for _ in range(num_pkts) for x in (pkt, gap)])


@pytest.mark.parametrize("mp,num_pkts", [(1, 3), (2, 4), (8, 3)])
def test_demod_fn_slot_overflow_matches_jax(mp, num_pkts):
    jcfg, cfg = _pair(**OVERFLOW)
    iq = _overflow_stream(cfg, num_pkts)
    ref, out = _run_both(jcfg, cfg, iq, mp)
    _assert_same(ref, out)
    assert int(out[3]) == min(mp, num_pkts)
    assert int(out[4]) == max(num_pkts - mp, 0)


def test_three_lanes_equal_three_single_lane_calls():
    """Lanes finish at different steps (different packet lengths and
    offsets); each lane's result equals its own one-lane call and the JAX
    package's vmapped one."""
    kw = dict(sf=7, cr=1, crc=True, ldr=False, explicit_header=True, p=2,
              fft_factor=2)
    jcfg, cfg = _pair(**kw)
    n = cfg.num_samples
    lanes = []
    for i, payload in enumerate([bytes([9]), bytes(range(20)),
                                 bytes([3, 1, 4, 1, 5])]):
        pkt = _packet(cfg, payload, pad_front=(3 + 5 * i) * n + 17 * i,
                      pad_back=0)
        lanes.append(pkt)
    t = max(len(x) for x in lanes) + 2 * n
    iq = np.zeros((3, t, 2), np.float32)
    for i, x in enumerate(lanes):
        iq[i, :len(x)] = x
    ref, out = _run_both(jcfg, cfg, iq)
    _assert_same(ref, out)
    fn = tdemod.demod_fn(cfg, t, 8, device="cpu")
    for i in range(3):
        single = [x.numpy() for x in fn(torch.from_numpy(iq[i]))]
        _assert_same([x[i] for x in out], single)
        assert int(single[3]) == 1


@pytest.mark.parametrize("slack,count", [(-0.5, 0), (0.0, 0), (0.21, 0),
                                         (1.0, 1)])
def test_packet_ending_at_buffer_end(slack, count):
    """A packet ending ``slack`` symbols before the buffer's end (cut
    inside its last symbol where negative): the windows at the end are
    clamped into the buffer as dynamic_slice clamps them, and the FSM
    emits the packet only when about a symbol follows it (it reaches
    S_OUT a step after the last symbol), in both packages alike."""
    jcfg, cfg = _pair(**README)
    pkt = _packet(cfg, bytes([1, 2, 3, 4, 5, 6]), pad_back=0)
    end = len(pkt) + int(slack * cfg.num_samples)
    iq = np.zeros((max(end, len(pkt)), 2), np.float32)
    iq[:len(pkt)] = pkt
    ref, out = _run_both(jcfg, cfg, iq[:end])
    _assert_same(ref, out)
    assert int(out[3]) == count


@pytest.mark.parametrize("ldr", [False, True])
@pytest.mark.parametrize("ff", [1, 2, 8])
def test_dynamic_compensation_bit_for_bit(ldr, ff):
    """Random symbol vectors in the FSM's domain (multiples of
    1 / fft_factor in [0, 2^sf)), every count: the cumsum equals the JAX
    scan bit for bit."""
    jcfg, cfg = _pair(sf=8, ldr=ldr, fft_factor=ff)
    rng = np.random.default_rng(ff + 10 * ldr)
    ms = 40
    for trial in range(4):
        syms = (rng.integers(0, cfg.num_symbols * ff, ms) / ff) \
            .astype(np.float32)
        if trial == 3:      # a slow drift across the wrap
            syms = ((np.arange(ms) * 0.75 + 250) % 256).astype(np.float32)
        for count in (0, 1, 8, 17, ms):
            ref = np.asarray(jdemod._dynamic_compensation(
                jnp.asarray(syms), jnp.int32(count), jcfg))
            out = tdemod._dynamic_compensation(
                torch.from_numpy(syms), torch.tensor(count, dtype=torch.int32),
                cfg).numpy()
            assert np.array_equal(ref.astype(np.int64), out), (count, trial)
        out8 = tdemod._dynamic_compensation(torch.from_numpy(syms[None, :8]),
                                            8, cfg).numpy()[0]
        ref8 = np.asarray(jdemod._dynamic_compensation(
            jnp.asarray(syms), jnp.int32(8), jcfg))[:8]
        assert np.array_equal(ref8.astype(np.int64), out8)


@pytest.mark.parametrize("sf,ldr", [(7, False), (8, False), (8, True),
                                    (10, False), (12, True)])
def test_parse_header_bit_for_bit(sf, ldr):
    """Real headers (every cr, crc on / off, lengths 0..255) and random
    8-symbol vectors, most of them with bad checksums."""
    jcfg, cfg = _pair(sf=sf, ldr=ldr, explicit_header=True)
    rng = np.random.default_rng(sf)
    vecs = [rng.integers(0, cfg.num_symbols, 8) for _ in range(24)]
    for cr in range(1, 5):
        for plen, crc in ((0, True), (5, False), (77, True), (255, True)):
            c = cfg.replace(cr=cr, crc=crc)
            vecs.append(encode(bytes(plen), c)[:8])
    comp8 = np.stack(vecs).astype(np.int32)
    out = [x.numpy() for x in
           tdemod._parse_header(torch.from_numpy(comp8), cfg)]
    ref = [np.asarray(x) for x in jax.vmap(
        lambda v: jdemod._parse_header_jnp(v, jcfg))(jnp.asarray(comp8))]
    for a, b in zip(ref, out):
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    assert out[0][24:].all() and not out[0][:24].all()


def test_header_checksum_bit_for_bit():
    length, cr_crc = np.meshgrid(np.arange(256), np.arange(16),
                                 indexing="ij")
    length = length.ravel().astype(np.int32)
    cr_crc = cr_crc.ravel().astype(np.int32)
    ref = np.asarray(jdemod._header_checksum_jnp(jnp.asarray(length),
                                                 jnp.asarray(cr_crc)))
    out = tdemod._header_checksum(torch.from_numpy(length),
                                  torch.from_numpy(cr_crc)).numpy()
    assert np.array_equal(ref, out)


@pytest.mark.parametrize("sf", range(7, 13))
def test_max_packet_symbols_and_snr_estimate(sf):
    for explicit in (False, True):
        for cr in (1, 4):
            kw = dict(sf=sf, cr=cr, ldr=sf >= 11, explicit_header=explicit,
                      payload_len=3 * sf, p=2, fft_factor=2)
            jcfg, cfg = _pair(**kw)
            assert tdemod.max_packet_symbols(cfg) \
                == jdemod.max_packet_symbols(jcfg)
            assert tdemod.stream_tail_len(cfg) == jdemod.stream_tail_len(jcfg)
    jcfg, cfg = _pair(sf=sf, p=2)
    ratios = np.array([0.0, 1e-13, 0.5, 3.0, 40.0, 1e4], np.float32)
    assert np.array_equal(tdemod.snr_db_estimate(ratios, cfg),
                          jdemod.snr_db_estimate(ratios, jcfg))
    assert tdemod.snr_db_estimate(7.0, cfg) \
        == jdemod.snr_db_estimate(7.0, jcfg)


def test_demodulate_and_make_demodulator():
    """The host API: uint16 symbol arrays equal to the JAX package's."""
    kw, iq = _fixture("back_to_back")
    jcfg, cfg = _pair(**kw)
    ref = jdemod.demodulate(iq, jcfg)
    c = iq[:, 0] + 1j * iq[:, 1]
    for x in (iq, c.astype(np.complex64)):
        out = tdemod.demodulate(x, cfg, device="cpu")
        assert [o.dtype for o in out] == [np.uint16] * len(ref) == \
            [r.dtype for r in ref]
        assert [o.tolist() for o in out] == [r.tolist() for r in ref]
    assert tdemod.make_demodulator(cfg, iq.shape[0], device="cpu") \
        is tdemod.demod_fn(cfg, iq.shape[0], 8, device="cpu")
