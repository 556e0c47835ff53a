"""The port's weak-signal demodulator (models/weak) against the JAX one.

Fixtures are tests/test_weak.py's (SF8, fft_factor 8, the reference GRC
operating point), run under both ``weak_compensation`` policies at
``precision="highest"``.  The transmitter copies (``modulate_weak``,
``weak_packet_duration``) must equal the originals bit for bit; the
demodulators' symbols, lengths, counts and drop counters must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gr_lora_tpu.models import weak as jweak
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models import weak as tweak
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair


def _pair(**kw):
    base = dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=False,
                payload_len=6, p=2, fft_factor=8, weak_sym_num=12,
                precision="highest")
    base.update(kw)
    return config_pair(**base)


def _rng_syms(cfg, count, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.num_symbols, count).astype(np.uint16)


def _noisy(iq, snr_db, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (iq + sigma * (rng.standard_normal(len(iq))
                          + 1j * rng.standard_normal(len(iq)))
            ).astype(np.complex64)


@pytest.mark.parametrize("sf,p", [(7, 2), (8, 2), (8, 4), (10, 2)])
def test_modulate_weak_and_duration_bit_for_bit(sf, p):
    jcfg, cfg = _pair(sf=sf, p=p)
    for sym_num in (1, 2, 3, 8, 13):
        syms = _rng_syms(cfg, sym_num, seed=sym_num)
        a = tweak.modulate_weak(syms, cfg)
        b = jweak.modulate_weak(syms, jcfg)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(
            tweak.modulate_weak(syms, cfg, p=1, pad_front=0, pad_back=7),
            jweak.modulate_weak(syms, jcfg, p=1, pad_front=0, pad_back=7))
        assert tweak.weak_packet_duration(sym_num, cfg) \
            == jweak.weak_packet_duration(sym_num, jcfg)
        assert tweak.weak_packet_duration(sym_num, cfg, p=1) \
            == jweak.weak_packet_duration(sym_num, jcfg, p=1)


def _fixture(name, cfg):
    """tests/test_weak.py's clean, LDR and noisy-exact waveforms."""
    if name == "clean":
        return _rng_syms(cfg, cfg.weak_sym_num), \
            lambda s: tweak.modulate_weak(s, cfg)
    if name == "ldr":
        syms = ((_rng_syms(cfg, cfg.weak_sym_num) & ~np.uint16(3)) + 1) \
            .astype(np.uint16)
        return syms, lambda s: tweak.modulate_weak(s, cfg)
    syms = _rng_syms(cfg, cfg.weak_sym_num, seed=5)
    return syms, lambda s: _noisy(tweak.modulate_weak(s, cfg), -8.0, 7)


def _run_both(jcfg, cfg, iq, mp=4):
    t = iq.shape[-2]
    jfn = jweak.weak_demod_fn(jcfg, t, mp)
    jfn = jax.jit(jax.vmap(jfn) if iq.ndim == 3 else jfn)
    ref = [np.asarray(x) for x in jax.device_get(jfn(jnp.asarray(iq)))]
    out = [x.numpy() for x in tweak.weak_demod_fn(cfg, t, mp, device="cpu")(
        torch.from_numpy(iq))]
    for a, b in zip(ref, out):
        assert a.shape == b.shape
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    return out


@pytest.mark.parametrize("policy", ["reference", "ldr-only"])
@pytest.mark.parametrize("name", ["clean", "ldr", "noisy_exact"])
def test_weak_demod_fn_matches_jax(name, policy):
    kw = dict(weak_compensation=policy)
    if name == "ldr":
        kw.update(ldr=True, weak_sym_num=10)
    jcfg, cfg = _pair(**kw)
    syms, make = _fixture(name, cfg)
    iq = to_ri(make(syms))
    out = _run_both(jcfg, cfg, iq)
    assert int(out[2]) == 1
    assert np.array_equal(out[0][0, :out[1][0]], syms)
    got = tweak.weak_demodulate(iq, cfg, device="cpu")
    assert [g.dtype for g in got] == [np.uint16]
    assert np.array_equal(got[0], syms)


def test_weak_lanes_and_slot_overflow():
    """Two lanes finishing at different steps, and three packets in two
    slots (dropped 1), against the JAX package's vmapped weak demod."""
    jcfg, cfg = _pair(weak_sym_num=6)
    n = cfg.num_samples
    pkts = [tweak.modulate_weak(_rng_syms(cfg, 6, seed=s), cfg)
            for s in (1, 2, 3)]
    stream = to_ri(np.concatenate(pkts))
    one = to_ri(np.concatenate([np.zeros(5 * n + 33, np.complex64),
                                pkts[0]]))
    iq = np.zeros((2, len(stream), 2), np.float32)
    iq[0] = stream
    iq[1, :len(one)] = one
    out = _run_both(jcfg, cfg, iq, mp=2)
    assert out[2].tolist() == [2, 1] and out[3].tolist() == [1, 0]


def test_streaming_weak_matches_jax():
    """tests/test_weak.py's streaming fixture: three packets with gaps and
    light noise, fed in 13 000-sample chunks through 20 000-sample
    blocks."""
    jcfg, cfg = _pair(weak_sym_num=12)
    rng = np.random.default_rng(3)
    chunks, wanted = [], []
    for t in range(3):
        syms = _rng_syms(cfg, cfg.weak_sym_num, seed=40 + t)
        wanted.append(syms)
        chunks.append(tweak.modulate_weak(syms, cfg))
        chunks.append(np.zeros(int(rng.integers(1000, 4000)), np.complex64))
    iq = np.concatenate(chunks).astype(np.complex64)
    iq += 0.01 * (rng.standard_normal(len(iq))
                  + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    ri = to_ri(iq)
    ref_sd = jweak.StreamingWeakDemodulator(jcfg, block_len=20000)
    sd = tweak.StreamingWeakDemodulator(cfg, block_len=20000, device="cpu")
    got = []
    for i in range(0, len(ri), 13000):
        ref, out = ref_sd.feed(ri[i:i + 13000]), sd.feed(ri[i:i + 13000])
        assert [o.tolist() for o in out] == [r.tolist() for r in ref]
        got += out
    ref, out = ref_sd.flush(), sd.flush()
    assert [o.tolist() for o in out] == [r.tolist() for r in ref]
    got += out
    assert sd.dropped == ref_sd.dropped == 0
    assert [g.tolist() for g in got] == [w.tolist() for w in wanted]


def test_weak_chain_to_bytes():
    """encode -> weak TX -> the port's weak demod -> decode, byte-exact
    (tests/test_weak.py's chain at cr 1)."""
    payload = bytes([0x11, 0x22, 0x33, 0x44, 0x55])
    _, base = _pair(payload_len=len(payload))
    cfg = base.replace(weak_sym_num=base.packet_symbol_len())
    pkts = tweak.weak_demodulate(
        tweak.modulate_weak(encode(payload, cfg), cfg), cfg, device="cpu")
    res = decode(pkts[0], cfg)
    assert len(pkts) == 1 and res.ok and res.crc_ok
    assert bytes(res.payload[:len(payload)]) == payload
