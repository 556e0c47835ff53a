"""The traffic generator: fixed work for every seed, the program's own
encoding and modulation, air that a plain receiver reads back.

    python -m pytest lorabench/tests -q
"""

import numpy as np
import pytest
import torch

from lorabench.reference import lora as ref_lora
from lorabench.traffic import air

LORA = {"p": 2, "cr": 1}
SFS = [7, 8, 9, 10, 11, 12]
SEEDS = (3, 2**31 + 12345, 2**40 + 7)


def _plan(name, seed, index=0, channels=64, traffic=None):
    return air.plan_feed(traffic or air.load(name), LORA, channels, SFS,
                         125e3, seed, index)


@pytest.mark.parametrize("name", ["collide", "sparse"])
def test_every_seed_gives_the_same_work(name):
    plans = [_plan(name, s) for s in SEEDS]
    shape = [[(p.channel, p.sf, p.length, len(p.payload), p.amplitude,
               p.collides) for p in plan] for plan in plans]
    assert shape[0] == shape[1] == shape[2]
    for field in ("start", "payload"):
        drawn = [[getattr(p, field) for p in plan] for plan in plans]
        assert drawn[0] != drawn[1] != drawn[2] != drawn[0]
    assert len(plans[0]) == {"collide": 192, "sparse": 64}[name]
    assert sum(p.collides for p in plans[0]) == \
        {"collide": 128, "sparse": 0}[name]


def test_pairs_keep_their_delay_and_fit_the_feed():
    t = air.load("collide")["samples_per_feed"]
    for seed in SEEDS:
        plan = _plan("collide", seed)
        for c in range(64):
            strong, weak = [p for p in plan if p.channel == c and p.collides]
            assert weak.start - strong.start == int(16.5 * 512) + 204
        assert all(0 <= p.start and p.start + p.length < t for p in plan)


def test_seeded_payloads_and_noise_differ_by_seed():
    traffic = {"samples_per_feed": 1 << 15, "pool_feeds": 1,
               "noise_sigma": 0.003,
               "packets": [{"id": "a", "sf": 7, "amplitude": 0.2,
                            "payload_bytes": 5, "slot": [0.0, 1.0]}]}
    a = _plan(None, 1, channels=2, traffic=traffic)
    b = _plan(None, 2, channels=2, traffic=traffic)
    assert [len(p.payload) for p in a] == [len(p.payload) for p in b] == [5, 5]
    assert [p.payload for p in a] != [p.payload for p in b]
    fa = air.make_feed(traffic, LORA, a, 2, 125e3, 1, 0, "cpu")
    fb = air.make_feed(traffic, LORA, b, 2, 125e3, 2, 0, "cpu")
    again = air.make_feed(traffic, LORA, a, 2, 125e3, 1, 0, "cpu")
    assert torch.equal(fa, again) and not torch.equal(fa, fb)


@pytest.mark.parametrize("sf", SFS)
def test_encoder_and_modulator_equal_the_programs(sf):
    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate

    ldr = (1 << sf) / 125e3 > 16e-3
    cfg = LoraConfig(sf=sf, cr=1, crc=True, ldr=ldr, explicit_header=True,
                     payload_len=8, p=2, fft_factor=8, threshold=5.0)
    rng = np.random.default_rng(sf)
    for size in (4, 5, 6, 16):
        payload = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        syms = air.encode(payload, sf, 1, ldr)
        assert np.array_equal(syms, encode(payload, cfg).astype(np.int64))
        wave = air.waveform(syms, sf, 2, 0.2, "cpu").numpy()
        want = 0.2 * modulate(encode(payload, cfg), cfg, pad_front=0,
                              pad_back=0)
        assert len(wave) == air.packet_length(size, sf, 2, 1, ldr)
        assert np.abs(wave - np.stack([want.real, want.imag], -1)).max() \
            < 1e-6


@pytest.mark.parametrize("name", ["collide", "sparse"])
def test_the_reference_reads_the_generators_packets(name):
    """A small feed (2 channels, SF7-8): the plain receiver reads every
    packet but the weaker of a pair back from the air, byte for byte."""
    traffic = dict(air.load(name), samples_per_feed=1 << 17)
    plan = air.plan_feed(traffic, LORA, 2, [7, 8], 125e3, 99, 0)
    iq = air.make_feed(traffic, LORA, plan, 2, 125e3, 99, 0, "cpu")
    read = 0
    for p in plan:
        if p.collides and p.amplitude < 0.15:
            continue
        count = air.num_symbols(len(p.payload), p.sf, 1, True, False)
        bins = ref_lora.demod_bins(iq[p.channel], p.start, count, p.sf, 2)
        assert ref_lora.decode(bins, p.sf, 1, False) == (p.payload, True)
        read += 1
    assert read == {"collide": 4, "sparse": 2}[name]
