"""The port's NumPy twins and plan constants equal the JAX package's own.

gr_lora_tpu_torch keeps its own copies of the NumPy code that sits behind
JAX imports (chirp tables, the modulator, the overlap plan constants) and
builds every kernel's plan constants itself; these tests pin each one
equal to the original, so both packages compute from the same numbers.
"""

import io
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxGateway
from gr_lora_tpu.dist.pyramid_gateway import _pack_peaks as jax_pack_peaks
from gr_lora_tpu.models import modulator as jmod
from gr_lora_tpu.ops import chirp as jchirp
from gr_lora_tpu.ops import overlap_dft as jov
from gr_lora_tpu.ops import pallas_rdft as jrdft
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import _pack_peaks, _unpack_peaks
from gr_lora_tpu_torch.dist.triggered import make_preamble_scan
from gr_lora_tpu_torch.models import modulator as tmod
from gr_lora_tpu_torch.ops import chirp as tchirp
from gr_lora_tpu_torch.ops.overlap_dft import OverlapPlan
from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra
from test_torch_core import config_pair, same_fields

GRID = [(sf, p) for sf in range(7, 13) for p in (2, 8)]


def _cfg(sf, p=2, ff=8):
    """(JAX config, port config)."""
    return config_pair(sf=sf, cr=1, crc=True, ldr=(1 << sf) / 125e3 > 16e-3,
                       explicit_header=True, payload_len=8, p=p,
                       fft_factor=ff, threshold=5.0)


@pytest.mark.parametrize("sf,p", GRID)
def test_chirp_tables_and_symbol_chirp(sf, p):
    for a, b in zip(tchirp.chirp_tables(sf, p), jchirp.chirp_tables(sf, p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for sym in (0, 1, (1 << sf) - 1, 37 % (1 << sf)):
        assert np.array_equal(tchirp.symbol_chirp(sym, sf, p),
                              jchirp.symbol_chirp(sym, sf, p))


@pytest.mark.parametrize("sf", range(6, 13))
def test_mod_reference_tables(sf):
    """The accumulator-form modulator tables: the same values and dtype."""
    ours = tchirp.mod_reference_tables(sf)
    for a, b in zip(ours, jchirp.mod_reference_tables(sf)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("start", [0, 7, 100])
def test_frame_signal_start(start):
    """frame_signal(start=) against the JAX function, in range (the JAX
    gather clamps past the end, the port zero-pads: no frame reaches it
    here)."""
    from gr_lora_tpu.ops.dechirp import frame_signal as jframe
    from gr_lora_tpu_torch.ops.dechirp import frame_signal as tframe

    iq = np.random.default_rng(start).standard_normal((1000, 2)) \
        .astype(np.float32)
    ours = tframe(torch.from_numpy(iq), 64, 8, 100, start=start)
    ref = np.asarray(jframe(jnp.asarray(iq), 64, 8, 100, start=start))
    assert np.array_equal(ours.numpy(), ref)
    if start:
        assert torch.equal(ours, tframe(torch.from_numpy(iq[start:]), 64, 8,
                                        100))


@pytest.mark.parametrize("sf,p", GRID)
def test_modulate_and_packet_duration(sf, p):
    jcfg, cfg = _cfg(sf, p)
    syms = np.random.default_rng(sf * 10 + p).integers(0, 1 << sf, 9)
    a = tmod.modulate(syms, cfg)
    b = jmod.modulate(syms, jcfg)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tmod.modulate(syms, cfg, pad_front=0, pad_back=0),
                          jmod.modulate(syms, jcfg, pad_front=0, pad_back=0))
    for ns in (0, 9, 40):
        assert tmod.packet_duration(ns, cfg) == jmod.packet_duration(ns,
                                                                     jcfg)
    assert tmod.NUM_PREAMBLE_CHIRPS == jmod.NUM_PREAMBLE_CHIRPS


@pytest.mark.parametrize("sf,ff", [(7, 2), (7, 8), (8, 8), (9, 8)])
def test_rdft_plan_constants(sf, ff):
    jcfg, cfg = _cfg(sf, ff=ff)
    mod = RdftSpectra(cfg, 8)
    ref_w = np.asarray(jrdft._rdft_weights(jcfg))
    assert mod.w.dtype == torch.bfloat16 and mod.w.shape == ref_w.shape
    assert np.array_equal(mod.w.view(torch.int16).numpy().view(np.uint16),
                          ref_w.view(np.uint16))
    assert np.array_equal(mod.consts.numpy(), np.asarray(jrdft._consts(jcfg)))


@pytest.mark.parametrize("sf,p,ff", [(9, 2, 8), (10, 2, 8), (12, 2, 8),
                                     (8, 8, 2)])
def test_overlap_plan_constants(sf, p, ff):
    ref = jov.overlap_plan(sf, p, ff, 25.0)
    plan = OverlapPlan(sf, p, ff, 25.0)
    assert np.array_equal(plan.rho.numpy(), ref.rho)
    assert plan.sigma_list == ref.sigma
    assert plan.sigma.tolist() == list(ref.sigma)
    assert plan.shift_list == ref.win_shifts
    f = ff * (p << sf)
    assert [s % f for s in plan.win_shifts.tolist()] == list(ref.win_shifts)
    assert np.array_equal(plan.win_taps.numpy(), ref.win_taps)


@pytest.mark.parametrize("sf", [7, 12])
def test_scan_dechirp_constants(sf):
    _, cfg = _cfg(sf, ff=2)
    scan = make_preamble_scan(cfg, 64)
    _, down = jchirp.chirp_tables(sf, cfg.p)
    mod = scan.plan.mod.numpy()
    assert mod.shape == (1, cfg.num_samples, 2)
    assert np.array_equal(mod[0, :, 0], down.real)
    assert np.array_equal(mod[0, :, 1], down.imag)


@pytest.mark.parametrize("grace", [0, 8])
def test_gateway_window_sizing_matches_jax(grace):
    """Window span, lead, suppression, scan chunking and hop blocking per
    SF equal the JAX gateway's at the north-star configuration."""
    jbase, base = _cfg(8)
    kw = dict(max_payload_len=16, grace=grace)
    ours = TriggeredPyramidGateway(base, 4, backend="fused", device="cpu",
                                   **kw)
    ref = JaxGateway(jbase, 4, backend="fused", **kw)
    for sf, st in ours.sf_states.items():
        rs = ref.sf_states[sf]
        assert same_fields(st.cfg, rs.cfg)
        assert (st.win_hops, st.lead, st.suppress, st.scan_windows) \
            == (rs.win_hops, rs.lead, rs.suppress, rs.scan_windows)
        assert ours._win_samples(st) == ref._win_samples(rs)
        assert ours._lattice_block_hops(st) == ref._lattice_block_hops(rs)
    assert ours._ring.cap == ref._ring.cap and ours._base == ref._base


def test_pack_peaks_bits_match_jax():
    rng = np.random.default_rng(4)
    shape = (3, 5, 8)
    bins = rng.integers(0, 1 << 15, shape).astype(np.int32)
    h = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    hs = (np.abs(rng.standard_normal(shape)) * 7).astype(np.float32)
    valid = rng.random(shape) < 0.5
    ours = _pack_peaks(tuple(torch.from_numpy(x) for x in
                             (bins, h, hs, valid))).numpy()
    ref = np.asarray(jax_pack_peaks(tuple(jnp.asarray(x) for x in
                                          (bins, h, hs, valid))))
    assert ours.dtype == np.int32
    assert np.array_equal(ours.view(np.uint32), ref)
    ub, uh, uhs, uv = _unpack_peaks(ours)
    assert np.array_equal(ub, bins) and np.array_equal(uv, valid)
    np.testing.assert_allclose(uh, h, rtol=2 ** -8)
    np.testing.assert_allclose(uhs, hs, rtol=2 ** -8)


_PORT_RUN = """
import importlib, pkgutil, sys
import numpy as np
import gr_lora_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, "gr_lora_tpu_torch."):
    importlib.import_module(m.name)
from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.core import decode, encode
from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import pyramid_demodulate
from gr_lora_tpu_torch.models.sic import sic_symbol_streams
from gr_lora_tpu_torch.ops.cplx import to_ri
cfg = LoraConfig(sf=8, cr=1, crc=True, explicit_header=True, p=2,
                 fft_factor=8, threshold=5.0)
n = cfg.num_samples
p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg)
p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg)
off2 = 1000 + 16 * n + 4 * n // 8 + 204
iq = np.zeros(off2 + len(p2) + 1000, np.complex64)
iq[1000:1000 + len(p1)] += p1
iq[off2:off2 + len(p2)] += p2
golden = {"0630f0010203040506050801", "0530000707070707e76b01"}
syms = pyramid_demodulate(iq, cfg, backend="pallas", device="cpu")
assert {bytes(decode(s, cfg).payload).hex() for s in syms} >= golden
gw = PyramidGateway(cfg, 1, block_hops=256, backend="rdft", device="cpu")
pkts = gw.feed(to_ri(iq)[None]) + gw.flush()
assert {bytes(p.result.payload).hex() for p in pkts} >= golden
syms = sic_symbol_streams(iq, cfg, backend="fused", fast_align=True,
                          device="cpu")
assert {bytes(decode(s, cfg).payload).hex() for s in syms} >= golden
from gr_lora_tpu_torch.entry import entry
from gr_lora_tpu_torch.models.transceiver import loopback
from gr_lora_tpu_torch.models.weak import modulate_weak, weak_demodulate
assert loopback(bytes([1, 2, 3]), cfg.replace(fft_factor=2),
                device="cpu").payloads
wc = cfg.replace(weak_sym_num=4)
got = weak_demodulate(modulate_weak(np.arange(4), wc), wc, device="cpu")
assert [g.tolist() for g in got] == [[0, 1, 2, 3]]
fn, args = entry(device="cpu")
assert int(fn(*args)[3]) == 1
import os, tempfile
from gr_lora_tpu_torch.apps import gateway
from gr_lora_tpu_torch.pipeline.channelizer import (channel_frequencies,
                                                    channelize)
wc = cfg.replace(sf=7, fft_factor=4)
wide = 0.4 * modulate(encode(bytes([1, 2, 3, 4]), wc), wc, p=4)
wide = (wide * np.exp(2j * np.pi * channel_frequencies(4)[1]
                      * np.arange(len(wide)) / 500e3)).astype(np.complex64)
assert channelize(to_ri(wide), 4, 500e3, device="cpu").shape[0] == 4
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "wide.cf64")
    wide.tofile(path)
    assert gateway.main([path, "--samp-rate", "500e3", "--channels", "4",
                         "--sfs", "7", "--fft-factor", "4", "--quiet"],
                        device="cpu") == 0
from gr_lora_tpu_torch.dist import (gateway_receive, make_gateway,
                                    make_mesh, multihost, right_halo_len)
gw = PyramidGateway(cfg, 1, block_hops=256, device="cpu",
                    mesh=make_mesh(1, 2, devices=["cpu"] * 2))
pkts = gw.feed(to_ri(iq)[None]) + gw.flush()
assert {bytes(p.result.payload).hex() for p in pkts} >= golden
fc = cfg.replace(sf=7, fft_factor=2, explicit_header=False, payload_len=4)
blk = right_halo_len(fc)
pkt = to_ri(modulate(encode(bytes([9, 8, 7, 6]), fc), fc))
fiq = np.zeros((1, 2 * blk, 2), np.float32)
fiq[0, blk - len(pkt) // 2:blk - len(pkt) // 2 + len(pkt)] = pkt
plan = make_gateway(fc, make_mesh(1, 2, devices=[(0, "cpu")] * 2), 1, blk,
                    max_packets=2, gather_results=True)
lo, hi = multihost.time_range_of_process(plan, 2 * blk)
out, stats = multihost.multihost_gateway_receive(
    plan, multihost.process_local_input(plan, fiq[:, lo:hi], 2 * blk), fc)
assert [bytes(decode(s, fc).payload[:4]) for _, s in out[0]] == \
    [bytes([9, 8, 7, 6])] and stats["dropped"] == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gr_lora_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    """Every port module imported, a CPU decode, a CPU gateway feed, a
    CPU SIC run (models.sic), the FSM receive path (the loopback, the
    weak demodulator, entry()), a CPU channelize and one gateway.main
    over a wideband capture, then the shard grid (dist/mesh): the
    always-on gateway on a {1, 2} grid and the FSM gateway through
    dist/gateway and dist/multihost's one-rank path, in a fresh
    interpreter: neither jax nor any module of the JAX package is
    loaded."""
    res = subprocess.run([sys.executable, "-c", _PORT_RUN],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _entry_points():
    from gr_lora_tpu_torch.dist.pyramid_gateway import (MultiSFPyramidGateway,
                                                        PyramidGateway)
    from gr_lora_tpu_torch.models.pyramid import (StreamingPyramidDemodulator,
                                                  pyramid_demodulate)
    from gr_lora_tpu_torch.models.sic import (sic_demodulate,
                                              sic_symbol_streams)
    from gr_lora_tpu_torch.pipeline import channelizer, frontend, ingest
    from gr_lora_tpu_torch.pipeline.device_ring import DeviceRing

    _, cfg = _cfg(7, ff=2)
    iq = np.zeros((4 * cfg.num_samples, 2), np.float32)
    wide = np.zeros((4096, 2), np.float32)
    return {
        "channelize": (channelizer.channelize,
                       lambda **kw: channelizer.channelize(wide, 8, 1e6,
                                                           **kw)),
        "StreamingChannelizer": (
            channelizer.StreamingChannelizer,
            lambda **kw: channelizer.StreamingChannelizer(8, 1e6, **kw)),
        "fir_filter": (frontend.fir_filter,
                       lambda **kw: frontend.fir_filter(wide, np.ones(5),
                                                        **kw)),
        "polyphase_resample": (
            frontend.polyphase_resample,
            lambda **kw: frontend.polyphase_resample(wide, 0.25, **kw)),
        "resample_to_receiver_rate": (
            frontend.resample_to_receiver_rate,
            lambda **kw: frontend.resample_to_receiver_rate(wide, 1e6, cfg,
                                                            **kw)),
        "upsample_to_capture_rate": (
            frontend.upsample_to_capture_rate,
            lambda **kw: frontend.upsample_to_capture_rate(iq, 2, 1e6, cfg,
                                                           **kw)),
        "replay": (frontend.replay,
                   lambda **kw: frontend.replay(wide, 1e6, cfg, **kw)),
        "stream_demodulate": (
            ingest.stream_demodulate,
            lambda **kw: ingest.stream_demodulate(
                cfg, io.BytesIO(bytes(8 * 4096)), **kw)),
        "pyramid_demodulate": (pyramid_demodulate,
                               lambda **kw: pyramid_demodulate(iq, cfg, **kw)),
        "StreamingPyramidDemodulator": (
            StreamingPyramidDemodulator,
            lambda **kw: StreamingPyramidDemodulator(cfg, 64, **kw)),
        "PyramidGateway": (PyramidGateway,
                           lambda **kw: PyramidGateway(cfg, 1, 64, **kw)),
        "MultiSFPyramidGateway": (
            MultiSFPyramidGateway,
            lambda **kw: MultiSFPyramidGateway(cfg, 1, sfs=(7,),
                                               block_hops=64, **kw)),
        "TriggeredPyramidGateway": (
            TriggeredPyramidGateway,
            lambda **kw: TriggeredPyramidGateway(cfg, 1, sfs=(7,), **kw)),
        "DeviceRing": (DeviceRing, lambda **kw: DeviceRing(1, 1024, **kw)),
        "sic_demodulate": (sic_demodulate,
                           lambda **kw: sic_demodulate(iq, cfg, **kw)),
        "sic_symbol_streams": (
            sic_demodulate, lambda **kw: sic_symbol_streams(iq, cfg, **kw)),
    }


@pytest.mark.parametrize("name", ["pyramid_demodulate",
                                  "StreamingPyramidDemodulator",
                                  "PyramidGateway", "MultiSFPyramidGateway",
                                  "TriggeredPyramidGateway", "DeviceRing",
                                  "sic_demodulate", "sic_symbol_streams",
                                  "channelize", "StreamingChannelizer",
                                  "fir_filter", "polyphase_resample",
                                  "resample_to_receiver_rate",
                                  "upsample_to_capture_rate", "replay",
                                  "stream_demodulate"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Each entry point's device defaults to "cuda"; with no CUDA device
    it raises unless the caller passes device="cpu", where it runs."""
    import inspect

    fn, call = _entry_points()[name]
    target = fn.__init__ if inspect.isclass(fn) else fn
    assert inspect.signature(target).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")
