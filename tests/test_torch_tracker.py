"""The port's Python ``PyramidTracker`` (models/pyramid) against the port's
C++ tracker and the JAX package's Python tracker, and its four uses.

Every tracker is fed the same recorded peak stream
(``test_torch_core._recorded_peaks``: the README collision on two
channels, SF8 x ff 8, from the port's dense lattice): the drains,
positions, ``stats()`` and ``flush_hops`` must be equal at grace 0 / 8,
``split_repeats`` on and off and ``quantize`` floor and round.
``apex_algorithm="linear_regression"`` exists in the Python trackers
only.  ``_PyTrackerBank`` must drain what ``MultiPyramidTracker`` drains,
and ``use_native=False`` must equal ``use_native=True`` in both gateways
on the CPU (pyramid_demodulate's and StreamingPyramidDemodulator's are in
tests/test_torch_pyramid.py and tests/test_torch_pyramid_gateway.py).
"""

import numpy as np
import pytest

from gr_lora_tpu.models.pyramid import PyramidTracker as JaxTracker
from gr_lora_tpu_torch import native
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import (PyramidGateway,
                                                    _PyTrackerBank)
from gr_lora_tpu_torch.models.pyramid import PyramidTracker, step_lattice
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_pyramid_gateway import _N, _collision_matrix
from test_torch_collision_gateway import (BASE, _run,
                                          _three_channel_fixture)
from test_torch_core import _recorded_peaks

GOLDEN = {"0630f0010203040506050801", "0530000707070707e76b01"}


@pytest.fixture(scope="module")
def recorded():
    return _recorded_peaks()


def _track(tracker, peaks, ch):
    """(positions, symbols, stats) of one channel's stream, flushed."""
    _, bins, h, hs, valid = peaks
    step_lattice(tracker, bins[ch], h[ch], hs[ch], valid[ch])
    for _ in range(tracker.flush_hops()):
        tracker.step()
    if isinstance(tracker, native.PyramidTracker):
        out = tracker.drain_ts()
        pos, syms = [p for p, _ in out], [s for _, s in out]
    else:
        pos, syms = list(tracker.positions_out), list(tracker.symbols_out)
    return pos, syms, tracker.stats()


def _same(a, b):
    assert a[0] == b[0] and a[2] == b[2]
    assert len(a[1]) == len(b[1])
    assert all(x.dtype == y.dtype == np.uint16 and np.array_equal(x, y)
               for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("quantize", ["round", "floor"])
@pytest.mark.parametrize("split_repeats", [False, True])
@pytest.mark.parametrize("grace", [0, 8])
def test_python_tracker_equals_native_and_jax(recorded, grace,
                                             split_repeats, quantize):
    (jc, tc) = recorded[0]
    kw = dict(grace=grace, split_repeats=split_repeats, quantize=quantize)
    for ch in range(recorded[1].shape[0]):
        ours = PyramidTracker(tc, **kw)
        nat = native.PyramidTracker(tc, **kw)
        ref = JaxTracker(jc, **kw)
        assert ours.flush_hops() == nat.flush_hops() == ref.flush_hops()
        got = _track(ours, recorded, ch)
        _same(got, _track(nat, recorded, ch))
        _same(got, _track(ref, recorded, ch))
        assert len(got[1]) >= 2


@pytest.mark.parametrize("grace", [0, 8])
def test_linear_regression_apex_equals_jax(recorded, grace):
    (jc, tc) = recorded[0]
    kw = dict(grace=grace, apex_algorithm="linear_regression")
    for ch in range(recorded[1].shape[0]):
        _same(_track(PyramidTracker(tc, **kw), recorded, ch),
              _track(JaxTracker(jc, **kw), recorded, ch))


def test_tracker_rejects_bad_options(recorded):
    tc = recorded[0][1]
    with pytest.raises(ValueError):
        PyramidTracker(tc, apex_algorithm="median")
    with pytest.raises(ValueError):
        PyramidTracker(tc, quantize="ceil")


def test_python_bank_equals_native_bank(recorded):
    """Fed in 100-hop blocks, then flushed: the same (channel, position,
    symbols) drains, stats and flush length."""
    (_, tc), bins, h, hs, valid = recorded
    c = bins.shape[0]
    ours = _PyTrackerBank(tc, c, grace=8)
    ref = native.MultiPyramidTracker(tc, c, grace=8)
    assert ours.flush_hops() == ref.flush_hops()
    got, want = [], []
    for lo in range(0, bins.shape[1], 100):
        blk = [a[:, lo:lo + 100] for a in (bins, h, hs, valid)]
        ours.feed(*blk)
        ref.feed(*blk)
        got += ours.drain()
        want += ref.drain()
    z = np.zeros((c, ref.flush_hops() + 8, bins.shape[2]))
    for bank in (ours, ref):
        bank.feed(z.astype(np.int32), z, z, z.astype(bool))
    got += ours.drain()
    want += ref.drain()
    assert len(got) == len(want) >= 2 * c
    for (ch, pos, s), (rch, rpos, rs) in zip(got, want):
        assert (ch, pos) == (rch, rpos) and np.array_equal(s, rs)
    assert ours.stats() == ref.stats()


def _gateway_packets(pkts):
    return sorted((p.channel, p.sf, p.position, p.symbols.tobytes(),
                   bool(p.result is not None and p.result.ok
                        and p.result.crc_ok)) for p in pkts)


def test_pyramid_gateway_python_bank_equals_native():
    ri = to_ri(_collision_matrix(2, 1000 + 2 * 4 * _N + 76 * _N))
    got = {}
    for use_native in (False, True):
        gw = PyramidGateway(BASE, 2, block_hops=256, max_peaks=8,
                            backend="rdft", use_native=use_native,
                            device="cpu")
        got[use_native] = _gateway_packets(gw.feed(ri) + gw.flush())
    assert got[False] == got[True]
    assert sum(ok for *_, ok in got[True]) >= 4


def test_triggered_gateway_python_trackers_equal_native():
    kw = dict(sfs=(8, 9), max_payload_len=16, scan_chunk_samples=1 << 16,
              backend="fused", device="cpu")
    got = {}
    for use_native in (False, True):
        gw = TriggeredPyramidGateway(BASE, 3, use_native=use_native, **kw)
        ri = _three_channel_fixture(gw.sf_states[9].cfg)
        got[use_native] = _gateway_packets(_run(gw, ri, 50_000))
    assert got[False] == got[True]
    assert sum(ok for *_, ok in got[True]) >= 3
