"""The port's on-device Pyramid tracker (models/device_tracker,
ops/device_tracker) against the JAX package's, on the CPU.

The same peak lattices go through the JAX ``make_device_tracker`` (its
``lax.scan``s, jitted once per shape) and the port's walk (its plain
version here: the kernel runs only on the card), both from a fresh state
or from one carried across.  Every state field must be equal, the f32
fields bit for bit: the port rounds each operation as XLA does and sums
the stable preamble height in index order, the order of XLA's CPU
reduction.  The fixtures are tests/test_device_tracker.py's (a single
packet, the golden collision, noise over several blocks, grace, six
synthetic fuzz lattices, drains, tiny pools) and
tests/test_split_repeats.py's repeat twins, at SF7-8.
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

import test_device_tracker as JT
from gr_lora_tpu.models.device_tracker import flush_hops as jax_flush_hops
from gr_lora_tpu.models.device_tracker import \
    make_device_tracker as jax_make_device_tracker
from gr_lora_tpu_torch.models import device_tracker as dt
from gr_lora_tpu_torch.models.pyramid import num_hops_for, peak_lattice_fn
from gr_lora_tpu_torch.ops.device_tracker import STATE_FIELDS
from test_split_repeats import _air
from test_split_repeats import _cfg as split_cfg
from test_torch_core import port_config

CFG = JT.CFG
_N = JT._N
M = 8
DEVIATIONS = ("tracks_dropped", "packets_dropped", "finalize_deferred",
              "expire_deferred", "packet_peak_overflow", "out_overflow")


@lru_cache(maxsize=None)
def _jax_walk(cfg, grace=0, pools=()):
    init, proc = jax_make_device_tracker(cfg, M, grace, **dict(pools))
    return init, jax.jit(proc)


#: Hops a block: every lattice is fed in blocks of one size (its last one
#: padded with empty hops), so each configuration compiles once in JAX.
BLOCK = 128


def _blocks(lat, flush=0):
    """The lattice in BLOCK-hop blocks, then at least ``flush`` empty
    hops."""
    hops = lat[0].shape[0]
    total = -(-hops // BLOCK) * BLOCK + -(-flush // BLOCK) * BLOCK
    pad = [np.zeros((total,) + x.shape[1:], x.dtype) for x in lat]
    for p, x in zip(pad, lat):
        p[:hops] = x
    return [tuple(p[lo:lo + BLOCK] for p in pad)
            for lo in range(0, total, BLOCK)]


def _run_jax(cfg, blocks, grace=0, state=None, **pools):
    init, proc = _jax_walk(cfg, grace, tuple(sorted(pools.items())))
    st = init() if state is None else state
    states = []
    for b in blocks:
        st = proc(st, *b)
        states.append({k: np.asarray(v)
                       for k, v in jax.device_get(st).items()})
    return states


def _run_port(cfg, blocks, grace=0, state=None, **pools):
    walk = dt.make_device_tracker(port_config(cfg), M, grace, **pools)
    st = walk.init_state(1, "cpu") if state is None else state
    states = []
    for b in blocks:
        walk.process(st, *(torch.from_numpy(x.copy())[None] for x in b))
        states.append({k: v[0] for k, v in dt.state_to_numpy(st).items()})
    return states


def _assert_same_state(jax_state, port_state):
    for name, _ in STATE_FIELDS:
        a, b = np.asarray(jax_state[name]), np.asarray(port_state[name])
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind == "f":     # bit for bit, not just equal values
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), (name, np.argwhere(a != b)[:4])


def _both(cfg, lat, grace=0, **pools):
    """Run both trackers over the lattice and the flush, block by block;
    every block's state must agree.  Returns the last JAX state."""
    blocks = _blocks(lat, jax_flush_hops(grace) + grace)
    js = _run_jax(cfg, blocks, grace, **pools)
    ps = _run_port(cfg, blocks, grace, **pools)
    for a, b in zip(js, ps):
        _assert_same_state(a, b)
    return js[-1]


def _lattice(iq, cfg=CFG):
    """The port's ``xla`` peak lattice of a capture as numpy arrays (the
    same input for both trackers)."""
    pcfg = port_config(cfg)
    ri = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    fn = peak_lattice_fn(pcfg, num_hops_for(pcfg, len(ri)), M)
    with torch.no_grad():
        return tuple(x.numpy() for x in fn(torch.from_numpy(ri)))


def _packets(state):
    n = int(state["o_count"])
    return [state["o_syms"][i, :state["o_len"][i]].tolist()
            for i in range(n)]


def _single():
    pkt = JT._tx(bytes([183, 111, 71, 144, 71, 48]), 0.2)
    iq = np.zeros(1000 + len(pkt) + 14 * _N, np.complex64)
    iq[1000:1000 + len(pkt)] = pkt
    return _lattice(iq)


def _collision(cfg):
    n = cfg.num_samples
    p1 = JT._tx(bytes([1, 2, 3, 4, 5, 6]), 0.2, cfg)
    p2 = JT._tx(bytes([7, 7, 7, 7, 7]), 0.09, cfg)
    iq = np.zeros(1000 + 22 * n + 2 * (13 * n + 18 * n) + 8 * n,
                  np.complex64)
    iq[1000:1000 + len(p1)] += p1
    off2 = 1000 + 16 * n + 4 * n // 8 + 204
    iq[off2:off2 + len(p2)] += p2
    return _lattice(iq, cfg)


def _noisy():
    rng = np.random.default_rng(3)
    p1 = JT._tx(bytes([72, 229, 46, 41]), 0.22)
    p2 = JT._tx(bytes([124, 8, 138, 59]), 0.1)
    total = 600 + len(p1) + len(p2) + 12 * _N
    iq = (0.02 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[600:600 + len(p1)] += p1
    off2 = 600 + 9 * _N + 33
    iq[off2:off2 + len(p2)] += p2
    return _lattice(iq)


@pytest.mark.parametrize("split", [False, True])
def test_single_packet(split):
    last = _both(CFG, _single(), split_repeats=split)
    assert int(last["o_count"]) == 1
    assert sum(int(last[k]) for k in DEVIATIONS) == 0


@pytest.mark.parametrize("split", [False, True])
def test_golden_collision(split):
    cfg = JT._GCFG
    last = _both(cfg, _collision(cfg), split_repeats=split)
    assert int(last["o_count"]) >= 2, _packets(last)


def test_noise_over_blocks():
    """State carried across blocks, compared after each."""
    last = _both(CFG, _noisy())
    assert int(last["o_count"]) >= 1


def test_grace():
    p1 = JT._tx(bytes([183, 111, 71, 144, 71, 48]), 0.2)
    p2 = JT._tx(bytes([51, 181, 222, 161, 104]), 0.07)
    iq = np.zeros(1000 + len(p1) + len(p2) + 12 * _N, np.complex64)
    iq[1000:1000 + len(p1)] += p1
    off2 = 1000 + 8 * _N + 101
    iq[off2:off2 + len(p2)] += p2
    _both(CFG, _lattice(iq), grace=2)


def _fuzz_lattice(seed):
    """tests/test_device_tracker.py's synthetic lattice: packet-shaped
    track runs and clutter, ascending bins within each hop."""
    rng = np.random.default_rng(seed)
    k = CFG.bin_size
    H = 420
    bins = np.zeros((H, M), np.int32)
    h = np.zeros((H, M), np.float32)
    hs = np.zeros((H, M), np.float32)
    valid = np.zeros((H, M), bool)

    def put(t, b, hv, hsv):
        t = int(t)
        if not 0 <= t < H:
            return
        m = int(valid[t].sum())
        if m >= M:
            return
        bins[t, m] = b % k
        h[t, m] = hv
        hs[t, m] = hsv
        valid[t, m] = True

    for _ in range(rng.integers(2, 4)):
        t0 = int(rng.integers(0, H // 3))
        b0 = int(rng.integers(0, k))
        amp = float(rng.uniform(8, 40))
        drift = k // 8
        for i in range(44):
            put(t0 + i, b0 + i * drift,
                amp * (1 + 0.02 * rng.standard_normal()),
                amp * (0.8 + 0.1 * rng.standard_normal()))
        tsym = t0 + 44 + int(rng.integers(2, 6))
        for _ in range(int(rng.integers(10, 15))):
            bsym = int(rng.integers(0, k))
            ln = int(rng.integers(2, 9))
            for i in range(ln):
                put(tsym + i, bsym + i * drift,
                    amp * (1 + 0.05 * rng.standard_normal()),
                    amp * (0.8 + 0.1 * rng.standard_normal()))
            tsym += 8 + int(rng.integers(-1, 2))
    for _ in range(150):
        put(rng.integers(0, H), rng.integers(0, k),
            rng.uniform(5.5, 12), rng.uniform(4, 12))
    for t in range(H):
        m = int(valid[t].sum())
        order = np.argsort(bins[t, :m], kind="stable")
        bins[t, :m] = bins[t, :m][order]
        h[t, :m] = h[t, :m][order]
        hs[t, :m] = hs[t, :m][order]
    return bins, h, hs, valid


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_synthetic_lattice(seed):
    _both(CFG, _fuzz_lattice(seed), split_repeats=seed % 2 == 1)


def test_drain_resets_and_accumulates():
    """The port's DevicePyramidTracker handle: a drain takes the packets
    the JAX tracker holds (symbols, positions), a second drain is empty,
    and a second packet goes through the same state."""
    iq = np.zeros(1000 + 40 * _N, np.complex64)
    pkt = JT._tx(bytes([190, 87, 170, 218]), 0.2)
    iq[1000:1000 + len(pkt)] = pkt
    lat = _lattice(iq)
    ref = _run_jax(CFG, _blocks(lat, jax_flush_hops()))[-1]
    tr = dt.DevicePyramidTracker(port_config(CFG), max_peaks=M,
                                 device="cpu")
    for x in _blocks(lat, jax_flush_hops()):
        tr.feed(*x)
    syms, pos = tr.drain()
    assert [s.tolist() for s in syms] == _packets(ref)
    assert pos == ref["o_pos"][:len(syms)].tolist()
    assert len(syms) == 1 and tr.drain() == ([], [])
    tr.feed(*lat)
    tr.feed_empty(tr.flush_hops())
    again, _ = tr.drain()
    assert len(again) == 1 and np.array_equal(again[0], syms[0])
    assert tr.deviations() == 0, tr.stats()
    assert tr.stats()["tracks_overflow_finalized"] == 0


def _twin_lattice():
    """Two synthetic packets on opposite halves of the band with the same
    timing, so both expire on one hop."""
    k = CFG.bin_size
    drift = k // 8
    rng = np.random.default_rng(0)
    bins = np.zeros((200, M), np.int32)
    h = np.zeros((200, M), np.float32)
    hs = np.zeros((200, M), np.float32)
    valid = np.zeros((200, M), bool)

    def put(t, j, b, amp):
        bins[t, j], h[t, j], hs[t, j], valid[t, j] = b % k, amp, 0.8 * amp, 1

    for j in range(2):
        amp = 20.0 + 10 * j
        for i in range(44):
            put(4 + i, j, j * (k // 2) + 5 + i * drift, amp)
        for s in range(12):
            b = int(rng.integers(0, k // 2)) + j * (k // 2)
            for i in range(4):
                put(50 + 8 * s + i, j, b + i * drift, amp)
    order = np.argsort(np.where(valid, bins, k + 1), axis=1, kind="stable")
    return tuple(np.take_along_axis(x, order, 1)
                 for x in (bins, h, hs, valid))


#: Pools small enough that every deviation counter fires: on the golden
#: collision a 4-track pool (tracks_dropped), one packet slot
#: (packets_dropped), one retirement a hop (finalize_deferred), 8
#: symbols a packet (packet_peak_overflow); one output slot between
#: drains (out_overflow); one expiry a hop on the twin lattice
#: (expire_deferred).
TINY_POOLS = [
    ("collision", dict(track_pool=4, packet_pool=1, expire_per_hop=1,
                       max_symbols=8, out_pool=1, finalize_per_hop=1)),
    ("collision", dict(out_pool=1)),
    ("twin", dict(expire_per_hop=1)),
]


def test_deviation_counters_fire_on_tiny_pools():
    fired = set()
    for fixture, pools in TINY_POOLS:
        cfg, lat = ((JT._GCFG, _collision(JT._GCFG)) if fixture == "collision"
                    else (CFG, _twin_lattice()))
        last = _both(cfg, lat, **pools)
        fired |= {k for k in DEVIATIONS if int(last[k]) > 0}
    assert fired == set(DEVIATIONS), fired


def test_deferral_is_delay_not_loss():
    """tests/test_soak.py's bounded-pool case: one retirement and one
    expiry a hop on the golden collision; with a long empty tail the
    packets equal the unbounded tracker's."""
    cfg = JT._GCFG
    lat = _collision(cfg)
    blocks = _blocks(lat, flush=4 * jax_flush_hops())
    pools = dict(finalize_per_hop=1, expire_per_hop=1)
    js = _run_jax(cfg, blocks, **pools)
    ps = _run_port(cfg, blocks, **pools)
    _assert_same_state(js[-1], ps[-1])
    assert int(ps[-1]["finalize_deferred"]) > 0
    full = _run_port(cfg, blocks)[-1]
    assert sorted(map(tuple, _packets(ps[-1]))) == \
        sorted(map(tuple, _packets(full)))


@pytest.mark.parametrize("sf,pay", [(8, bytes([7, 0xA0, 8, 1, 2, 3, 4, 5])),
                                    (7, bytes([1, 2, 3, 4, 5, 6]))])
def test_split_twin(sf, pay):
    """tests/test_split_repeats.py's repeat fixtures with split_repeats
    (a double repeat at SF8; a repeat and a triple run at SF7).  The
    lattice is the port's (``xla``), the same for both trackers."""
    cfg = split_cfg(sf)
    iq, tx = _air(cfg, pay)
    assert np.any(tx[1:] == tx[:-1])
    last = _both(cfg, _lattice(iq, cfg), split_repeats=True)
    assert sum(int(last[k]) for k in DEVIATIONS) == 0
    assert any(len(s) == len(tx) and s == tx.tolist()
               for s in _packets(last)), _packets(last)


def test_state_carried_from_jax_mid_stream():
    """A JAX state after the first blocks becomes the port's
    (state_from_jax), and one more block in both gives equal states;
    state_to_numpy gives the JAX arrays back."""
    cfg = JT._GCFG
    blocks = _blocks(_collision(cfg))
    js = _run_jax(cfg, blocks[:2], split_repeats=True)[-1]
    ours = dt.state_from_jax(js, device="cpu")
    back = {k: v[0] for k, v in dt.state_to_numpy(ours).items()}
    _assert_same_state(js, back)
    init, proc = _jax_walk(cfg, 0, (("split_repeats", True),))
    jax_next = _run_jax(cfg, blocks[2:3], state=jax.device_put(js),
                        split_repeats=True)[-1]
    port_next = _run_port(cfg, blocks[2:3], state=ours,
                          split_repeats=True)[-1]
    _assert_same_state(jax_next, port_next)
    batched = {k: np.stack([v, v]) for k, v in js.items()}
    two = dt.state_from_jax(batched, device="cpu")
    assert two["t_ring_h"].shape[0] == 2


@pytest.mark.parametrize("grace", [0, 3])
def test_flush_hops(grace):
    assert dt.flush_hops(grace) == jax_flush_hops(grace)


def test_entry_points_default_to_the_card(monkeypatch):
    """The tracker's entry points run on the card unless told otherwise;
    mesh= (ported since) takes a dist/mesh.ShardGrid and raises for
    anything else."""
    import inspect

    for fn in (dt.DevicePyramidTracker.__init__, dt.init_state,
               dt.state_from_jax, dt.make_channel_tracker_plan):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(TypeError, match="ShardGrid"):
        dt.make_channel_tracker_plan(port_config(CFG), 64, mesh=object(),
                                     device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.DevicePyramidTracker(port_config(CFG))
    tr = dt.DevicePyramidTracker(port_config(CFG), device="cpu")
    assert tr.state["t_active"].device.type == "cpu"
