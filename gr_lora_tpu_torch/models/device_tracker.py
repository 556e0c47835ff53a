"""On-device Pyramid peak tracking: only finished packets leave the card.

Twin of gr_lora_tpu/models/device_tracker.py.  The host trackers
(models/pyramid.PyramidTracker and the C++ one) walk the dense
``[hops, max_peaks]`` peak lattice on the host, which brings the whole
lattice across PCIe.  This module runs the same state machine on the
card over fixed-size pools, so the lattice is consumed where it is made
and only finished packets (symbol vectors, lengths, preamble timestamps)
are copied back.

The walk itself is ``ops/device_tracker.TrackerWalk.process``: one
hand-written kernel launch a ``[C, H, M]`` block on the card
(``csrc/device_tracker.cu``), its plain PyTorch version on the CPU.  The
state is a dict of tensors under the JAX ``init_state`` keys with a
leading channel axis (the layout ``jax.vmap`` gives); ``state_from_jax``
and ``state_to_numpy`` carry a state between the two packages.

Bounded-pool deviations are counted, never silent (the JAX module doc):
at most ``finalize_per_hop`` retirements and ``expire_per_hop`` expiries a
hop (the rest wait a hop: a delay, not a loss), at most ``max_symbols``
peaks a packet and ``out_pool`` finished packets between drains.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import (PYRAMID_NUM_PREAMBLE, PYRAMID_OVERLAP_FACTOR,
                      PYRAMID_PACKET_POOL, LoraConfig)
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..ops.device_tracker import STATE_FIELDS, TrackerWalk

_OV = PYRAMID_OVERLAP_FACTOR
_TTL0 = 6 * _OV

_DEVIATION_COUNTERS = ("tracks_dropped", "packets_dropped",
                       "finalize_deferred", "expire_deferred",
                       "packet_peak_overflow", "out_overflow")


def flush_hops(grace: int = 0) -> int:
    """Empty hops needed to retire every live track and expire every
    packet (host PyramidTracker.flush_hops analog)."""
    return (PYRAMID_NUM_PREAMBLE + 3) * _OV + _TTL0 + 2 + grace


def make_device_tracker(cfg: LoraConfig, max_peaks: int = 16,
                        grace: int = 0, track_pool: int = 64,
                        packet_pool: int = PYRAMID_PACKET_POOL,
                        max_symbols: int = 96, out_pool: int = 32,
                        finalize_per_hop: int = 8, expire_per_hop: int = 4,
                        split_repeats: bool = False,
                        quantize: str = "round") -> TrackerWalk:
    """The walk of one tracker configuration (the JAX
    ``make_device_tracker``'s arguments), shared by every caller that
    names the same configuration, however it passes the arguments."""
    return _walk(cfg, max_peaks, grace, track_pool, packet_pool,
                 max_symbols, out_pool, finalize_per_hop, expire_per_hop,
                 split_repeats, quantize)


@lru_cache(maxsize=None)
def _walk(*args) -> TrackerWalk:
    return TrackerWalk(*args)


def init_state(cfg: LoraConfig, channels: int, max_peaks: int = 16,
               grace: int = 0, device=DEFAULT_DEVICE, **pools) -> dict:
    """Fresh states of ``channels`` trackers on ``device``."""
    walk = make_device_tracker(cfg, max_peaks, grace, **pools)
    return walk.init_state(channels, resolve_device(device))


def state_from_jax(np_state: dict, device=DEFAULT_DEVICE,
                   mesh=None) -> dict:
    """The JAX package's tracker state (a dict of numpy arrays, one
    tracker's or batched over channels) as the port's, with a leading
    channel axis, on ``device``.  With ``mesh`` (a ``dist/mesh.
    ShardGrid``) the state is a whole batch fetched from the JAX mesh
    plan, and each channel row this rank tracks is placed on its slots'
    device (``make_channel_tracker_plan(mesh=...)``'s states)."""
    batched = np.asarray(np_state["t_active"]).ndim == 2
    rows = slice(None)
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device
        chans = np.asarray(np_state["t_active"]).shape[0]
        cpr = chans // mesh.shape["ch"]
        rows = np.concatenate([np.arange(c * cpr, (c + 1) * cpr)
                               for c in mesh.row_layout().rows]
                              + [np.zeros(0, np.int64)])
    out = {}
    for name, dt in STATE_FIELDS:
        a = np.asarray(np_state[name])
        if not batched:
            a = a[None]
        out[name] = torch.from_numpy(np.array(a[rows])).to(device=dev,
                                                           dtype=dt)
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state as a dict of numpy arrays (leading channel axis),
    in the JAX package's dtypes; copies, never views of the state."""
    return {name: state[name].cpu().numpy().copy()
            for name, _ in STATE_FIELDS}


def fetch_packets(state: dict, extras=()):
    """(o_count, o_len, o_pos, o_syms, *extras) of every channel as host
    arrays, the pool sliced to its live region (the packets waiting and
    their longest length): the counts and the ``extras`` ([C] tensors)
    come in one copy, the pool in two more when a count is non-zero.
    Leaves the state as it is."""
    head = torch.stack([state["o_count"], *extras]).cpu().numpy()
    cnt, rest = head[0], tuple(head[1:])
    kmax = int(cnt.max()) if cnt.size else 0
    c = cnt.shape[0]
    if kmax == 0:
        return (cnt, np.zeros((c, 0), np.int32), np.zeros((c, 0), np.int32),
                np.zeros((c, 0, 0), np.int32), *rest)
    lens_pos = torch.stack([state["o_len"][:, :kmax],
                            state["o_pos"][:, :kmax]]).cpu().numpy()
    o_len, o_pos = lens_pos[0], lens_pos[1]
    lmax = int(o_len.max())
    o_syms = state["o_syms"][:, :kmax, :lmax].cpu().numpy()
    return (cnt, o_len, o_pos, o_syms, *rest)


def _pop(state: dict):
    """fetch_packets, then the output counts zeroed."""
    out = fetch_packets(state)
    state["o_count"].zero_()
    return out


def deviation_total(state: dict) -> torch.Tensor:
    """[C] total of the bounded-pool deviation counters (on the state's
    device, not synchronised)."""
    return sum(state[k] for k in _DEVIATION_COUNTERS)


def counter_totals(state: dict) -> dict:
    """The deviation counters and ``tracks_overflow_finalized``, each
    summed over the channels (one copy to the host), and their
    ``deviations`` total."""
    keys = _DEVIATION_COUNTERS + ("tracks_overflow_finalized",)
    got = torch.stack([state[k] for k in keys]).sum(1).cpu().tolist()
    out = dict(zip(keys, got))
    out["deviations"] = sum(out[k] for k in _DEVIATION_COUNTERS)
    return out


def make_channel_tracker_plan(cfg: LoraConfig, block_hops: int,
                              max_peaks: int = 16, grace: int = 0,
                              backend: str = "xla", mesh=None,
                              lattice_block_hops: int | None = None,
                              device=DEFAULT_DEVICE, **pools):
    """Fused lattice + tracker step over a channel batch, the always-on
    gateway's ``tracker="device"`` mode.  Returns ``(init, step, pop)``:

    - ``init(channels)`` -> per-channel tracker states on ``device``;
    - ``step(states, iq)`` -> ``(states, o_count [C])``: the peak lattice
      of one ``[C, block_len + halo, 2]`` block and every channel's
      tracker advanced on the device (the states are updated in place);
    - ``pop(states)`` -> ``(states, (o_count, o_len, o_pos, o_syms))``:
      the finished packets as host arrays sliced to the live region, the
      output counts zeroed — called when ``o_count`` says there is
      something to fetch.

    With ``mesh`` (a ``dist/mesh.ShardGrid``; ``device`` is then the
    grid's) the block is the rank's feed (``ShardGrid.row_layout``: its
    own rows, or every channel where a row spans ranks), its time split
    over ``t`` with the right halo from the ``t`` neighbour and the tail on
    the last slot, a rank's slots one lattice call; each row's lattice is
    gathered along ``t`` and walked once, on the rank that holds the row's
    first ``t`` slot (the JAX package walks it replicated on every ``t``
    shard).  ``init(channels)`` and the states are that rank's rows' only,
    placed by row on its device, and ``step`` returns their counts.  A pop
    moves no data between ranks, so no pop decision gates a collective
    and the counts need no gather over ``ch``; every rank runs ``step``
    on every block, rows or none, so each joins every gather.
    """
    from .pyramid import peak_lattice_fn

    walk = make_device_tracker(cfg, max_peaks, grace, **pools)
    if mesh is None:
        dev = resolve_device(device)
        run = lat = peak_lattice_fn(cfg, block_hops, max_peaks, backend,
                                    block_hops=lattice_block_hops).to(dev)
    else:
        if not callable(getattr(mesh, "lattice", None)):
            raise TypeError(f"mesh must be a ShardGrid, not "
                            f"{type(mesh).__name__}")
        nt = mesh.shape["t"]
        if block_hops % nt:
            raise ValueError(f"block_hops {block_hops} % t-shards {nt} != 0")
        dev = mesh.device
        lat = peak_lattice_fn(cfg, block_hops // nt, max_peaks, backend,
                              block_hops=lattice_block_hops).to(dev)
        n = cfg.num_samples
        hop = n // _OV
        grid_lat = mesh.lattice(_Words(lat), block_hops * hop, n - hop)
        rows = len(mesh.row_layout().rows)

        def run(iq):
            return _from_words(grid_lat(iq))

    def init(channels: int) -> dict:
        if mesh is not None:
            if channels % mesh.shape["ch"]:
                raise ValueError(f"channels {channels} % ch-shards "
                                 f"{mesh.shape['ch']} != 0")
            channels = rows * (channels // mesh.shape["ch"])
        return walk.init_state(channels, dev)

    @torch.no_grad()
    def step(states: dict, iq: torch.Tensor):
        walk.process(states, *(x.contiguous() for x in run(iq)))
        return states, states["o_count"]

    def pop(states: dict):
        return states, _pop(states)

    step.lattice = lat
    return init, step, pop


class _Words(torch.nn.Module):
    """A lattice's (bins, h, hs, valid) as one int32 [..., M, 4] tensor,
    so a grid moves it in one gather."""

    def __init__(self, lattice: torch.nn.Module):
        super().__init__()
        self.lattice = lattice

    def forward(self, iq: torch.Tensor) -> torch.Tensor:
        bins, h, hs, valid = self.lattice(iq)
        return torch.stack([bins.to(torch.int32), h.view(torch.int32),
                            hs.view(torch.int32), valid.to(torch.int32)],
                           dim=-1)


def _from_words(w: torch.Tensor):
    return (w[..., 0], w[..., 1].view(torch.float32),
            w[..., 2].view(torch.float32), w[..., 3].bool())


class DevicePyramidTracker:
    """Host handle over one on-device tracker: feed lattice blocks (device
    tensors; nothing is fetched), drain finished packets (the only copy
    to the host: O(packets) bytes).

    Drop-in for PyramidTracker at the block level; feeding
    ``flush_hops()`` empty hops retires all live state like the host's
    empty steps."""

    def __init__(self, cfg: LoraConfig, max_peaks: int = 16, grace: int = 0,
                 device=DEFAULT_DEVICE, **pools):
        self.cfg = cfg
        self.grace = grace
        self.device = resolve_device(device)
        self.walk = make_device_tracker(cfg, max_peaks, grace, **pools)
        self.state = self.walk.init_state(1, self.device)
        self._max_peaks = max_peaks

    def feed(self, bins, h, hs, valid) -> None:
        """One stream's ``[H, M]`` block (numpy or tensors)."""
        x = [(a if isinstance(a, torch.Tensor) else torch.from_numpy(
                 np.array(a))).to(self.device, dt).contiguous()[None]
             for a, dt in ((bins, torch.int32), (h, torch.float32),
                           (hs, torch.float32), (valid, torch.bool))]
        self.walk.process(self.state, *x)

    def feed_empty(self, num_hops: int) -> None:
        z = torch.zeros((num_hops, self._max_peaks), dtype=torch.int32)
        self.feed(z, z.float(), z.float(), z.bool())

    def flush_hops(self) -> int:
        return flush_hops(self.grace)

    def drain(self):
        """Fetch finished packets; returns (symbol arrays, positions)."""
        cnt, o_len, o_pos, o_syms = _pop(self.state)
        n = int(cnt[0])
        syms = [o_syms[0, i, :o_len[0, i]].astype(np.uint16)
                for i in range(n)]
        return syms, [int(p) for p in o_pos[0, :n]]

    def stats(self) -> dict:
        s = counter_totals(self.state)
        del s["deviations"]
        return s

    def deviations(self) -> int:
        """Total bounded-pool deviation events (0 = host-exact semantics)."""
        return counter_totals(self.state)["deviations"]
