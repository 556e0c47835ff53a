"""Multi-channel, multi-device LoRa gateway receiver: the FSM over a shard
grid.

Twin of gr_lora_tpu/dist/gateway.py.  The two scaling axes are the axes of
a ``dist/mesh.ShardGrid``:

- ``ch`` (data parallel): independent channels are split over the grid's
  rows and batched within a slot.
- ``t`` (sequence parallel): the stream is split into fixed time blocks
  with **overlap-save halos**.  Each shard receives a left halo (enough
  past samples to see a packet's full preamble, so every shard detects a
  boundary packet at the same sample index) and a right halo (enough
  future samples to finish any packet that *starts* in its own region).
  Halos move by the grid's ``shift_t`` (``lax.ppermute``): shard 0 gets a
  zero left halo and the last shard a zero right halo.

Ownership rule: a shard keeps exactly the packets whose preamble-detection
index falls inside its own (non-halo) region, so a packet is decoded once.

Where JAX runs one ``shard_map`` body a device, a rank here runs its slots
as lanes of one call of ``models/demodulator.demod_fn`` over the extended
window ``[lh + block + rh]``: one FSM step loop a rank, whatever its slot
count.  Outputs are the JAX package's: without ``gather_results`` a rank
fills its own slots (the others read empty: position -1, length and count
0); with it every rank gets every slot's (an all-gather).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import LoraConfig
from ..device import DEFAULT as DEFAULT_DEVICE
from ..models.demodulator import demod_fn, max_packet_symbols
from ..models.modulator import NUM_PREAMBLE_CHIRPS, packet_duration
from .mesh import ShardGrid, Sharded, group_info, slot_grid

_INT32_MAX = np.iinfo(np.int32).max


def make_mesh(num_channel_shards: int = 1, num_time_shards: int | None = None,
              devices=None, device=DEFAULT_DEVICE) -> ShardGrid:
    """Shard grid over {ch, t}.  Default: every rank of the process group
    (one rank without one) on the time axis, one slot each on ``device``
    (the card unless the caller asks for the CPU).  ``devices`` gives the
    slots explicitly, ``ch`` the slower axis, repeats allowed: a device
    (a slot of this rank) or a ``(rank, device)`` pair."""
    me, world, _ = group_info()
    if devices is None:
        slots = [(r, device) for r in range(world)]
    else:
        slots = [d if isinstance(d, tuple) else (me, d) for d in devices]
    return ShardGrid(slot_grid(num_channel_shards, num_time_shards, slots))


def left_halo_len(cfg: LoraConfig) -> int:
    """Past samples each time shard needs: the preamble+sync+SFD span plus
    the demodulator's own history prefill, so a packet detected near a block
    boundary is detected at the same absolute index by both shards."""
    n = cfg.num_samples
    return (NUM_PREAMBLE_CHIRPS + 2 + 3) * n  # 8 pre + 2 sync + 2.25 SFD + slack


def right_halo_len(cfg: LoraConfig) -> int:
    """Future samples each time shard needs: the longest packet span, so any
    packet that starts inside the shard's own region finishes inside its
    extended window."""
    return packet_duration(max_packet_symbols(cfg), cfg) + 2 * cfg.num_samples


class GatewayPlan(NamedTuple):
    fn: object            # iq [C, T, 2] or Sharded -> (syms, lens, pos, cnt, dropped, snr)
    mesh: ShardGrid
    block_len: int        # samples per time shard (own region)
    max_packets: int      # per (channel, time-shard)
    num_channels: int


def make_gateway(cfg: LoraConfig, mesh: ShardGrid, num_channels: int,
                 block_len: int, max_packets: int = 8,
                 gather_results: bool = False) -> GatewayPlan:
    """Build the gateway receive step.

    Input: float32 ``iq[num_channels, nt*block_len, 2]`` (numpy or a
    tensor; each rank copies only its slots' pieces to its device) or a
    ``Sharded`` (``dist/multihost.process_local_input``).  Output, tensors
    on the rank's device: ``syms int32[C, nt*max_packets, MS]``, ``lens
    int32[C, nt*max_packets]``, ``pos int32[C, nt*max_packets]`` (global
    sample index of detection, -1 for empty slots), ``cnt int32[C, nt]``,
    ``dropped int32[C, nt]`` (completed packets that overflowed a shard's
    ``max_packets`` slots — visible, not silent), ``snr float32[C,
    nt*max_packets]``.

    ``gather_results=True`` all-gathers the (tiny) packet outputs over the
    whole grid so every rank reads every slot's — required across ranks
    (dist/multihost.py), where a rank computes only the slots it holds.
    """
    nt, nch = mesh.shape["t"], mesh.shape["ch"]
    if num_channels % nch:
        raise ValueError(f"num_channels {num_channels} % ch-shards {nch} != 0")
    lh, rh = left_halo_len(cfg), right_halo_len(cfg)
    if block_len < max(lh, rh):
        raise ValueError(f"block_len {block_len} is shorter than a halo "
                         f"(left {lh}, right {rh})")
    cpr = num_channels // nch
    mp = max_packets
    demod = demod_fn(cfg, lh + block_len + rh, mp, device=mesh.device)
    t_idx = mesh.axis_index("t")

    @torch.no_grad()
    def fn(iq):
        if isinstance(iq, Sharded):
            own = iq.local
        else:
            if not isinstance(iq, torch.Tensor):
                iq = torch.from_numpy(np.ascontiguousarray(iq, np.float32))
            if tuple(iq.shape) != (num_channels, nt * block_len, 2):
                raise ValueError(f"iq has shape {tuple(iq.shape)}, plan "
                                 f"takes [{num_channels}, {nt * block_len}, 2]")
            own = mesh.scatter(iq)
        own = own.to(mesh.device, torch.float32)       # [L, cpr, block, 2]
        nl = own.shape[0]
        # Left halo: the left neighbour's last lh samples (zeros for shard
        # 0); right halo: the right neighbour's first rh (zeros for the
        # last shard).
        left = mesh.shift_t(own[:, :, -lh:].contiguous(), 1)
        right = mesh.shift_t(own[:, :, :rh].contiguous(), -1)
        ext = torch.cat([left, own, right], dim=2)
        syms, lens, pos, cnt, dropped, snr = demod(
            ext.reshape(nl * cpr, -1, 2))
        syms = syms.reshape(nl, cpr, mp, -1)
        lens, pos, snr = (a.reshape(nl, cpr, mp) for a in (lens, pos, snr))
        # Ownership: detection index inside [lh, lh + block_len); owned
        # packets compacted to the front of each channel's slots, in
        # position order (a stable sort, as jnp.argsort).
        own_pkt = (pos >= lh) & (pos < lh + block_len)
        key = torch.where(own_pkt, pos, torch.full_like(pos, _INT32_MAX))
        order = torch.argsort(key, dim=-1, stable=True)
        syms = torch.take_along_dim(syms, order[..., None], dim=2)
        lens = torch.take_along_dim(torch.where(own_pkt, lens, 0), order,
                                    dim=2)
        gpos = pos - lh + (t_idx * block_len).to(pos.dtype)[:, None, None]
        gpos = torch.take_along_dim(torch.where(own_pkt, gpos, -1), order,
                                    dim=2)
        snr = torch.take_along_dim(torch.where(own_pkt, snr, 0.0), order,
                                   dim=2)
        cnt = own_pkt.sum(-1, dtype=torch.int32)[..., None]
        dropped = dropped.reshape(nl, cpr, 1).to(torch.int32)
        outs = (syms, lens, gpos, cnt, dropped, snr)
        fills = (0, 0, -1, 0, 0, 0.0)
        return tuple(_rows(mesh.all_gather(o) if gather_results
                           else mesh.place(o, f))
                     for o, f in zip(outs, fills))

    return GatewayPlan(fn, mesh, block_len, max_packets, num_channels)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[nch, nt, cpr, S, ...] grid of slot outputs -> [C, nt*S, ...]."""
    s = x.shape
    return x.transpose(1, 2).reshape(s[0] * s[2], s[1] * s[3], *s[4:])


def gateway_receive(plan: GatewayPlan, iq, cfg: LoraConfig,
                    return_stats: bool = False):
    """Host convenience: run the gateway step and collect per-channel packet
    symbol lists (uint16 arrays), position-sorted.  With ``return_stats``,
    also returns {"dropped": int} so slot overflow is observable."""
    syms, lens, pos, cnt, dropped, snr = (a.cpu().numpy()
                                          for a in plan.fn(iq))
    out = []
    for c in range(syms.shape[0]):
        live = [(int(pos[c, r]), syms[c, r, :lens[c, r]].astype(np.uint16))
                for r in range(syms.shape[1]) if pos[c, r] >= 0]
        live.sort(key=lambda t: t[0])
        out.append(live)
    if return_stats:
        return out, {"dropped": int(np.sum(dropped))}
    return out
