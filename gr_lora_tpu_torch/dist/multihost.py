"""Multi-process distribution: the gateway spanning ranks.

Twin of gr_lora_tpu/dist/multihost.py.  There the processes join
``jax.distributed`` and share one global device list; here each process
is a ``torch.distributed`` rank holding its own slots of the shard grid:

- ``initialize()`` wraps ``dist.init_process_group`` with a ``tcp://``
  rendezvous at the coordinator's address.  The backend is the caller's:
  ``"nccl"`` for one card a rank, ``"gloo"`` for the CPU (or for ranks
  that share one card, which NCCL refuses).
- ``make_multihost_mesh()`` lays the ranks' slots out in rank order with
  the channel axis slowest, so ``ch`` rows stay inside a rank where they
  can (channels need no communication) and consecutive ``t`` shards cross
  a rank boundary once per seam — where the overlap-save halo
  (dist/gateway.py) pays its single exchange.
- ``process_local_input()`` takes each rank's own slice of the stream; no
  rank holds the whole capture, and each keeps only its slots' blocks on
  its device.
- Build the plan with ``make_gateway(..., gather_results=True)`` so every
  rank reads every slot's (tiny) packet outputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT as DEFAULT_DEVICE
from .gateway import GatewayPlan, gateway_receive
from .mesh import ShardGrid, Sharded, group_info, slot_grid


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str | None = None) -> None:
    """Join the process group at ``coordinator_address`` (``host:port``)
    as rank ``process_id`` of ``num_processes``.  ``backend`` must be
    given: ``"nccl"`` (one card a rank) or ``"gloo"``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_multihost_mesh(num_channel_shards: int = 1,
                        num_time_shards: int | None = None,
                        device=DEFAULT_DEVICE) -> ShardGrid:
    """{ch, t} grid over every rank, one slot each on the rank's
    ``device``, in rank order (see the module docstring).  Several slots a
    rank: ``gateway.make_mesh(devices=[(rank, device), ...])``."""
    _, world, _ = group_info()
    slots = [(r, device) for r in range(world)]
    return ShardGrid(slot_grid(num_channel_shards, num_time_shards, slots))


def time_range_of_process(plan: GatewayPlan, total_len: int) -> tuple[int, int]:
    """[start, end) sample range of the time shards this rank holds.

    Each rank feeds only its own range into ``process_local_input``: the
    stream is never whole on one rank."""
    mesh = plan.mesh
    block = total_len // mesh.shape["t"]
    my = sorted({t for _, t in mesh.local})
    lo, hi = my[0], my[-1] + 1
    if my != list(range(lo, hi)):
        raise ValueError("the rank's time shards must be contiguous (use "
                         "make_multihost_mesh)")
    return lo * block, hi * block


def process_local_input(plan: GatewayPlan, iq_local,
                        total_len: int) -> Sharded:
    """This rank's share of the global ``[C, total_len, 2]`` input from its
    own slice ``iq_local`` (``[C, hi - lo, 2]`` over the rank's time range,
    every channel or only its rows' channels): its slots' blocks, on its
    device."""
    mesh = plan.mesh
    nch, nt = mesh.shape["ch"], mesh.shape["t"]
    c_lo, c_hi, t_lo, t_hi = mesh.local_rect()
    block = total_len // nt
    x = torch.as_tensor(np.ascontiguousarray(iq_local, np.float32))
    if x.shape[1] != (t_hi - t_lo) * block:
        raise ValueError(f"iq_local spans {x.shape[1]} samples, the rank's "
                         f"time shards {(t_hi - t_lo) * block}")
    rows = plan.num_channels // nch
    if x.shape[0] == plan.num_channels:         # every channel given
        x = x[c_lo * rows:c_hi * rows]
    elif x.shape[0] != (c_hi - c_lo) * rows:
        raise ValueError(f"iq_local has {x.shape[0]} channels: the plan's "
                         f"{plan.num_channels} or the rank's "
                         f"{(c_hi - c_lo) * rows}")
    local = torch.stack([
        x[(c - c_lo) * rows:(c - c_lo + 1) * rows,
          (t - t_lo) * block:(t - t_lo + 1) * block]
        for c, t in mesh.local]).to(mesh.device)
    return Sharded(local)


def multihost_gateway_receive(plan: GatewayPlan, global_iq, cfg):
    """Run the gateway step; requires a plan built with
    ``gather_results=True`` so outputs are replicated.  Returns the same
    per-channel (position, symbols) lists as gateway_receive on every
    rank, and {"dropped": int}."""
    return gateway_receive(plan, global_iq, cfg, return_stats=True)
