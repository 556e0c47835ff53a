"""The shard grid: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package shards a gateway over a ``{ch, t}`` device mesh with one
controller: ``shard_map`` bodies exchange halos with ``lax.ppermute`` and
gather with ``lax.all_gather`` inside one jitted program.  PyTorch's idiom
is one process (rank) a device, joined by ``torch.distributed``.  Here a
``ShardGrid`` is a ``{ch, t}`` grid of shard slots, each slot a
``(rank, device)`` pair, and it gives the primitives those bodies use:

- ``shift_t`` (``ppermute`` along ``t``): each slot receives a tensor from
  its ``t`` neighbour; a slot with no source gets zeros, as in JAX.
  Between slots of one rank this is an index copy on the device; between
  ranks, ``dist.batch_isend_irecv``.
- ``all_gather``: every slot's tensor on every rank, laid out on the grid
  (gathers along ``t`` or ``ch`` are slices of it).  Between ranks,
  ``dist.all_gather_into_tensor``.
- ``axis_index``.

A rank may hold several slots: the CPU tests put 8 slots in one process on
``"cpu"``, as the JAX tests use 8 virtual devices, and one card holds a
``{2, 4}`` grid.  A rank's slots lie on one device and a rank's tensors
carry them as a leading axis (``[L, ...]``, the rank's slots in grid
order), so its slots run as lanes of one batched call, never one call a
slot.

The backend is the caller's: ``"nccl"`` for one card a rank, ``"gloo"``
for the CPU (``dist/multihost.initialize``).  Gloo's point-to-point ops
take host tensors (in torch 2.11 on the H100 a send of a CUDA tensor
fails, "writev: Bad address", and gloo then aborts the process:
tests/torch_multihost_worker.py ``gloo_cuda_p2p``), so under ``"gloo"``
a halo on a CUDA device crosses to a peer through an explicit pinned
host copy: that is this backend's data path, not a fallback, and
everything else (the FSM, the lattices, the tracker walk) still runs on
the card.  Gloo's collectives take CUDA tensors there
(``all_gather_into_tensor``, ``all_gather``, ``all_reduce`` and
``broadcast``, each result checked: ``chip_smoke.py`` phase 12d), so
the all-gather passes them as they are.
Without an initialised process group the grid is one rank's (rank 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve as resolve_device

AXES = ("ch", "t")


def group_info() -> tuple[int, int, str | None]:
    """(rank, world, backend) of the process group, or of a lone process
    when none is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, None
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


class RowLayout(NamedTuple):
    """``ShardGrid.row_layout``: the rows whose tracker this rank runs,
    whether a row spans ranks (its data then gathers along ``t``), and the
    rows the rank is fed: ``fed_rows`` of them from row ``fed_lo``."""
    rows: list
    gather_t: bool
    fed_lo: int
    fed_rows: int


class ShardGrid:
    """A ``{ch, t}`` grid of shard slots over the ranks of the process
    group.

    ``slots`` is ``[nch][nt]`` of ``(rank, device)``; this rank's slots
    must share one device, which is resolved (a CUDA device raises where
    none is present); other ranks' devices are theirs to know.  Every
    rank of the group holds at least one slot, so every rank takes part
    in each collective.  ``shape`` is ``{"ch": nch, "t": nt}`` as a JAX
    mesh's."""

    def __init__(self, slots):
        rows = [list(r) for r in slots]
        nch, nt = len(rows), len(rows[0]) if rows else 0
        if nch == 0 or nt == 0 or any(len(r) != nt for r in rows):
            raise ValueError("slots must be a non-empty [ch][t] grid")
        self.rank, self.world, self.backend = group_info()
        self.ranks = np.array([[int(r) for r, _ in row] for row in rows])
        if self.ranks.min() < 0 or self.ranks.max() >= self.world:
            raise ValueError(f"slot ranks {sorted(set(self.ranks.flat))} "
                             f"outside a world of {self.world}")
        held = set(self.ranks.flat)
        if held != set(range(self.world)):
            raise ValueError(f"ranks {sorted(set(range(self.world)) - held)} "
                             "hold no slot")
        self.shape = {"ch": nch, "t": nt}
        #: This rank's slots, (ch index, t index), in grid order.
        self.local = [(c, t) for c in range(nch) for t in range(nt)
                      if self.ranks[c, t] == self.rank]
        devs = {torch.device(rows[c][t][1]) for c, t in self.local}
        if len(devs) != 1:
            raise ValueError(f"rank {self.rank}'s slots lie on {devs}: one "
                             "device a rank")
        self.device = resolve_device(devs.pop())
        self._slot = {s: j for j, s in enumerate(self.local)}
        # A rank's slots in grid order, for every rank: the all-gather's
        # layout.
        self._rank_slots = [[(c, t) for c in range(nch) for t in range(nt)
                             if self.ranks[c, t] == r]
                            for r in range(self.world)]
        self._lmax = max(len(s) for s in self._rank_slots)
        self._shift_plans: dict = {}

    def axis_index(self, axis: str) -> torch.Tensor:
        """int64 [L]: each local slot's index along ``axis``."""
        k = AXES.index(axis)
        return torch.tensor([s[k] for s in self.local], dtype=torch.int64,
                            device=self.device)

    def local_rect(self) -> tuple[int, int, int, int]:
        """``(c_lo, c_hi, t_lo, t_hi)`` of this rank's slots, which must
        fill that rectangle of the grid."""
        cs = [c for c, _ in self.local]
        ts = [t for _, t in self.local]
        c_lo, c_hi, t_lo, t_hi = min(cs), max(cs) + 1, min(ts), max(ts) + 1
        if len(self.local) != (c_hi - c_lo) * (t_hi - t_lo):
            raise ValueError(f"rank {self.rank}'s slots {self.local} do not "
                             "fill a rectangle of the grid")
        return c_lo, c_hi, t_lo, t_hi

    def row_layout(self) -> RowLayout:
        """Which rows this rank tracks and feeds (the JAX gateways'
        multi-host row analysis).  A row is tracked by the rank holding its
        first ``t`` slot.  One rank feeds every row.  Across ranks, where
        no row spans ranks (the row-owned layout) a rank feeds its own
        rows, which must be contiguous and at least one; where one does
        (the gathered layout), every rank feeds every row and a row's data
        gathers along ``t``."""
        nch = self.shape["ch"]
        rows = [c for c in range(nch) if self.ranks[c, 0] == self.rank]
        spans = any(len(set(self.ranks[c])) > 1 for c in range(nch))
        if self.world == 1 or spans:
            return RowLayout(rows, spans, 0, nch)
        if not rows:
            raise ValueError(
                f"rank {self.rank} holds no grid ch-row; in the row-owned "
                "layout every rank must own >= 1 channel row (time-spanning "
                "rows switch to the gathered layout instead)")
        if rows != list(range(rows[0], rows[-1] + 1)):
            raise ValueError("the rank's ch-rows must be contiguous")
        return RowLayout(rows, False, rows[0], len(rows))

    # -- data movement ----------------------------------------------------
    def _staged(self) -> bool:
        """Gloo's point-to-point ops take host tensors: a CUDA tensor
        crosses through pinned host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend sends it point to point."""
        x = x.contiguous()
        if not self._staged():
            return x
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _wire_empty(self, shape, dtype) -> torch.Tensor:
        if self._staged():
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _shift_plan(self, step: int):
        """(local dst, local src) index tensors, then the cross-rank
        (slot, peer, tag, is_send) list, in grid order on every rank."""
        if step not in self._shift_plans:
            nch, nt = self.shape["ch"], self.shape["t"]
            dst, src, p2p = [], [], []
            for c in range(nch):
                for t in range(nt):
                    s = t - step
                    if not 0 <= s < nt:
                        continue
                    rs, rd = self.ranks[c, s], self.ranks[c, t]
                    if rs == rd == self.rank:
                        dst.append(self._slot[(c, t)])
                        src.append(self._slot[(c, s)])
                    elif rs == self.rank:
                        p2p.append((self._slot[(c, s)], int(rd), c * nt + t,
                                    True))
                    elif rd == self.rank:
                        p2p.append((self._slot[(c, t)], int(rs), c * nt + t,
                                    False))
            as_idx = lambda v: torch.tensor(v, dtype=torch.int64,
                                            device=self.device)
            self._shift_plans[step] = (as_idx(dst), as_idx(src), p2p)
        return self._shift_plans[step]

    def shift_t(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """``ppermute`` along ``t``: local slot ``(c, t)`` gets ``x`` of
        slot ``(c, t - step)`` (``step=1``: from the left neighbour,
        ``-1``: from the right one), zeros where that slot does not
        exist.  ``x`` is [L, ...] on this rank's device."""
        if x.shape[0] != len(self.local):
            raise ValueError(f"x has {x.shape[0]} slots, rank holds "
                             f"{len(self.local)}")
        dst, src, p2p = self._shift_plan(step)
        out = torch.zeros_like(x)
        if dst.numel():
            out[dst] = x[src]
        if not p2p:
            return out
        ops, recvs = [], []
        for j, peer, tag, send in p2p:
            if send:
                ops.append(dist.P2POp(dist.isend, self._wire(x[j]), peer,
                                      tag=tag))
            else:
                buf = self._wire_empty(x.shape[1:], x.dtype)
                ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
                recvs.append((j, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for j, buf in recvs:
            out[j] = buf.to(self.device)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every slot's ``x`` ([L, ...] on each rank) on every rank, laid
        out on the grid: [nch, nt, ...].  ``lax.all_gather`` along ``t``
        is row ``c`` of it, along ``ch`` column ``t``.  Within a process
        group this is one ``all_gather_into_tensor`` over it, one rank
        or more."""
        if x.shape[0] != len(self.local):
            raise ValueError(f"x has {x.shape[0]} slots, rank holds "
                             f"{len(self.local)}")
        if self.backend is None:                # no process group
            return self.place(x)
        out = x.new_zeros((self.shape["ch"], self.shape["t"])
                          + tuple(x.shape[1:]))
        pad = x.new_zeros((self._lmax,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        got = x.new_empty((self.world * self._lmax,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(got, pad)
        for r, slots in enumerate(self._rank_slots):
            cs, ts = zip(*slots)
            out[list(cs), list(ts)] = got[r * self._lmax:
                                          r * self._lmax + len(slots)]
        return out

    def place(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """This rank's slots of ``x`` ([L, ...]) laid out on the grid,
        [nch, nt, ...], the other slots ``fill``; no communication."""
        out = x.new_full((self.shape["ch"], self.shape["t"])
                         + tuple(x.shape[1:]), fill)
        cs, ts = zip(*self.local)
        out[list(cs), list(ts)] = x
        return out

    def lattice(self, lattice: nn.Module, block_len: int,
                halo: int) -> "GridLattice":
        """``lattice`` over one block of ``block_len`` samples (and its
        ``halo`` of the stream's continuation) split on this grid."""
        return GridLattice(lattice, self, block_len, halo)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's pieces of ``x`` [C, T, ...] (every channel, the
        whole time axis), split ``C`` over ``ch`` and ``T`` over ``t``:
        [L, C / nch, T / nt, ...] on this rank's device; only those pieces
        are copied."""
        nch, nt = self.shape["ch"], self.shape["t"]
        c, t = x.shape[0], x.shape[1]
        if c % nch or t % nt:
            raise ValueError(f"[{c}, {t}] does not split over a "
                             f"{{ch: {nch}, t: {nt}}} grid")
        cc, tt = c // nch, t // nt
        return torch.stack([x[i * cc:(i + 1) * cc, j * tt:(j + 1) * tt]
                            .to(self.device) for i, j in self.local])


class GridLattice(nn.Module):
    """One block's lattice over a shard grid (``ShardGrid.lattice``; the
    JAX ``_make_batched_lattice`` mesh branch): [fed channels, block +
    halo, 2] (the rank's feed, ``ShardGrid.row_layout``) -> the tracked
    rows' [rows x cpr, hops, ...].  ``lattice`` maps [..., block / nt +
    halo, 2] to one tensor [..., hops / nt, ...]; a rank's slots are its
    lanes.  The always-on gateway (dist/pyramid_gateway.py) and the
    device tracker's plan (models/device_tracker.py) both run on it."""

    def __init__(self, lattice: nn.Module, grid: ShardGrid, block_len: int,
                 halo: int):
        super().__init__()
        nt = grid.shape["t"]
        if block_len % nt:
            raise ValueError(f"block of {block_len} samples % t-shards {nt}")
        self.lattice = lattice
        self.grid, self.layout = grid, grid.row_layout()
        self.sub, self.block_len, self.halo = block_len // nt, block_len, halo
        self.last = [j for j, (_, t) in enumerate(grid.local) if t == nt - 1]

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        grid, sub, layout = self.grid, self.sub, self.layout
        cpr = block.shape[0] // layout.fed_rows
        rows = [slice((c - layout.fed_lo) * cpr, (c - layout.fed_lo + 1) * cpr)
                for c, _ in grid.local]
        own = torch.stack([block[r, t * sub:(t + 1) * sub]
                           for r, (_, t) in zip(rows, grid.local)])
        # Right halo: the t neighbour's first halo samples; the last t
        # slot's neighbour is the stream's continuation, the tail.
        right = grid.shift_t(own[:, :, :self.halo].contiguous(), -1)
        for j in self.last:
            right[j] = block[rows[j], self.block_len:]
        ext = torch.cat([own, right], dim=2)            # [L, cpr, ext, 2]
        out = self.lattice(ext.reshape(-1, sub + self.halo, 2))
        out = out.reshape(len(grid.local), cpr, *out.shape[1:])
        full = grid.all_gather(out) if layout.gather_t \
            else grid.place(out)                 # [nch, nt, cpr, h, ...]
        mine = full[layout.rows].transpose(1, 2)
        s = mine.shape
        return mine.reshape(s[0] * s[1], s[2] * s[3], *s[4:])


class Sharded(NamedTuple):
    """One rank's share of a ``[C, T, ...]`` array split over a grid
    (``ShardGrid.scatter``'s layout: [L, C / nch, T / nt, ...] on the
    rank's device)."""
    local: torch.Tensor


def slot_grid(num_channel_shards: int, num_time_shards: int | None,
              slots: list) -> list:
    """``slots`` (a flat list of ``(rank, device)``) as the
    ``[nch][nt]`` grid, ``ch`` the slower axis; ``num_time_shards`` None
    takes all of them on ``t``."""
    if num_time_shards is None:
        num_time_shards = len(slots) // num_channel_shards
    if num_channel_shards * num_time_shards != len(slots):
        raise ValueError(f"{len(slots)} slots do not make a "
                         f"{num_channel_shards} x {num_time_shards} grid")
    return [slots[i * num_time_shards:(i + 1) * num_time_shards]
            for i in range(num_channel_shards)]
