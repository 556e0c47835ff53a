"""Device-resident sample ring: the gateway's stream buffer lives in
device memory.

Twin of gr_lora_tpu/pipeline/device_ring.py.  `DeviceRing` holds a
contiguous live span inside a fixed [C, cap, 2] float32 tensor on its
device, so samples cross the host link exactly once: appends copy into the
span's end, scan chunks are views of it and event windows are gathered
device to device.  The live span is compacted (one on-device copy) only
when an append would run off the end, and the buffer grows geometrically
if a feed outsizes it.

Coordinates are the caller's absolute sample indices minus the span start
(the gateway's ``_base`` bookkeeping maps 1:1).

The JAX ring takes a ``sharding`` (its buffer split over a mesh's ``ch``
axis) because one controller holds every channel as one global array.
Here each rank of a shard grid is its own process with its own ring, and
the gated gateway (dist/collision_gateway.py) gives it only the channels
of the rows that rank holds: a rank's ring holds only its own rows, so
it needs no sharding of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device

__all__ = ["DeviceRing"]


class DeviceRing:
    """Contiguous device-resident window of a multi-channel sample stream.

    ``history`` pre-fills that many zero samples so reads up to `history`
    before the first appended sample are well-defined (the gateways' window
    lead at stream start).  Offsets passed to :meth:`slice` / :meth:`gather`
    are relative to that zero history's start.
    """

    def __init__(self, channels: int, cap: int, history: int = 0,
                 width: int = 2,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.channels = channels
        self.width = width
        self.device = resolve_device(device)
        self.cap = max(1 << int(np.ceil(np.log2(max(cap, 1024)))), 1024)
        self._buf = torch.zeros((channels, self.cap, width),
                                dtype=torch.float32, device=self.device)
        self._off = 0              # ring coord of live-span start
        self.length = history      # live span length (incl. zero history)
        #: Host->device bytes moved by :meth:`append` (device-resident
        #: inputs are copied device to device and do not count).
        self.ingest_bytes = 0

    def _compact(self) -> None:
        if self._off:
            live = self._buf[:, self._off:self._off + self.length].clone()
            self._buf[:, :self.length] = live
            self._off = 0

    def _ensure(self, extra: int) -> None:
        need = self.length + extra
        if need > self.cap:                       # grow (rare)
            newcap = 1 << int(np.ceil(np.log2(need + (need >> 2))))
            buf = torch.zeros((self.channels, newcap, self.width),
                              dtype=torch.float32, device=self.device)
            buf[:, :self.length] = self._buf[:, self._off:
                                             self._off + self.length]
            self._buf, self._off, self.cap = buf, 0, newcap
        elif self._off + need > self.cap:         # compact in place
            self._compact()

    def append(self, chunk) -> None:
        """chunk [C, L, width]: host ndarray (uploaded once) or a tensor
        (copied device to device when it already lies on the ring's
        device)."""
        if isinstance(chunk, np.ndarray):
            self.ingest_bytes += chunk.nbytes
            chunk = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        if chunk.shape[0] != self.channels or chunk.shape[2] != self.width:
            raise ValueError(f"chunk {tuple(chunk.shape)} does not match "
                             f"[{self.channels}, L, {self.width}]")
        lg = int(chunk.shape[1])
        self._ensure(lg)
        lo = self._off + self.length
        self._buf[:, lo:lo + lg] = chunk.to(self.device, torch.float32)
        self.length += lg

    def trim(self, cut: int) -> None:
        """Logically drop the oldest `cut` samples (no device work; the
        space is reclaimed by the next overflow compaction)."""
        if not 0 <= cut <= self.length:
            raise ValueError(f"trim {cut} outside [0, {self.length}]")
        self._off += cut
        self.length -= cut

    def sync(self) -> None:
        """Block until pending appends have executed (used to attribute
        upload time to the caller's ingest wall)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def slice(self, lo: int, size: int) -> torch.Tensor:
        """[C, size, width] of span offsets [lo, lo+size): a view, valid
        until the next append."""
        if not (0 <= lo and lo + size <= self.length):
            raise ValueError((lo, size, self.length))
        return self._buf[:, self._off + lo:self._off + lo + size]

    def gather(self, chs, los, size: int) -> torch.Tensor:
        """[E, size, width] windows (a new tensor) at (channel, span
        offset) pairs.  Each window must lie inside the live span."""
        chs = np.asarray(chs, np.int64)
        los = np.asarray(los, np.int64)
        if np.any(los < 0) or np.any(los + size > self.length):
            raise ValueError((los, size, self.length))
        return torch.stack([
            self._buf[int(c), self._off + int(lo):self._off + int(lo) + size]
            for c, lo in zip(chs, los)])
