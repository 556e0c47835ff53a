"""The on-device Pyramid tracker's walk: hops, then peaks, then retired
tracks and packets, serial within a channel and independent across
channels.

Replaces the nested ``lax.scan``s of ``make_device_tracker``
(gr_lora_tpu/models/device_tracker.py:85-531): the hop scan (:527), the
peak scan inside each hop (:405), the packet scans of retired tracks
(:447-486) and the expiry's assembly (:488-513).  It is not one of the
Pallas kernels: it stands where a ``lax.scan`` stood.  Eager PyTorch
would launch some thirty operations a peak a hop; the kernel
(``csrc/device_tracker.cu``) walks a whole ``[C, H, M]`` block in one
launch, one warp a channel.  It is bound by neither bytes nor operations
but by its serial chain of dependent steps (a hop's peaks, a peak's
track search, a packet's match), so its time is latency; the design keeps
a lane's track and packet slots in its registers for the whole launch,
each search a warp vote, the lattice's staging and sort on a second
warp, and the pools' bulky arrays (the rings, the packets' entries) in
shared memory where they fit a block (:meth:`TrackerWalk.instance` picks
the kernel's instance by that footprint; larger pools keep them in
global memory).

:class:`TrackerWalk` holds one configuration.  ``process(state, bins, h,
hs, valid)`` consumes a ``[C, H, M]`` lattice block and updates the
state's tensors in place (it returns the dict): on CUDA tensors it
launches the kernel and counts the launch in the module's ``launches``,
on CPU tensors it runs :meth:`TrackerWalk.plain`, which repeats the JAX
function step for step, batched over the channel axis as ``jax.vmap``
lays it out.  f32 arithmetic is bit for bit the JAX package's: each
operation rounds on its own (the kernel is built with ``-fmad=false``),
and the stable preamble height (``jnp.mean`` of 16 heights, :229-232) is
summed in index order, the order XLA's CPU reduction takes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import (PYRAMID_MAX_TRACK_PEAKS, PYRAMID_NUM_PREAMBLE,
                      PYRAMID_OVERLAP_FACTOR, PYRAMID_PACKET_POOL,
                      TIMESTAMP_MOD, LoraConfig)
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from . import _build

_OV = PYRAMID_OVERLAP_FACTOR
_RING = 2 * _OV                     # last-16 peak ring
_MID_LO = 2 * _OV                   # stable-height slice [16:32)
_MID_HI = _OV * (PYRAMID_NUM_PREAMBLE - 2)
_PRE_MIN = _OV * (PYRAMID_NUM_PREAMBLE - 1) + 2
_DATA_MAX = 2 * _OV
_TTL0 = 6 * _OV
_IMAX = int(np.iinfo(np.int32).max)
_KIND_PRE, _KIND_DATA, _KIND_BROKEN = 0, 1, 2

#: Kernel launches of :meth:`TrackerWalk.process` (one per call on CUDA
#: tensors), by instance: the shared-memory one (``launches``) and the
#: global-memory one (``global_launches``).
launches = 0
global_launches = 0

#: The state's fields in the kernel's pointer order (csrc/device_tracker.cu
#: ``State``), with their dtypes; shapes in :meth:`TrackerWalk.init_state`.
STATE_FIELDS = (
    ("t_active", torch.bool), ("t_seq", torch.int32),
    ("t_bin", torch.int32), ("t_count", torch.int32),
    ("t_updated", torch.bool), ("t_misses", torch.int32),
    ("t_ring_ts", torch.int32), ("t_ring_bin", torch.int32),
    ("t_ring_h", torch.float32), ("t_ring_hs", torch.float32),
    ("t_mid_h", torch.float32), ("s_gate", torch.bool),
    ("p_active", torch.bool), ("p_seq", torch.int32),
    ("p_ttl", torch.int32), ("p_pre_ts", torch.int32),
    ("p_pre_bin", torch.int32), ("p_pre_h", torch.float32),
    ("p_count", torch.int32), ("p_ts", torch.int32),
    ("p_bin", torch.int32), ("p_h", torch.float32),
    ("o_count", torch.int32), ("o_len", torch.int32),
    ("o_pos", torch.int32), ("o_syms", torch.int32),
    ("ts_ref", torch.int32), ("bin_ref", torch.int32),
    ("tseq", torch.int32), ("pseq", torch.int32),
    ("tracks_dropped", torch.int32), ("packets_dropped", torch.int32),
    ("tracks_overflow_finalized", torch.int32),
    ("finalize_deferred", torch.int32), ("expire_deferred", torch.int32),
    ("packet_peak_overflow", torch.int32), ("out_overflow", torch.int32),
)

#: The kernel's limits (csrc/device_tracker.cu): pools of at most 8 slots
#: a lane, at most 32 retirements a hop, 16 split groups, 64 peaks a hop.
MAX_POOL = 256
MAX_FINALIZE = 32
MAX_GROUPS = 16
MAX_PEAKS = 64
#: Shared memory one block may have on the H100 (bytes), and the lattice
#: hops the kernel stages at once.
MAX_SHARED = 232448
CHUNK_HOPS = 32
#: The kernel's C entry point of each instance.
ENTRY = {"shared": "grl_device_tracker", "global": "grl_device_tracker_global"}


def _words(n: int) -> int:
    """Bytes of n 4-byte words, rounded up to 16 (one array's room)."""
    return (4 * n + 15) // 16 * 16


class TrackerWalk:
    """One tracker configuration (``make_device_tracker``'s arguments)."""

    def __init__(self, cfg: LoraConfig, max_peaks: int = 16,
                 grace: int = 0, track_pool: int = 64,
                 packet_pool: int = PYRAMID_PACKET_POOL,
                 max_symbols: int = 96, out_pool: int = 32,
                 finalize_per_hop: int = 8, expire_per_hop: int = 4,
                 split_repeats: bool = False, quantize: str = "round"):
        if quantize not in ("floor", "round"):
            raise ValueError(f"quantize must be 'floor' or 'round': "
                             f"{quantize}")
        self.cfg = cfg
        self.K, self.Q, self.S, self.O = (track_pool, packet_pool,
                                          max_symbols, out_pool)
        self.F, self.E, self.M = finalize_per_hop, expire_per_hop, max_peaks
        self.W = self.S + 1          # assembly windows: S found + 1 miss
        self.grace = grace
        self.split = split_repeats
        self.n = cfg.num_samples
        self.k = cfg.bin_size
        self.hop = self.n // _OV
        self.tol = cfg.bin_tolerance
        self.thr = float(np.float32(cfg.threshold))
        self.ff = cfg.fft_factor
        #: bin -> symbol quantization offset ('round' default, 'floor' the
        #: bit-true reference rule).
        self.qoff = self.ff // 2 if quantize == "round" else 0
        self.lo0 = 4 * self.n + self.n // 2
        #: split_repeats keeps a whole merged run in the ring.
        self.R = _OV * (PYRAMID_NUM_PREAMBLE + 1) if split_repeats \
            else _RING
        self.G = (self.R - 1) // _OV + 1 if split_repeats else 0

    # -- state --------------------------------------------------------------
    def shapes(self, channels: int) -> dict:
        c, K, Q, S, O, R = channels, self.K, self.Q, self.S, self.O, self.R
        sh = {"t_ring_ts": (c, K, R), "t_ring_bin": (c, K, R),
              "t_ring_h": (c, K, R), "t_ring_hs": (c, K, R),
              "t_mid_h": (c, K, _MID_HI - _MID_LO),
              "p_ts": (c, Q, S), "p_bin": (c, Q, S), "p_h": (c, Q, S),
              "o_len": (c, O), "o_pos": (c, O), "o_syms": (c, O, self.W)}
        for name, _ in STATE_FIELDS:
            if name not in sh:
                sh[name] = ((c, K) if name.startswith("t_")
                            else (c, Q) if name.startswith("p_")
                            else (c,))
        return sh

    def init_state(self, channels: int, device=DEFAULT_DEVICE) -> dict:
        """A fresh state of ``channels`` trackers (the JAX ``init_state``
        under ``jax.vmap``: a leading channel axis) on ``device``, the
        card unless the caller passes ``device="cpu"``."""
        device = resolve_device(device)
        sh = self.shapes(channels)
        st = {name: torch.zeros(sh[name], dtype=dt, device=device)
              for name, dt in STATE_FIELDS}
        st["p_pre_h"].fill_(1.0)
        return st

    # -- the wrapper ----------------------------------------------------------
    def shared_bytes(self, m: int | None = None,
                     instance: str = "shared") -> int:
        """Dynamic shared memory of one channel's block for a lattice of
        ``m`` peaks a hop (``max_peaks`` by default): csrc/
        device_tracker.cu ``layout``'s sum.  The shared instance holds
        the rings ([K, R] x 4), ``t_mid_h`` and the packets' entries
        ([Q, S] x 3); both hold the lattice chunk as loaded and two sorted
        chunks (rows of m | 1: bins as given and reduced, heights; each
        with its hops' counts), the assembly's scratch and a sink word."""
        cm = CHUNK_HOPS * ((self.M if m is None else m) | 1)
        work = (11 * _words(cm) + (cm + 15) // 16 * 16
                + 2 * _words(CHUNK_HOPS) + 4 * _words(self.S)
                + _words(self.S + 1) + _words(4))
        if instance == "global":
            return work
        kr, qs = self.K * self.R, self.Q * self.S
        return (work + 4 * _words(kr) + _words(self.K * (_MID_HI - _MID_LO))
                + 3 * _words(qs))

    def instance(self, m: int | None = None) -> str:
        """The kernel's instance for these pools: ``"shared"`` where the
        bulky arrays fit a block's shared memory beside the chunk and the
        scratch, else ``"global"``."""
        return "shared" if self.shared_bytes(m) <= MAX_SHARED else "global"

    def process(self, state: dict, bins, h, hs, valid) -> dict:
        """Consume a ``[C, H, M]`` lattice block (ascending-bin order is
        established here); the state's tensors are updated in place."""
        if bins.is_cuda:
            inst = self.instance(bins.shape[-1])
            self.kernel(state, bins, h, hs, valid, inst)
            global launches, global_launches
            if inst == "shared":
                launches += 1
            else:
                global_launches += 1
            return state
        return self.plain(state, bins, h, hs, valid)

    def check(self, state: dict, bins, h, hs, valid) -> tuple[int, int]:
        """(C, H) of a block the kernel takes; raises otherwise."""
        if not (self.K <= MAX_POOL and 1 <= self.Q <= MAX_POOL
                and self.F <= MAX_FINALIZE and self.G <= MAX_GROUPS
                and self.E <= self.Q and self.O >= 1):
            raise ValueError(
                f"the tracker kernel takes pools of at most {MAX_POOL}, "
                f"at most {MAX_FINALIZE} retirements and {MAX_GROUPS} "
                "split groups a hop and expire_per_hop <= packet_pool")
        if bins.dim() != 3 or bins.shape[-1] > MAX_PEAKS:
            raise ValueError(f"the lattice must be [C, H, M <= "
                             f"{MAX_PEAKS}]: {tuple(bins.shape)}")
        c, hops = bins.shape[0], bins.shape[1]
        for x, dt in ((bins, torch.int32), (h, torch.float32),
                      (hs, torch.float32), (valid, torch.bool)):
            if (not x.is_cuda or x.dtype != dt or not x.is_contiguous()
                    or x.shape != bins.shape or x.device != bins.device):
                raise ValueError("bins, h, hs, valid must be contiguous "
                                 "CUDA int32 / f32 / f32 / bool tensors "
                                 "of one shape on one device")
        sh = self.shapes(c)
        for name, dt in STATE_FIELDS:
            t = state[name]
            if (t.dtype != dt or tuple(t.shape) != sh[name]
                    or not t.is_contiguous() or t.device != bins.device):
                raise ValueError(f"state[{name!r}] must be a contiguous "
                                 f"{dt} {sh[name]} tensor on "
                                 f"{bins.device}")
        return c, hops

    def kernel(self, state: dict, bins, h, hs, valid,
               instance: str | None = None) -> None:
        """Launch ``csrc/device_tracker.cu`` (no count): the instance
        :meth:`instance` picks, or the one named, for tests and for timing
        one instance against the other (the shared one raises where the
        pools do not fit)."""
        c, hops = self.check(state, bins, h, hs, valid)
        instance = instance or self.instance(bins.shape[-1])
        if instance not in ENTRY:
            raise ValueError(f"instance must be one of {sorted(ENTRY)}: "
                             f"{instance!r}")
        if c == 0 or hops == 0:
            return
        ptrs = (ctypes.c_void_p * len(STATE_FIELDS))(
            *(state[name].data_ptr() for name, _ in STATE_FIELDS))
        params = (ctypes.c_int * 22)(
            c, hops, bins.shape[-1], self.K, self.Q, self.S, self.O,
            self.F, self.E, self.R, self.G, self.n, self.k, self.hop,
            self.tol, self.ff, self.qoff, self.lo0, self.grace,
            int(self.split), PYRAMID_MAX_TRACK_PEAKS, TIMESTAMP_MOD)
        lib = _build.library()
        with torch.cuda.device(bins.device):
            err = getattr(lib, ENTRY[instance])(
                ptrs, params, self.thr, bins.data_ptr(), h.data_ptr(),
                hs.data_ptr(), valid.data_ptr(), _build.stream_of(bins))
        _build.check(ENTRY[instance], err)

    # -- the plain version ----------------------------------------------------
    def plain(self, state: dict, bins, h, hs, valid) -> dict:
        """:meth:`process` in plain PyTorch, batched over the channels.
        Steps that change nothing on any channel (an invalid peak, a hop
        with no track or packet to retire) are skipped on the host."""
        st = {key: v.clone() for key, v in state.items()}
        key = torch.where(valid, bins, torch.full_like(bins, self.k + 1))
        order = torch.argsort(key, dim=-1, stable=True)
        bins, h, hs, valid = (x.gather(-1, order)
                              for x in (bins, h, hs, valid))
        mmax = valid.sum(-1).amax(0).tolist() if bins.shape[0] else []
        for t, mt in enumerate(mmax):
            for m in range(mt):
                self._peak_step(st, bins[:, t, m], h[:, t, m],
                                hs[:, t, m], valid[:, t, m])
            self._hop_tail(st)
        for name, v in st.items():
            state[name].copy_(v)
        return state

    def _f32(self, x, like):
        return torch.full_like(like, x, dtype=torch.float32)

    def _peak_step(self, st, b, hv, hsv, v):
        """find_and_add_peak (:162-194) for one peak of every channel."""
        K, R, k = self.K, self.R, self.k
        dev = b.device
        ar = torch.arange(K, device=dev)
        cur = (k + b - st["bin_ref"]) % k
        d = (cur[:, None] - st["t_bin"]) % k
        match = st["t_active"] & ((d <= self.tol) | (d >= k - self.tol))
        any_m = match.any(1)
        mi = torch.where(match, st["t_seq"],
                         torch.full_like(st["t_seq"], _IMAX)).argmin(1)
        free = ~st["t_active"]
        any_f = free.any(1)
        fi = free.to(torch.uint8).argmax(1)
        creating = v & ~any_m & any_f
        do = v & (any_m | any_f)
        idx = torch.where(any_m, mi, fi)
        oh = ar[None, :] == idx[:, None]
        od = oh & do[:, None]
        oc = oh & creating[:, None]
        st["t_active"] = st["t_active"] | od
        st["t_seq"] = torch.where(oc, st["tseq"][:, None], st["t_seq"])
        st["t_bin"] = torch.where(oc, cur[:, None], st["t_bin"])
        st["t_misses"] = torch.where(oc, 0, st["t_misses"])
        st["t_updated"] = st["t_updated"] | od
        cnt0 = torch.where(creating, 0,
                           st["t_count"].gather(1, idx[:, None])[:, 0])
        slot = cnt0 % R
        ring = od[:, :, None] & (torch.arange(R, device=dev)[None, :]
                                 == slot[:, None])[:, None, :]
        st["t_ring_ts"] = torch.where(ring, st["ts_ref"][:, None, None],
                                      st["t_ring_ts"])
        st["t_ring_bin"] = torch.where(ring, b[:, None, None],
                                       st["t_ring_bin"])
        st["t_ring_h"] = torch.where(ring, hv[:, None, None],
                                     st["t_ring_h"])
        st["t_ring_hs"] = torch.where(ring, hsv[:, None, None],
                                      st["t_ring_hs"])
        nmid = _MID_HI - _MID_LO
        mid_j = (cnt0 - _MID_LO).clamp(0, nmid - 1)
        in_mid = (cnt0 >= _MID_LO) & (cnt0 < _MID_HI)
        mm = (od & in_mid[:, None])[:, :, None] & (
            torch.arange(nmid, device=dev)[None, :] == mid_j[:, None]
        )[:, None, :]
        st["t_mid_h"] = torch.where(mm, hv[:, None, None], st["t_mid_h"])
        st["t_count"] = torch.where(od, (cnt0 + 1)[:, None], st["t_count"])
        st["tseq"] = st["tseq"] + creating.to(torch.int32)
        st["tracks_dropped"] = st["tracks_dropped"] \
            + (v & ~any_m & ~any_f).to(torch.int32)

    def _classify(self, count, ring_ts, ring_bin, ring_h, ring_hs, mid_h):
        """get_central_peak (:197-241) over [C, F] candidates."""
        R, n = self.R, self.n
        dev = count.device
        ar = torch.arange(_RING, device=dev)
        lin = (count - _RING)[..., None] + ar
        idxs = lin % R
        lin_ts, lin_bin, lin_h, lin_hs = (
            x.gather(-1, idxs) for x in (ring_ts, ring_bin, ring_h, ring_hs))
        lin_valid = lin >= 0
        ninf = torch.full_like(lin_h, -torch.inf)
        di = torch.where(lin_valid, lin_h, ninf).argmax(-1, keepdim=True)
        data = (lin_ts.gather(-1, di)[..., 0], lin_bin.gather(-1, di)[..., 0],
                lin_h.gather(-1, di)[..., 0])
        r_idx = torch.where(ar >= _RING - _OV, lin_h, ninf).argmax(-1)
        start = r_idx
        stop = torch.zeros_like(count, dtype=torch.bool)
        thr = self._f32(self.thr, lin_hs[..., 0])
        for _ in range(_OV // 2):
            in_loop = ~stop & (start > r_idx - _OV // 2)
            prev = lin_hs.gather(-1, (start - 1).clamp(min=0)[..., None])[
                ..., 0]
            here = lin_hs.gather(-1, start[..., None])[..., 0]
            brk = (prev > here) | (here < thr)
            start = torch.where(in_loop & ~brk, start - 1, start)
            stop = stop | ~in_loop | brk
        ai = torch.where(ar >= start[..., None], lin_hs,
                         ninf).argmax(-1, keepdim=True)
        total = mid_h[..., 0]
        for j in range(1, mid_h.shape[-1]):     # index order, as XLA sums
            total = total + mid_h[..., j]
        pre = ((lin_ts.gather(-1, ai)[..., 0] + n // 4) % TIMESTAMP_MOD,
               lin_bin.gather(-1, ai)[..., 0],
               total / self._f32(mid_h.shape[-1], total))
        kind = torch.where(count >= _PRE_MIN, _KIND_PRE,
                           torch.where((count >= 2) & (count <= _DATA_MAX),
                                       _KIND_DATA, _KIND_BROKEN))
        is_pre = kind == _KIND_PRE
        return (kind, *(torch.where(is_pre, p, d) for p, d in zip(pre, data)))

    def _split_extract(self, count, ring_ts, ring_bin, ring_h, ring_hs):
        """split_extract (:247-269) over [C, F] candidates."""
        R, G, n, k, mod = self.R, self.G, self.n, self.k, TIMESTAMP_MOD
        dev = count.device
        lin = (count - R)[..., None] + torch.arange(R, device=dev)
        idxs = lin % R
        ts, bn, h, hs = (x.gather(-1, idxs)
                         for x in (ring_ts, ring_bin, ring_h, ring_hs))
        val = lin >= 0
        ninf = torch.full_like(h, -torch.inf)
        hmax = torch.where(val, h, ninf).amax(-1)
        ai = (val & (h >= self._f32(0.95, hmax)[..., None] * hmax[..., None])
              ).to(torch.uint8).argmax(-1, keepdim=True)
        ats = ts.gather(-1, ai)
        rel = (ts - ats) % mod
        g = (rel + n // 2) // n
        use = val & (rel <= mod // 2) & (g < G)
        ag = torch.arange(G, device=dev)
        gm = (g[..., None, :] == ag[:, None]) & use[..., None, :]
        hmask = torch.where(gm, h[..., None, :], ninf[..., None, :])
        bi = hmask.argmax(-1)
        bh = hmask.amax(-1)
        ok = gm.any(-1) & (bh >= self._f32(0.7, hmax)[..., None]
                           * hmax[..., None])
        snap = (ats + ag * n) % mod
        dt = (snap - ts.gather(-1, bi) + n // 2) % mod - n // 2
        sbn = (bn.gather(-1, bi) + dt * k // n) % k
        sh = torch.where(ok, h.gather(-1, bi), torch.zeros_like(bh))
        return snap, sbn, sh, ok, ok.sum(-1)

    def _hop_tail(self, st):
        """The rest of hop_body (:407-516): retirement, packet matching,
        expiry and assembly, the clocks."""
        K, F = self.K, self.F
        dev = st["t_active"].device
        active = st["t_active"]
        over = active & (st["t_count"] >= PYRAMID_MAX_TRACK_PEAKS)
        upd = st["t_updated"]
        graced = (st["t_misses"] < self.grace) & (st["t_count"] > _DATA_MAX)
        idle = active & ~over & ~upd & ~graced
        keep = active & ~over & ~idle
        retire = bool((over | idle).any())
        if retire:
            n_over = over.sum(1).to(torch.int32)
            n_idle = idle.sum(1).to(torch.int32)
            imax = torch.full_like(st["t_seq"], _IMAX)
            io = torch.argsort(torch.where(over, st["t_seq"], imax), dim=1,
                               stable=True)
            ii = torch.argsort(torch.where(idle, st["t_seq"], imax), dim=1,
                               stable=True)
            fr = torch.arange(F, device=dev)
            cand = torch.where(
                fr[None, :] < n_over[:, None],
                io[:, fr.clamp(max=K - 1)],
                ii.gather(1, (fr[None, :] - n_over[:, None]).clamp(0, K - 1)))
            cand_ok = fr[None, :] < torch.minimum(
                n_over + n_idle, torch.full_like(n_over, F))[:, None]
            st["finalize_deferred"] = st["finalize_deferred"] + (
                n_over + n_idle - F).clamp(min=0)
            cnts = st["t_count"].gather(1, cand)

            def rows(name):
                x = st[name]
                return x.gather(1, cand[:, :, None].expand(
                    -1, -1, x.shape[-1]))

            rings = [rows(x) for x in ("t_ring_ts", "t_ring_bin",
                                       "t_ring_h", "t_ring_hs")]
            kinds, ats, abin, ah = self._classify(cnts, *rings,
                                                  rows("t_mid_h"))
            add_ok = cand_ok & (kinds != _KIND_BROKEN)
            if self.split:
                sp = self._split_extract(cnts, *rings)
            proc = torch.zeros((active.shape[0], K + 1), dtype=torch.bool,
                               device=dev)
            proc.scatter_(1, torch.where(cand_ok, cand, K), True)
            proc = proc[:, :K]
            st["tracks_overflow_finalized"] = \
                st["tracks_overflow_finalized"] + (proc & over).sum(1).to(
                    torch.int32)
            st["t_active"] = active & ~proc
        st["t_misses"] = torch.where(
            keep & upd, 0,
            torch.where(keep & ~upd, st["t_misses"] + 1, st["t_misses"]))
        st["t_updated"] = torch.where(keep, False, st["t_updated"])
        if retire:
            if not self.split:
                for f in range(F):
                    if bool(add_ok[:, f].any()):
                        self._pkt_step(st, kinds[:, f], ats[:, f],
                                       abin[:, f], ah[:, f], add_ok[:, f])
            else:
                self._split_steps(st, cand_ok, cnts, kinds, ats, abin, ah,
                                  add_ok, sp)
        self._expire(st)
        st["ts_ref"] = (st["ts_ref"] + self.hop) % TIMESTAMP_MOD
        st["bin_ref"] = (st["bin_ref"] + self.k // _OV) % self.k

    def _split_steps(self, st, cand_ok, cnts, kinds, ats, abin, ah, add_ok,
                     sp):
        """The split-mode packet entries (:451-486): G + 1 a candidate."""
        sp_ts, sp_bin, sp_h, sp_ok, m_eff = sp
        F, G, R = self.F, self.G, self.R
        is_pre = kinds == _KIND_PRE
        is_data = kinds == _KIND_DATA
        is_brk = kinds == _KIND_BROKEN
        can_split = cand_ok & (m_eff >= 2)
        cond_a = can_split & is_pre & (cnts < R)
        cond_bc = can_split & ((is_data & (cnts > _OV + 2)
                                & (cnts < _PRE_MIN))
                               | (is_brk & (cnts > _DATA_MAX)
                                  & (cnts < _PRE_MIN)))
        fvi = sp_ok.to(torch.uint8).argmax(-1, keepdim=True)
        zero = torch.zeros_like(kinds)
        ctl0 = torch.where(cond_a, 3, torch.where(
            cond_bc, 0, torch.where(add_ok & is_pre, 1, torch.where(
                add_ok & is_data, 2, zero))))
        probe = torch.arange(G, device=kinds.device) == fvi
        tail = torch.where(~sp_ok, 0, torch.where(
            cond_a[..., None] & probe, 0, torch.where(
                cond_a[..., None], 4, torch.where(
                    cond_bc[..., None], 5, torch.zeros_like(sp_ts)))))
        d0 = [torch.where(cond_a, x.gather(-1, fvi)[..., 0], y)
              for x, y in ((sp_ts, ats), (sp_bin, abin), (sp_h, ah))]
        ctl = torch.cat([ctl0[..., None], tail], -1)
        dts = torch.cat([d0[0][..., None], sp_ts], -1)
        dbin = torch.cat([d0[1][..., None], sp_bin], -1)
        dhh = torch.cat([d0[2][..., None], sp_h], -1)
        live = (ctl != 0).any(0).tolist()
        for f in range(F):
            for e in range(G + 1):
                if live[f][e]:
                    self._pkt_step_split(st, ctl[:, f, e], ats[:, f],
                                         abin[:, f], ah[:, f], dts[:, f, e],
                                         dbin[:, f, e], dhh[:, f, e])

    def _phase(self, st, ts, hh):
        """Data eligibility of a peak (ts, hh) against every packet
        (:290-298): (any eligible, the packet it joins)."""
        n, mod = self.n, TIMESTAMP_MOD
        tsd = (ts[:, None] - st["p_pre_ts"]) % mod
        elig = st["p_active"] & (tsd > 4 * n) & (tsd < mod // 2)
        dt = (tsd % n).to(torch.float32)
        dt = dt / self._f32(n, dt)
        two = self._f32(2, dt)
        dt = torch.where(dt > 0.5, (1 - dt) * two, dt * two)
        pre_h = st["p_pre_h"]
        h_dis = (pre_h - hh[:, None]).abs() / pre_h
        elig = elig & (h_dis < 0.5)
        any_e = elig.any(1)
        m = torch.where(elig, dt, torch.full_like(dt, torch.inf)).amin(1)
        qi = torch.where(elig & (dt == m[:, None]), st["p_seq"],
                         torch.full_like(st["p_seq"], _IMAX)).argmin(1)
        return any_e, qi

    def _create(self, st, create, ts, bn, hh):
        """A new packet in the first free slot where ``create``."""
        free = ~st["p_active"]
        any_f = free.any(1)
        fi = free.to(torch.uint8).argmax(1)
        cr = create & any_f
        st["packets_dropped"] = st["packets_dropped"] \
            + (create & ~any_f).to(torch.int32)
        m = (torch.arange(self.Q, device=ts.device)[None, :]
             == fi[:, None]) & cr[:, None]
        st["p_active"] = st["p_active"] | m
        st["p_seq"] = torch.where(m, st["pseq"][:, None], st["p_seq"])
        st["p_ttl"] = torch.where(m, _TTL0, st["p_ttl"])
        st["p_pre_ts"] = torch.where(m, ts[:, None], st["p_pre_ts"])
        st["p_pre_bin"] = torch.where(m, bn[:, None], st["p_pre_bin"])
        st["p_pre_h"] = torch.where(m, hh[:, None], st["p_pre_h"])
        st["p_count"] = torch.where(m, 0, st["p_count"])
        st["pseq"] = st["pseq"] + cr.to(torch.int32)

    def _add_data(self, st, do, qi, ts, bn, hh):
        """Append a data peak to packet ``qi`` where ``do``."""
        S = self.S
        dev = ts.device
        cnt = st["p_count"].gather(1, qi[:, None])[:, 0]
        room = cnt < S
        oq = (torch.arange(self.Q, device=dev)[None, :] == qi[:, None]) \
            & do[:, None]
        st["p_ttl"] = torch.where(oq, _TTL0, st["p_ttl"])
        cs = cnt.clamp(max=S - 1)
        cell = (oq & room[:, None])[:, :, None] & (
            torch.arange(S, device=dev)[None, :] == cs[:, None])[:, None, :]
        st["p_ts"] = torch.where(cell, ts[:, None, None], st["p_ts"])
        st["p_bin"] = torch.where(cell, bn[:, None, None], st["p_bin"])
        st["p_h"] = torch.where(cell, hh[:, None, None], st["p_h"])
        st["p_count"] = torch.where(oq, (cnt + 1).clamp(max=S)[:, None],
                                    st["p_count"])
        st["packet_peak_overflow"] = st["packet_peak_overflow"] \
            + (do & ~room).to(torch.int32)

    def _pkt_step(self, st, kind, ts, bn, hh, ok):
        """add_symbol_to_packet (:272-310)."""
        self._create(st, ok & (kind == _KIND_PRE), ts, bn, hh)
        any_e, qi = self._phase(st, ts, hh)
        self._add_data(st, ok & (kind == _KIND_DATA) & any_e, qi, ts, bn,
                       hh)

    def _pkt_step_split(self, st, ctl, pts, pbin, phh, dts, dbin, dhh):
        """pkt_step_split (:319-363)."""
        any_e, qi = self._phase(st, dts, dhh)
        gate = st["s_gate"]
        create = (ctl == 1) | ((ctl == 3) & ~any_e)
        do_data = any_e & ((ctl == 2) | (ctl == 3) | ((ctl == 4) & gate)
                           | (ctl == 5))
        st["s_gate"] = torch.where(ctl == 3, any_e, gate)
        self._create(st, create, pts, pbin, phh)
        self._add_data(st, do_data, qi, dts, dbin, dhh)

    def _assemble(self, pre_ts, pre_bin, pre_h, count, pts, pbin, ph):
        """general_work's assembly (:366-401) over [C, E] packets."""
        S, W, n, k, ff = self.S, self.W, self.n, self.k, self.ff
        dev = count.device
        valid = torch.arange(S, device=dev) < count[..., None]
        tsn = (pts - pre_ts[..., None]) % TIMESTAMP_MOD
        key = torch.where(valid, tsn, torch.full_like(tsn, _IMAX))
        order = torch.argsort(key, dim=-1, stable=True)
        sts = key.gather(-1, order)
        svalid = valid.gather(-1, order)
        sbin = pbin.gather(-1, order)
        sh = ph.gather(-1, order)
        lo = (self.lo0 + torch.arange(W, device=dev) * n)[:, None]
        s4 = sts[..., None, :]
        v4 = svalid[..., None, :]
        inw = v4 & (lo < s4) & (s4 < lo + n)
        found = inw.any(-1)
        cont = (v4 & (s4 >= lo + n)).any(-1)
        bad = (~(found & cont)).to(torch.int32)
        processed = (bad.cumsum(-1) - bad) == 0
        dtf = (sts % n).to(torch.float32)
        dtf = dtf / self._f32(n, dtf)
        two = self._f32(2, dtf)
        dtf = torch.where(dtf > 0.5, (1 - dtf) * two, dtf * two)
        dis = dtf + (sh - pre_h[..., None]).abs() / pre_h[..., None]
        bi = torch.where(inw, dis[..., None, :],
                         torch.full_like(inw, torch.inf,
                                         dtype=torch.float32)).argmin(-1)
        bts = sts.gather(-1, bi)
        shift = (bts % n) * k // n
        sym = (((sbin.gather(-1, bi) - pre_bin[..., None] - shift) % k
                + self.qoff) // ff) % (k // ff)
        syms = torch.where(processed & found, sym, 0).to(torch.int32)
        length = torch.where(count == 0, 0,
                             processed.sum(-1)).to(torch.int32)
        return syms, length, length >= 8

    def _expire(self, st):
        """TTL expiry and assembly (:488-513)."""
        Q, E, O = self.Q, self.E, self.O
        exp = st["p_active"] & (st["p_ttl"] <= 0)
        if bool(exp.any()):
            dev = exp.device
            c = exp.shape[0]
            n_exp = exp.sum(1).to(torch.int32)
            eorder = torch.argsort(
                torch.where(exp, st["p_seq"],
                            torch.full_like(st["p_seq"], _IMAX)),
                dim=1, stable=True)[:, :E]
            e_ok = torch.arange(E, device=dev)[None, :] < torch.minimum(
                n_exp, torch.full_like(n_exp, E))[:, None]
            st["expire_deferred"] = st["expire_deferred"] \
                + (n_exp - E).clamp(min=0)
            ec = eorder.clamp(0, Q - 1)

            def rows(name):
                x = st[name]
                if x.dim() == 2:
                    return x.gather(1, ec)
                return x.gather(1, ec[:, :, None].expand(-1, -1,
                                                         x.shape[-1]))

            syms, lens, emits = self._assemble(
                rows("p_pre_ts"), rows("p_pre_bin"), rows("p_pre_h"),
                rows("p_count"), rows("p_ts"), rows("p_bin"), rows("p_h"))
            emits = emits & e_ok
            ei = emits.to(torch.int32)
            rank = ei.cumsum(1) - ei
            slot = st["o_count"][:, None] + rank
            put = emits & (slot < O)
            st["out_overflow"] = st["out_overflow"] + (
                emits & (slot >= O)).sum(1).to(torch.int32)
            tgt = torch.where(put, slot, O).to(torch.int64)

            def scatter(name, val):
                x = st[name]
                pad = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
                idx = tgt if x.dim() == 2 else \
                    tgt[:, :, None].expand(-1, -1, x.shape[-1])
                st[name] = pad.scatter(1, idx, val)[:, :O]

            scatter("o_syms", syms)
            scatter("o_len", lens)
            scatter("o_pos", rows("p_pre_ts"))
            st["o_count"] = torch.minimum(
                st["o_count"] + ei.sum(1).to(torch.int32),
                torch.full_like(st["o_count"], O))
            clear = torch.zeros((c, Q + 1), dtype=torch.bool, device=dev)
            clear.scatter_(1, torch.where(e_ok, eorder, Q), True)
            st["p_active"] = st["p_active"] & ~clear[:, :Q]
        st["p_ttl"] = torch.where(st["p_active"] & (st["p_ttl"] > 0),
                                  st["p_ttl"] - 1, st["p_ttl"])
