"""Pyramid real-time collision decoder (INFOCOM 2021): the peak lattice,
the one-shot decoder and its block-streaming form.

Twin of gr_lora_tpu/models/pyramid.py.  The dense lattice runs in
PyTorch on the input's device: every overlapped hop (hop = symbol / 8) is
dechirped and zoom-transformed twice (unwindowed and Kaiser-windowed,
pyramid_demod_impl.cc:569-603), folded, local-max masked, thresholded and
reduced to the top-M peaks per hop.  The sparse tracking runs on the host
in the port's C++ tracker (gr_lora_tpu_torch.native) or its NumPy twin
:class:`PyramidTracker`, fed the peak lists.

Backends of :func:`peak_lattice_fn`, dispatched as the JAX package
dispatches them (models/pyramid.py:83-193):

- ``"xla"``: dense f32 spectra of explicit frames (ops/dechirp.py) plus
  the plain epilogue; beyond the JAX direct-plan size it becomes "fast";
- ``"fast"``: the overlap-decomposed dense f32 spectra plus the plain
  epilogue;
- ``"rdft"``, ``"direct"``, ``"fastp"``, ``"pallas"``: the dense spectra
  of the hand-written kernels K3 (ops/rdft_spectra.py), K4b
  (ops/direct.py), K5 (ops/overlap_spectra.py) and K6
  (ops/chunk_spectra.py), followed by the peak epilogue (the
  ``peak_topm`` kernel on the card, the plain one on the CPU);
- ``"fused"``: the peak-lattice kernels, split over SF as the JAX
  dispatch splits them — K1 (ops/rdft_peaks.py) where
  ``rdft_peaks_supported``, else K4 (ops/direct.py) where the direct
  plan fits, else K2 (ops/overlap_peaks.py) where
  ``overlap_peaks_supported``, else "xla";
- ``"fused_direct"``: as "fused" without K1.

On a CPU tensor every kernel module runs its plain version.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .. import native
from ..config import (PYRAMID_MAX_TRACK_PEAKS, PYRAMID_NUM_PREAMBLE,
                      PYRAMID_OVERLAP_FACTOR, PYRAMID_PACKET_POOL,
                      PYRAMID_TRACK_POOL, TIMESTAMP_MOD, LoraConfig)
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..device import upload
from ..ops.chunk_spectra import ChunkSpectra
from ..ops.cplx import to_ri
from ..ops.dechirp import fold_spectra, frame_signal, pyramid_plan
from ..ops.direct import DirectPeaks, DirectSpectra
from ..ops.overlap_dft import OverlapPlan, spectra_from_chunks
from ..ops.overlap_peaks import OverlapPeaks, overlap_peaks_supported
from ..ops.overlap_spectra import OverlapSpectra
from ..ops.peak_epilogue import launch_topm, peaks_plain
from ..ops.rdft_peaks import RdftPeaks, rdft_peaks_supported
from ..ops.rdft_spectra import RdftSpectra

#: Matrices larger than this (complex elements) leave the JAX direct plan
#: (gr_lora_tpu/ops/dft.py _DIRECT_MAX_ELEMS); the dense "xla" backend and
#: the fused dispatch test the same size.
_DIRECT_MAX_ELEMS = 1 << 23

BACKENDS = ("xla", "fast", "rdft", "direct", "fastp", "pallas", "fused",
            "fused_direct")
#: The dense-spectra kernel module of each kernel backend.
_FRONTS = {"rdft": RdftSpectra, "direct": DirectSpectra,
           "fastp": OverlapSpectra, "pallas": ChunkSpectra}


def num_hops_for(cfg: LoraConfig, num_samples_total: int) -> int:
    n = cfg.num_samples
    hop = n // PYRAMID_OVERLAP_FACTOR
    return max((num_samples_total - n) // hop + 1, 0)


class DenseLattice(nn.Module):
    """Dense spectra followed by the peak epilogue: "xla" (explicit
    frames) and "fast" (overlap decomposition) in plain f32 PyTorch, or
    the kernel backends' ``front`` module (K3, K4b, K5 or K6), whose spectra
    on the card go to the ``peak_topm`` kernel."""

    def __init__(self, cfg: LoraConfig, num_hops: int, max_peaks: int,
                 backend: str):
        super().__init__()
        self.cfg = cfg
        self.num_hops = num_hops
        self.max_peaks = max_peaks
        self.backend = backend
        self.front = None
        if backend == "xla":
            self.plan = pyramid_plan(cfg.sf, cfg.p, cfg.fft_factor,
                                     float(cfg.beta))
        elif backend == "fast":
            self.plan = OverlapPlan(cfg.sf, cfg.p, cfg.fft_factor,
                                    float(cfg.beta))
        else:
            self.front = _FRONTS[backend](cfg, num_hops)

    def spectra(self, iq: torch.Tensor):
        cfg = self.cfg
        if self.front is not None:
            return self.front(iq)
        if self.backend == "fast":
            g = self.plan.chunk_dft(iq, self.num_hops)
            return spectra_from_chunks(g, self.plan, self.num_hops)
        n = cfg.num_samples
        frames = frame_signal(iq, n, n // PYRAMID_OVERLAP_FACTOR,
                              self.num_hops)
        return fold_spectra(self.plan(frames))

    def forward(self, iq: torch.Tensor):
        fa, faw, hs = self.spectra(iq)
        epilogue = launch_topm if self.front is not None and fa.is_cuda \
            else peaks_plain
        return epilogue(fa, faw, hs, float(self.cfg.threshold),
                        self.max_peaks)


class BlockedLattice(nn.Module):
    """Runs ``inner`` (a ``block_hops`` lattice) over consecutive hop
    blocks.  Blocks overlap by the symbol-minus-hop halo, so every hop
    window is self-contained and the peak decisions match the unblocked
    plan; only one block's spectra are ever resident."""

    def __init__(self, inner: nn.Module, cfg: LoraConfig, num_hops: int,
                 block_hops: int):
        super().__init__()
        self.inner = inner
        self.num_hops = num_hops
        self.block_hops = block_hops
        n = cfg.num_samples
        self.hop = n // PYRAMID_OVERLAP_FACTOR
        self.seg = block_hops * self.hop + n - self.hop

    def forward(self, iq: torch.Tensor):
        nb = -(-self.num_hops // self.block_hops)
        need = (nb - 1) * self.block_hops * self.hop + self.seg
        pad = need - iq.shape[-2]
        if pad > 0:
            iq = torch.nn.functional.pad(iq, (0, 0, 0, pad))
        outs = [self.inner(iq[..., b * self.block_hops * self.hop:
                              b * self.block_hops * self.hop + self.seg, :])
                for b in range(nb)]
        return tuple(torch.cat(parts, dim=-2)[..., :self.num_hops, :]
                     for parts in zip(*outs))


def peak_lattice_fn(cfg: LoraConfig, num_hops: int, max_peaks: int = 16,
                    backend: str = "xla",
                    block_hops: int | None = None) -> nn.Module:
    """A module mapping iq float32 [..., T, 2] -> per-hop top-M peaks
    (bins int32, h f32, h_single f32, valid bool), each [..., H, M].

    Peaks are the strict cyclic local maxima of the Kaiser-windowed folded
    spectrum above cfg.threshold (pyramid_demod_impl.cc:229-235); h is
    the unwindowed folded height and h_single the max of the two unfolded
    edge bands (:269).  The module is built on the CPU: move it with
    ``.to(device)``.  ``block_hops`` bounds the resident spectra as in
    the JAX package; the K1 and K4 lattices ignore it, as there."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    n = cfg.num_samples
    if backend in ("fused", "fused_direct"):
        if backend == "fused" and rdft_peaks_supported(cfg):
            return RdftPeaks(cfg, num_hops, max_peaks)
        if n * 4 * cfg.bin_size <= _DIRECT_MAX_ELEMS:
            return DirectPeaks(cfg, num_hops, max_peaks)
        backend = "fused" if overlap_peaks_supported(cfg) else "xla"

    if block_hops is not None and num_hops > block_hops:
        inner = peak_lattice_fn(cfg, block_hops, max_peaks, backend)
        return BlockedLattice(inner, cfg, num_hops, block_hops)
    if backend == "fused":
        return OverlapPeaks(cfg, num_hops, max_peaks)
    if backend == "xla" and n * 4 * cfg.bin_size > _DIRECT_MAX_ELEMS:
        backend = "fast"
    return DenseLattice(cfg, num_hops, max_peaks, backend)


def make_peak_lattice(cfg: LoraConfig, num_hops: int, max_peaks: int = 16,
                      backend: str = "xla",
                      device: str | torch.device = DEFAULT_DEVICE,
                      block_hops: int | None = None) -> nn.Module:
    """The :func:`peak_lattice_fn` module of one shape on ``device`` (the
    card unless the caller passes ``device="cpu"``), built and its weights
    uploaded once: a later call with the same arguments, however they are
    passed, returns the same module (the JAX ``make_peak_lattice``'s
    ``lru_cache``).  Its kernel modules' ``launches`` count every caller's
    launches.  The cache keeps the newest 32 shapes."""
    return _lattice(cfg, num_hops, max_peaks, backend, block_hops,
                    resolve_device(device))


@lru_cache(maxsize=32)
def _lattice(cfg, num_hops, max_peaks, backend, block_hops, device):
    return peak_lattice_fn(cfg, num_hops, max_peaks, backend,
                           block_hops=block_hops).to(device)


# ---------------------------------------------------------------------------
# Sparse tracking (host, NumPy): the Python twin of the C++ tracker in
# gr_lora_tpu_torch.native — reference-exact bookkeeping, the JAX
# package's gr_lora_tpu/models/pyramid.py:229-635 line for line.
# ---------------------------------------------------------------------------

_TS_MOD = TIMESTAMP_MOD


def _pmod(x: int, n: int) -> int:
    return x % n


@dataclasses.dataclass
class _Peak:
    ts: int
    bin: int
    h: float
    h_single: float


@dataclasses.dataclass
class _Track:
    bin: int                 # drift-corrected bin at creation (:246-266)
    peaks: list
    updated: bool = True
    misses: int = 0          # consecutive hops without an update (grace mode)


@dataclasses.dataclass
class _Packet:
    peaks: list              # peaks[0] is the preamble pseudo-peak
    ttl: int


_PREAMBLE, _DATA, _BROKEN = range(3)


class PyramidTracker:
    """Host-side peak-track & packet state machine
    (pyramid_demod_impl.cc:225-525 + assembly :610-767).

    ``grace`` > 0 is a beyond-reference enhancement: a track may miss up to
    that many consecutive hops before it is finalized, so a peak briefly
    masked by a stronger colliding packet's main lobe (the dominant
    weak-packet failure mode) resumes its track instead of truncating it.
    grace=0 is exact reference behavior."""

    def __init__(self, cfg: LoraConfig, grace: int = 0,
                 apex_algorithm: str = "segment",
                 split_repeats: bool = False,
                 quantize: str = "round"):
        if apex_algorithm not in ("segment", "linear_regression"):
            raise ValueError(apex_algorithm)
        if quantize not in ("floor", "round"):
            raise ValueError(quantize)
        self.apex_algorithm = apex_algorithm
        #: bin -> symbol quantization at assembly.  'round' (default,
        #: deliberate deviation — see _assemble) absorbs the hop-grid apex
        #: quantization error; 'floor' is the bit-true reference rule
        #: (pyramid_demod_impl.cc:744: ``bin / fft_factor``), kept as a
        #: parity escape hatch (VERDICT r4 item 4).
        self.quantize = quantize
        #: Beyond-reference (opt-in): m consecutive EQUAL symbols merge
        #: into one (m+1)*overlaps-long track (the rotating bin frame
        #: wraps exactly once per symbol), which the reference classifier
        #: rejects as BROKEN — truncating the packet at the first empty
        #: assembly window (pyramid_demod_impl.cc:332, :680-767; at SF7
        #: ~17 % of random payloads contain an adjacent repeat).  With
        #: split_repeats=True such a track is split at exact one-symbol
        #: strides from its rising-edge apex and each segment is emitted
        #: as a data symbol.  False = exact reference behavior.
        self.split_repeats = split_repeats
        self.grace = grace
        self.cfg = cfg
        self.n = cfg.num_samples
        self.k = cfg.bin_size
        self.overlaps = PYRAMID_OVERLAP_FACTOR
        self.hop = self.n // self.overlaps
        self.ttl0 = 6 * self.overlaps            # :95
        self.num_preamble = PYRAMID_NUM_PREAMBLE  # :112
        self.bin_tolerance = cfg.bin_tolerance
        self.ts_ref = 0
        self.bin_ref = 0
        self.tracks: list[_Track] = []
        self.packets: list[_Packet] = []
        self.symbols_out: list[np.ndarray] = []
        #: Preamble timestamp (sample index mod 2^28) per symbols_out entry
        #: — beyond-reference: the reference publishes positionless PDUs.
        self.positions_out: list[int] = []
        # Graceful pool-exhaustion counters (the reference exit(-1)s,
        # pyramid_demod_impl.cc:256-260; we drop + count).
        self.tracks_dropped = 0
        self.packets_dropped = 0
        self.tracks_overflow_finalized = 0

    # -- per-hop ingest (find_and_add_peak :225-272) --
    def _add_peaks(self, bins, hs, hss):
        for b, h, hsngl in zip(bins, hs, hss):
            cur_bin = _pmod(self.k + int(b) - self.bin_ref, self.k)
            matched = None
            for tr in self.tracks:
                dis = _pmod(self.k + cur_bin - tr.bin, self.k)
                if (dis <= self.bin_tolerance
                        or dis >= self.k - self.bin_tolerance):
                    matched = tr
                    tr.updated = True
                    break
            if matched is None:
                if len(self.tracks) >= PYRAMID_TRACK_POOL:
                    self.tracks_dropped += 1
                    continue
                matched = _Track(bin=cur_bin, peaks=[])
                self.tracks.append(matched)
            matched.peaks.append(_Peak(self.ts_ref, int(b), float(h),
                                       float(hsngl)))
        # Per-track peak cap: finalize as if idle (bounds memory under a
        # persistent CW interferer whose track never goes idle).
        keep = []
        for tr in self.tracks:
            if len(tr.peaks) >= PYRAMID_MAX_TRACK_PEAKS:
                self._retire_track(tr)
                self.tracks_overflow_finalized += 1
            else:
                keep.append(tr)
        self.tracks = keep

    def _retire_track(self, tr: _Track):
        st, pk = self._central_peak(tr)
        if self.split_repeats and st == _PREAMBLE and \
                len(tr.peaks) < self.overlaps * (self.num_preamble + 1):
            # A >= (num_preamble-1)-symbol repeat RUN aliases as a
            # preamble (a real preamble IS a repeat run; the classifier
            # threshold is :316's ov*(num_preamble-1)+2).  Disambiguate
            # by packet phase: if the first split symbol ts/height-
            # matches an EXISTING packet, the run is data belonging to
            # it; a true (full-length ~ (num_preamble+2)*ov) preamble
            # never takes this branch.
            pks = self._split_repeat_track(
                tr, max_ln=self.overlaps * (self.num_preamble + 1))
            if pks and self._add_symbol_to_packet(pks[0], _DATA):
                for pk2 in pks[1:]:
                    self._add_symbol_to_packet(pk2, _DATA)
                return
        if self.split_repeats and st == _DATA and \
                len(tr.peaks) > self.overlaps + 2:
            # A double whose edge peak dropped below threshold lands at
            # EXACTLY 2*ov and classifies as one data symbol; the
            # ts-group split is self-validating (>= 2 plateau groups at
            # distinct whole-symbol offsets — a single symbol's 0.5-sym
            # fall skirt is gated out at 0.7*hmax), so try it first.
            pks = self._split_repeat_track(tr, min_ln=self.overlaps + 2)
            if len(pks) >= 2:
                for pk2 in pks:
                    self._add_symbol_to_packet(pk2, _DATA)
                return
        if st in (_PREAMBLE, _DATA):
            self._add_symbol_to_packet(pk, st)
        elif self.split_repeats:
            for pk2 in self._split_repeat_track(tr):
                self._add_symbol_to_packet(pk2, _DATA)

    def stats(self) -> dict:
        return {"tracks_dropped": self.tracks_dropped,
                "packets_dropped": self.packets_dropped,
                "tracks_overflow_finalized": self.tracks_overflow_finalized}

    # -- apex extraction (get_apex :274-317) --
    def _apex(self, track_peaks, is_preamble):
        key = [(p.h_single if is_preamble else p.h) for p in track_peaks]
        idx = int(np.argmax(key))
        p = track_peaks[idx]
        seg = _Peak(p.ts, p.bin, float(key[idx]), p.h_single)
        if self.apex_algorithm == "segment":
            return seg
        # LINEAR_REGRESSION variant (pyramid_demod.h:32-35,
        # pyramid_demod_impl.cc:300-316 — compiled out in the reference
        # build): intersect rising/falling least-squares lines of the peak
        # trajectory for a sub-hop apex estimate; needs >= 4 points and an
        # interior maximum, else fall back to the segment apex.
        h = np.asarray(key, dtype=np.float64)
        ln = len(h)
        if idx < 1 or idx > ln - 2 or ln < 4:
            return seg

        def fit(lo, hi):
            x = np.arange(lo, hi + 1, dtype=np.float64)
            k, b = np.polyfit(x, h[lo:hi + 1], 1)
            return k, b

        l_idx = idx - 1 if h[idx - 1] > h[idx + 1] else idx
        if l_idx < 1 or l_idx + 1 >= ln - 1 + 1:
            return seg
        k1, b1 = fit(0, l_idx)
        k2, b2 = fit(l_idx + 1, ln - 1)
        if k1 == k2:
            return seg
        x = -(b2 - b1) / (k2 - k1)
        lp = track_peaks[l_idx]
        ts = _pmod(lp.ts + int(round((x - l_idx) * self.n / self.overlaps)),
                   _TS_MOD)
        bn = _pmod(lp.bin + int(round((x - l_idx) * self.k / self.overlaps)),
                   self.k)
        return _Peak(ts, bn, float(k1 * x + b1), p.h_single)

    # -- track classification (get_central_peak :319-391) --
    def _central_peak(self, track: _Track):
        pk_list = track.peaks
        ln = len(pk_list)
        ov = self.overlaps
        if ln >= ov * (self.num_preamble - 1) + 2:
            # Preamble: apex of the LAST chirp, walked back along the
            # single-peak trajectory (:349-379).
            r0 = ln - ov
            r_idx = r0 + int(np.argmax([p.h for p in pk_list[r0:]]))
            start_idx = r_idx
            while start_idx > r_idx - ov // 2:
                if (pk_list[start_idx - 1].h_single
                        > pk_list[start_idx].h_single
                        or pk_list[start_idx].h_single < self.cfg.threshold):
                    break
                start_idx -= 1
            pk = self._apex(pk_list[start_idx:], is_preamble=True)
            pk.ts = _pmod(pk.ts + self.n // 4, _TS_MOD)  # SFD-gap fix (:371)
            mid = pk_list[2 * ov: ov * (self.num_preamble - 2)]
            # Stable height (:373-378).
            pk.h = float(np.mean([p.h for p in mid]))
            return _PREAMBLE, pk
        if 2 <= ln <= 2 * ov:
            return _DATA, self._apex(pk_list, is_preamble=False)
        return _BROKEN, None

    def _split_repeat_track(self, track: _Track, max_ln=None,
                            min_ln=None) -> list:
        """Constructor doc (split_repeats): one merged m-repeat track ->
        m data peaks at exact one-symbol strides.  The lattice bin frame
        rotates k/overlaps per hop, so one symbol later both the frame
        AND the repeated symbol's raw bin are back where they were: the
        i-th segment's peak is the rising-edge apex displaced by i*n in
        ts with the SAME raw bin, heights read off the track's plateau."""
        pk_list = track.peaks
        ln = len(pk_list)
        ov = self.overlaps
        cap = ov * (self.num_preamble - 1) + 2 if max_ln is None else max_ln
        floor = 2 * ov if min_ln is None else min_ln
        if ln <= floor or ln >= cap:
            return []
        # First index where the rising edge reaches the plateau (one
        # symbol's track is ov+1 peaks — rise, apex, fall on the hop
        # grid — and each ADJACENT repeat extends the plateau by ov;
        # argmax would drift mid-plateau on noise).
        hmax = max(p.h for p in pk_list)
        apex_idx = next(i for i, p in enumerate(pk_list)
                        if p.h >= 0.95 * hmax)
        apex = pk_list[apex_idx]
        # Group the RECORDED peaks by whole-symbol offset from the apex:
        # a same-value symbol recurring after a gap (e.g. ..v, w, v, v..)
        # merges into one track whose peak list is NOT hop-continuous, so
        # stride indexing misaligns — ts grouping handles adjacent and
        # gapped runs alike.  Each group emits its own best RECORDED peak
        # (self-consistent ts/bin): ADJACENT-VALUE symbols (bins one
        # fft_factor apart, bridged across the track tolerance by the
        # leakage peaks of their overlap region) also merge into one
        # track, and only the group's own apex carries the second
        # symbol's true bin.  A symbol is emitted only where the group's
        # height reaches the plateau (gap positions carry only
        # partial-overlap skirts).
        best: dict = {}
        for p in pk_list:
            rel = _pmod(p.ts - apex.ts, _TS_MOD)
            if rel > _TS_MOD // 2:
                continue                      # rising skirt before apex
            # Half-up (NOT banker's) rounding — keeps the C++ twin
            # (csrc/host/pyramid_tracker.cc) bit-identical at the exact
            # half-symbol skirt offsets.
            g = int((rel + self.n // 2) // self.n)
            if g not in best or p.h > best[g].h:
                best[g] = p
        # Snap each group's peak to exact one-symbol spacing from the
        # apex (a flat plateau's per-group argmax lands anywhere inside
        # its +-n/2 bucket, which misaligns the assembly windows) and
        # rotate its bin by the ts delta — the dechirp bin advances
        # exactly k/n per sample, so (ts, bin) stays self-consistent
        # while each group keeps its OWN bin (the adjacent-value case).
        out = []
        for g in sorted(best):
            p = best[g]
            if p.h < 0.7 * hmax:
                continue
            snap = _pmod(apex.ts + g * self.n, _TS_MOD)
            dt = _pmod(snap - p.ts + self.n // 2, _TS_MOD) - self.n // 2
            bn = _pmod(p.bin + dt * self.k // self.n, self.k)
            out.append(_Peak(snap, bn, float(p.h), float(p.h_single)))
        return out if len(out) >= 2 else []

    # -- ts-phase + height distance (get_dis :187-196) --
    def _get_dis(self, ts1, h1, ts2, h2):
        dis = _pmod(ts1 - ts2, self.n) / float(self.n)
        dis = (1 - dis) * 2 if dis > 0.5 else dis * 2
        dis += abs(h1 - h2) / h2
        return dis

    # -- packet matching (add_symbol_to_packet :393-473) --
    def _add_symbol_to_packet(self, pk: _Peak, st: int):
        if st == _PREAMBLE:
            if len(self.packets) >= PYRAMID_PACKET_POOL:
                self.packets_dropped += 1
                return False
            self.packets.append(_Packet(peaks=[pk], ttl=self.ttl0))
            return True
        best = None
        min_dis = np.inf
        for packet in self.packets:
            ts_dis = _pmod(pk.ts - packet.peaks[0].ts, _TS_MOD)
            if not (4 * self.n < ts_dis < _TS_MOD // 2):
                continue
            dis = _pmod(ts_dis, self.n) / float(self.n)
            dis = (1 - dis) * 2 if dis > 0.5 else dis * 2
            h_dis = abs(packet.peaks[0].h - pk.h) / packet.peaks[0].h
            if dis < min_dis and h_dis < 0.5:
                best = packet
                min_dis = dis
        if best is None:
            return False
        best.ttl = self.ttl0
        best.peaks.append(pk)
        return True

    # -- retire idle tracks (check_and_update_track :475-525) --
    def _finish_idle_tracks(self):
        keep = []
        for tr in self.tracks:
            if tr.updated:
                tr.updated = False
                tr.misses = 0
                keep.append(tr)
                continue
            # Grace only for preamble-length tracks: data tracks are at most
            # 2*overlaps long, and letting them linger merges consecutive
            # same-bin symbols into BROKEN tracks (hurts the strong packet).
            if (tr.misses < self.grace
                    and len(tr.peaks) > 2 * self.overlaps):
                tr.misses += 1
                keep.append(tr)
                continue
            self._retire_track(tr)
        self.tracks = keep

    # -- TTL expiry + assembly (general_work :610-767) --
    def _assemble(self, packet: _Packet):
        pkt = packet.peaks
        pre_ts, pre_bin, pre_h = pkt[0].ts, pkt[0].bin, pkt[0].h
        for p in pkt:
            p.ts = _pmod(p.ts - pre_ts, _TS_MOD)
        pkt.sort(key=lambda p: p.ts)
        symbols = []
        # First data symbol window: preamble_ts + (4.5, 5.5) symbols
        # (:680-684).
        lo = 4 * self.n + self.n // 2
        start_idx = 1
        while start_idx < len(pkt):
            is_first, found = True, False
            end_idx = start_idx
            while end_idx < len(pkt):
                in_win = lo < pkt[end_idx].ts < lo + self.n
                if is_first:
                    if in_win:
                        start_idx = end_idx
                        is_first = False
                        found = True
                elif not in_win:
                    break
                end_idx += 1
            if found:
                idx = start_idx
                min_dis = np.inf
                for i in range(start_idx, end_idx):
                    dis = self._get_dis(pkt[i].ts, pkt[i].h, 0, pre_h)
                    if dis < min_dis:
                        min_dis = dis
                        idx = i
                bin_shift = _pmod(pkt[idx].ts, self.n) * self.k // self.n
                b = _pmod(pkt[idx].bin - pre_bin - bin_shift, self.k)
                # Deliberate deviation from the reference's floor division
                # (pyramid_demod_impl.cc:744): the apex ts sits on the hop
                # grid, so b carries +-1-2 sub-bins of quantization error;
                # floor flips the SYMBOL whenever b lands one sub-bin
                # under a multiple of fft_factor (a deterministic ~2 %
                # packet-error floor at arbitrary sub-symbol phases —
                # docs/BENCH.md r4).  Rounding absorbs |e| < ff/2.  Twin:
                # csrc/host/pyramid_tracker.cc.  quantize='floor'
                # restores the bit-true reference rule.
                ff = self.cfg.fft_factor
                qoff = ff // 2 if self.quantize == "round" else 0
                symbols.append(((b + qoff) // ff) % (self.k // ff))
            else:
                symbols.append(0)
            start_idx = end_idx
            lo = _pmod(lo + self.n, _TS_MOD)
        if len(symbols) >= 8:       # min LoRa payload (:755)
            self.symbols_out.append(np.asarray(symbols, dtype=np.uint16))
            self.positions_out.append(int(pre_ts))

    def step(self, bins=(), hs=(), hss=()):
        """Process one hop's extracted peaks (possibly none)."""
        self._add_peaks(bins, hs, hss)
        self._finish_idle_tracks()
        expired = [p for p in self.packets if p.ttl <= 0]
        for packet in expired:
            self._assemble(packet)
        self.packets = [p for p in self.packets if p.ttl > 0]
        for packet in self.packets:
            packet.ttl -= 1
        self.ts_ref = _pmod(self.ts_ref + self.hop, _TS_MOD)
        self.bin_ref = _pmod(self.bin_ref + self.k // self.overlaps, self.k)

    def flush_hops(self) -> int:
        """Empty hops needed to retire every live track and expire all TTLs."""
        return (self.num_preamble + 3) * self.overlaps + self.ttl0 + 2



def make_tracker(cfg: LoraConfig, use_native: bool | None = None,
                 grace: int = 0, split_repeats: bool = False,
                 quantize: str = "round"):
    """The native C++ tracker (``use_native`` True or None) or its
    Python twin :class:`PyramidTracker` (False)."""
    cls = PyramidTracker if use_native is False else native.PyramidTracker
    return cls(cfg, grace=grace, split_repeats=split_repeats,
               quantize=quantize)


def step_lattice(tracker, bins, h, hs, valid) -> None:
    """Feed one stream's peak lattice ([H, M] each) to ``tracker`` hop by
    hop.  The reference scans bins in ascending order (:227); the peaks
    are sorted so first-match track assignment is identical."""
    for t in range(bins.shape[0]):
        v = valid[t]
        if v.any():
            order = np.argsort(bins[t][v], kind="stable")
            tracker.step(bins[t][v][order], h[t][v][order], hs[t][v][order])
        else:
            tracker.step()


def pyramid_demodulate(iq, cfg: LoraConfig, max_peaks: int = 16,
                       flush: bool = True, use_native: bool | None = None,
                       backend: str = "xla", grace: int = 0,
                       split_repeats: bool = False, quantize: str = "round",
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> list[np.ndarray]:
    """IQ stream -> one uint16 symbol vector per (colliding) packet.

    ``iq`` is complex [T], float32 [T, 2] (numpy) or a float32 [T, 2]
    tensor; the lattice runs on ``device`` (the card unless the caller
    passes ``device="cpu"``).  Tracking uses the port's native C++
    tracker (``use_native`` True or None) or its Python twin
    :class:`PyramidTracker` (False); the two are behavior-identical.
    """
    x = upload(iq, resolve_device(device))
    nh = num_hops_for(cfg, x.shape[0])
    if nh == 0:
        return []
    lattice = make_peak_lattice(cfg, nh, max_peaks, backend, x.device)
    with torch.no_grad():
        bins, h, hs, valid = (t.cpu().numpy() for t in lattice(x))

    tracker = make_tracker(cfg, use_native, grace, split_repeats, quantize)
    step_lattice(tracker, bins, h, hs, valid)
    if flush:
        for _ in range(tracker.flush_hops() + grace):
            tracker.step()
    return tracker.symbols_out if use_native is False else tracker.drain()


class StreamingPyramidDemodulator:
    """Block-streaming collision decoder: the dense lattice runs per block
    (fixed shapes, one module on ``device``), while the tracker (native,
    or the Python twin with ``use_native=False``) — whose ts_ref/bin_ref
    carry the hop phase — persists across blocks, so packets spanning
    block boundaries assemble exactly as in one-shot mode.  Twin of the
    JAX ``StreamingPyramidDemodulator``."""

    def __init__(self, cfg: LoraConfig, block_hops: int = 2048,
                 max_peaks: int = 16, grace: int = 0,
                 use_native: bool | None = None, backend: str = "xla",
                 split_repeats: bool = False, quantize: str = "round",
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.block_hops = block_hops
        self.device = resolve_device(device)
        n = cfg.num_samples
        self._hop = n // PYRAMID_OVERLAP_FACTOR
        self._overlap = n - self._hop     # samples shared between blocks
        self.tracker = make_tracker(cfg, use_native, grace, split_repeats,
                                    quantize)
        self._drained = 0          # symbols_out entries already returned
        self._grace = grace
        self._pending = np.zeros((0, 2), np.float32)
        self._lattice = make_peak_lattice(cfg, block_hops, max_peaks,
                                          backend, self.device)

    @torch.no_grad()
    def feed(self, iq) -> list[np.ndarray]:
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = to_ri(iq)
        buf = np.concatenate(
            [self._pending, np.asarray(iq, np.float32).reshape(-1, 2)])
        need = self.block_hops * self._hop + self._overlap
        out: list[np.ndarray] = []
        while buf.shape[0] >= need:
            block = torch.from_numpy(np.ascontiguousarray(buf[:need]))
            bins, h, hs, valid = (
                t.cpu().numpy() for t in self._lattice(block.to(self.device)))
            step_lattice(self.tracker, bins, h, hs, valid)
            out += self._results()
            buf = buf[self.block_hops * self._hop:]
        self._pending = buf
        return out

    def _results(self) -> list[np.ndarray]:
        if not isinstance(self.tracker, PyramidTracker):
            return self.tracker.drain()
        out = self.tracker.symbols_out[self._drained:]
        self._drained = len(self.tracker.symbols_out)
        return out

    def flush(self) -> list[np.ndarray]:
        """Zero-pad the residue to a whole block and expire all state."""
        drain_hops = (self.tracker.flush_hops() + self._grace
                      + self.block_hops)
        pad = drain_hops * self._hop + self._overlap
        return self.feed(np.zeros((pad, 2), np.float32))
