"""Successive interference cancellation (SIC) over the Pyramid decoder.

Twin of gr_lora_tpu/models/sic.py.  The Pyramid tracker recovers colliding
packets whose peak tracks stay separable, but a strong packet's windowed
spectrum can mask the weaker packet's preamble outright — the dominant
failure across the collision-recovery envelope (the reference has no
cancellation stage: its tracker, lib/pyramid_demod_impl.cc:393-473, drops
such packets).  So:

1. run the Pyramid pass (dense lattice on ``device`` + host tracker) on
   the stream;
2. for every packet that DECODES (header valid + CRC pass), re-modulate
   its exact transmit IQ (the TX chain is bit-exact, models/modulator),
   estimate its timing by direct cross-correlation around the tracker's
   preamble timestamp (or by dechirped tone probes on ``device``), fit
   per-symbol complex gains by least squares, and subtract;
3. re-run the Pyramid pass on the residual, where the previously masked
   packets now stand alone; repeat until no new packet decodes.

The lattice and the tone probes (ops/dechirp) run on ``device``; the
alignment correlation, the gain fit and the subtraction are host NumPy,
as in the JAX module.  Each dense pass uploads its residual once, through
pinned memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import TIMESTAMP_MOD, LoraConfig
from ..core.codec import decode
from ..core.header import calc_sym_num
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..models.modulator import modulate
from ..models.pyramid import (PyramidTracker, make_peak_lattice,
                              make_tracker, num_hops_for, step_lattice)
from ..ops.cplx import to_ri
from ..ops.dechirp import down_peak, up_peak


@dataclasses.dataclass
class SicPacket:
    """One recovered packet with its cancellation diagnostics."""
    position: int                 # estimated first preamble sample index
    symbols: np.ndarray           # uint16 symbol stream (feeds codec.decode)
    sic_pass: int                 # 0 = plain Pyramid pass, 1+ = after SIC
    subtracted: bool              # this packet was reconstructed & removed
    captured: float               # fraction of residual energy it explained
    refined: bool = False         # symbols re-read after cancelling others


def _upload(ri: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host float32 [..., 2] -> ``device``: one pinned, non-blocking copy
    on the card (ordered before the kernels that read it)."""
    x = torch.from_numpy(np.ascontiguousarray(ri, np.float32))
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _demod_pass(iq_ri: np.ndarray, cfg: LoraConfig, max_peaks: int,
                backend: str, grace: int, use_native: bool,
                lattice_block_hops: int | None = None,
                split_repeats: bool = False,
                device: torch.device = torch.device("cpu")):
    """One Pyramid pass -> [(preamble_ts, symbols)] (models/pyramid.py
    pyramid_demodulate, with positions kept)."""
    nh = num_hops_for(cfg, iq_ri.shape[0])
    if nh == 0:
        return []
    # One module a window shape (models/pyramid.make_peak_lattice's cache,
    # shared with pyramid_demodulate): every pass reuses it.
    lat = make_peak_lattice(cfg, nh, max_peaks, backend, device,
                            block_hops=lattice_block_hops)
    with torch.no_grad():
        bins, h, hs, valid = (t.cpu().numpy()
                              for t in lat(_upload(iq_ri, device)))
    tracker = make_tracker(cfg, use_native, grace, split_repeats)
    step_lattice(tracker, bins, h, hs, valid)
    for _ in range(tracker.flush_hops() + grace):
        tracker.step()
    if isinstance(tracker, PyramidTracker):
        return list(zip(tracker.positions_out, tracker.symbols_out))
    return tracker.drain_ts()


def _trim_to_packet(syms: np.ndarray, cfg: LoraConfig):
    """Decode; if the header parses, return (decode result, symbol stream
    trimmed to the real on-air symbol count) else (result, None).
    Trailing tracker symbols beyond the packet never aired — keeping them
    would synthesize chirps that do not exist in the capture.  A CRC
    failure does NOT veto subtraction: the per-chunk energy-decrease
    guard in _subtract leaves any wrong-symbol chunk untouched, so a
    mostly-right stream still cancels its right symbols."""
    r = decode(syms, cfg)
    if not (r.ok and (not cfg.explicit_header or r.header.is_valid)):
        return r, None
    if cfg.explicit_header:
        nsym = calc_sym_num(r.header.payload_len, sf=cfg.sf,
                            cr=r.header.cr, crc=r.header.crc, ldr=cfg.ldr,
                            explicit_header=True)
    else:
        nsym = calc_sym_num(cfg.payload_len, sf=cfg.sf, cr=cfg.cr,
                            crc=cfg.crc, ldr=cfg.ldr, explicit_header=False)
    if len(syms) < nsym:
        return r, None
    if r.crc_ok or (r.crc_ok is None and r.ok):
        # Byte-exact decode => re-encode for the TRUE transmit symbols.
        # The tracked stream can carry a wrong LAST symbol that decode
        # cannot see (it only feeds dropped interleaver-padding bits), and
        # a one-bin-off chirp in the template leaves a full-amplitude tone
        # in the residual right where a weaker packet's tail symbols sit.
        resyms = _reencode(r, cfg)
        if resyms is not None and len(resyms) == nsym:
            return r, resyms
    return r, np.asarray(syms[:nsym], np.uint16)


def _reencode(r, cfg: LoraConfig) -> np.ndarray | None:
    """DecodeResult -> exact TX symbol stream, via the bit-exact TX chain
    (core.codec.encode).  Explicit-mode PDUs carry 3 header bytes first
    (decode_impl.cc:380-390); CRC bytes and the pass/fail flag trail."""
    from ..core.codec import encode as _encode
    if cfg.explicit_header:
        if r.header is None or not r.header.is_valid:
            return None
        data = bytes(r.payload[3:3 + r.header.payload_len])
        c2 = cfg.replace(cr=r.header.cr, crc=bool(r.header.crc))
    else:
        data = bytes(r.payload[:cfg.payload_len])
        c2 = cfg
    if len(data) == 0:
        return None
    return np.asarray(_encode(data, c2), np.uint16)


def _align(residual: np.ndarray, tmpl: np.ndarray, cfg: LoraConfig,
           pre_ts: int, search: int | None = None) -> int | None:
    """LS-optimal integer sample index of the packet start, by direct
    cross-correlation of the PREAMBLE-side of the template (first 12.25
    symbols — payload-independent, so symbol errors in ``tmpl`` cannot
    bias the fix) around the tracker's preamble timestamp."""
    n = cfg.num_samples
    if search is None:
        search = 2 * n
    head = tmpl[: (49 * n) // 4]          # preamble+sync+SFD (mod layout)
    # Tracker preamble REF timestamp sits ~7 symbols past the first
    # preamble sample (apex of the walked-back last trackable preamble
    # chirp).
    hint = pre_ts - 7 * n
    if hint < -search:      # stream shorter than one TS_MOD wrap: no wrap
        hint = pre_ts - 7 * n + TIMESTAMP_MOD if pre_ts - 7 * n + \
            TIMESTAMP_MOD < residual.shape[0] else hint
    lo = max(hint - search, 0)
    hi = min(hint + search, residual.shape[0] - 1)
    if hi < lo:
        return None
    seg = residual[lo:hi + len(head)]
    if len(seg) < len(head):
        return None
    # c[d] = sum_i seg[d+i] * conj(head[i]); ||head|| is shift-invariant,
    # so argmax |c| is the LS-optimal integer alignment.
    c = np.correlate(seg, head, mode="valid")
    return lo + int(np.argmax(np.abs(c)))


def _signed(b: int, k: int) -> int:
    """Folded peak bin -> signed offset in 1/ff-chip units."""
    return b - k if b > k // 2 else b


def _align_fast(residual: np.ndarray, tmpl: np.ndarray, cfg: LoraConfig,
                pre_ts: int, device: torch.device = torch.device("cpu")
                ) -> int | None:
    """Dechirp-domain timing fix: O(symbol) instead of the O(search x
    head) brute correlation of ``_align``.  Classic LoRa sync: for a trial
    origin s0, an up-dechirped preamble window peaks at bin
    u = eps + tau*ff/p and an SFD down-dechirped window at
    d = eps - tau*ff/p (eps = CFO, tau = timing error), so
    tau = (u - d)/2 * p/ff samples with 1/ff-chip resolution.  Round 1
    folds the up-peak alone (CFO-free fixtures put eps ~ 0) to bring a
    +-2-symbol hint inside the SFD capture range; round 2 applies the
    CFO-immune (u - d)/2 fix; a final 3-point template-dot check picks
    the exact integer sample.  Returns None when any window leaves the
    buffer or the final candidates score zero — the caller falls back to
    the exhaustive ``_align``.  The tone probes run on ``device``."""
    n = cfg.num_samples
    k = cfg.bin_size
    hint = pre_ts - 7 * n
    if hint < -2 * n and hint + TIMESTAMP_MOD < residual.shape[0]:
        hint += TIMESTAMP_MOD

    def window(s):
        return _upload(to_ri(residual[s:s + n]), device)

    s = hint
    su = s + 2 * n                              # mid-preamble upchirp
    if su < 0 or su + n > residual.shape[0]:
        return None
    with torch.no_grad():
        u = _signed(int(up_peak(window(su), cfg)[0]), k)
    tau = u * cfg.p / cfg.fft_factor            # eps ~ 0 coarse fix
    if abs(tau) > n:
        return None
    s = int(round(s - tau))
    su, sd = s + 2 * n, s + 10 * n + n // 2     # mid-preamble / inside SFD
    if su < 0 or sd < 0 or sd + n > residual.shape[0]:
        return None
    # Both tones on the device, then ONE copy of both indices to the host.
    with torch.no_grad():
        ud = torch.stack([up_peak(window(su), cfg)[0],
                          down_peak(window(sd), cfg)[0]]).cpu()
    u, d = _signed(int(ud[0]), k), _signed(int(ud[1]), k)
    # The down window deliberately sits n/2 INTO the SFD downchirp, so
    # d = eps - (tau + n/2)*ff/p: remove the half-symbol placement bias.
    tau = ((u - d) * cfg.p / cfg.fft_factor - n / 2.0) / 2.0
    if abs(tau) <= n // 4:
        s = int(round(s - tau))
    # Integer verification against the payload-independent preamble head.
    # The dechirp fix resolves tau mod n only (the preamble is n-periodic)
    # — the sync word + SFD in the head break that ambiguity, so the
    # candidates include +-1 whole symbol.
    head = tmpl[: (49 * n) // 4]
    best, bs = 0.0, None
    for c in (s - n - 1, s - n, s - n + 1, s - 1, s, s + 1,
              s + n - 1, s + n, s + n + 1):
        if c < 0 or c + len(head) > residual.shape[0]:
            continue
        sc = abs(np.vdot(head, residual[c:c + len(head)]))
        if sc > best:
            best, bs = sc, c
    return bs


def _subtract(residual: np.ndarray, syms: np.ndarray, cfg: LoraConfig,
              pre_ts: int, search: int | None = None,
              start: int | None = None, fast_align: bool = False,
              device: torch.device = torch.device("cpu")):
    """Reconstruct the packet, align it (``_align`` / ``_align_fast``),
    LS-fit per-chunk complex gains, subtract in place.  Returns
    (subtracted?, captured energy fraction, start index, subtracted
    waveform or None)."""
    n = cfg.num_samples
    tmpl = modulate(syms, cfg, pad_front=0, pad_back=0)
    if start is None and fast_align:
        start = _align_fast(residual, tmpl, cfg, pre_ts, device)
    if start is None:
        start = _align(residual, tmpl, cfg, pre_ts, search)
    if start is None or start + n > residual.shape[0]:
        return False, 0.0, None, None
    span = residual[start:start + len(tmpl)]
    t = tmpl[:len(span)]

    # Gain estimation is the delicate part.  A naive per-chunk LS gain
    # also projects out whatever OTHER signal shares the chunk — it
    # distorts a weaker packet's preamble lying under the strong span.
    # Instead:
    #   1. fit per-chunk LS gains g_k (chunk = one symbol),
    #   2. take the robust center g = median(g_k) — chunks contaminated
    #      by another packet or holding a mis-tracked symbol are outliers,
    #      the clean majority pins the true gain,
    #   3. subtract g*s_k only where doing so DECREASES chunk energy
    #      (Re(conj(g) g_k) > |g|^2/2).  A wrong-symbol chunk (g_k ~ 0)
    #      is left untouched — its aired chirp stays in the residual,
    #      which is the honest content for the next pass.
    e_before = float(np.sum(np.abs(span) ** 2))
    if e_before <= 0.0:
        return False, 0.0, start, None
    gains = []
    for k in range(0, len(t), n):
        sk = t[k:k + n]
        denom = float(np.sum(np.abs(sk) ** 2))
        if denom > 0.0:
            gains.append(np.vdot(sk, span[k:k + n]) / denom)
    if not gains:
        return False, 0.0, start, None
    gains = np.asarray(gains, np.complex64)
    g = complex(np.median(gains.real), np.median(gains.imag))
    g2 = abs(g) ** 2
    if g2 <= 0.0:
        return False, 0.0, start, None
    removed = 0.0
    own = np.zeros(len(span), np.complex64)
    for i, k in enumerate(range(0, len(t), n)):
        sk = t[k:k + n]
        denom = float(np.sum(np.abs(sk) ** 2))
        if denom <= 0.0:
            continue
        if (g * np.conj(gains[i])).real > g2 / 2:
            own[k:k + n] = np.complex64(g) * sk
            removed += g2 * denom
    span -= own
    captured = removed / e_before
    return True, captured, start, own


def _reextract(clean: np.ndarray, cfg: LoraConfig, start: int,
               nsym: int, device: torch.device = torch.device("cpu")
               ) -> np.ndarray | None:
    """Re-read a packet's symbols by direct per-window dechirp peaks at a
    KNOWN sample-exact start — the single-packet matched filter the
    tracker cannot be: after the other colliding packets are cancelled,
    each window holds one tone plus leftovers, and the folded argmax
    (ops/dechirp.up_peak — the plain demod's own peak search,
    demod_impl.cc:162-202) recovers the symbol even where the Pyramid
    track was corrupted or truncated.  Returns tracker-convention uint16
    symbols (bin // fft_factor, as the tracker's assembly emits) or None
    if the packet spills past the buffer.  One batch of windows on
    ``device``, one copy of its peak bins back."""
    n = cfg.num_samples
    pay0 = start + (49 * n) // 4          # payload begins after 12.25 syms
    if pay0 + nsym * n > clean.shape[0] or start < 0:
        return None
    # Reference bin from mid-preamble windows (value-0 chirps): immune to
    # integer CFO, cheap, and windows 1-5 are guaranteed clean upchirps.
    wins = [clean[start + k * n: start + (k + 1) * n] for k in range(1, 6)]
    wins += [clean[pay0 + k * n: pay0 + (k + 1) * n] for k in range(nsym)]
    with torch.no_grad():
        idx, _ = up_peak(_upload(to_ri(np.stack(wins)), device), cfg)
        idx = idx.cpu().numpy().astype(np.int64)
    pre_bin = int(np.median(idx[:5]))
    k_bins = (1 << cfg.sf) * cfg.fft_factor
    bins = (idx[5:] - pre_bin) % k_bins
    return ((bins // cfg.fft_factor) % (1 << cfg.sf)).astype(np.uint16)


def _is_clean(r, cfg: LoraConfig) -> bool:
    """Fully-decoded: structural + header + CRC (when present)."""
    return bool(r.ok and (not cfg.explicit_header
                          or (r.header is not None and r.header.is_valid))
                and r.crc_ok is not False)


def _nsym_of(r, cfg: LoraConfig) -> int | None:
    """On-air symbol count, from the explicit header or the config."""
    if cfg.explicit_header:
        if r.header is None or not r.header.is_valid:
            return None
        return calc_sym_num(r.header.payload_len, sf=cfg.sf,
                            cr=r.header.cr, crc=r.header.crc, ldr=cfg.ldr,
                            explicit_header=True)
    return calc_sym_num(cfg.payload_len, sf=cfg.sf, cr=cfg.cr, crc=cfg.crc,
                        ldr=cfg.ldr, explicit_header=False)


def _refine(residual: np.ndarray, cfg: LoraConfig, recs: list,
            fast_align: bool = False,
            device: torch.device = torch.device("cpu")) -> bool:
    """Second chance for every tracked-but-not-clean packet: with the
    OTHER packets already cancelled out of ``residual``, re-add this
    packet's own subtracted waveform and re-read its symbols by direct
    per-window peaks at its aligned position (_reextract).  Fixes both
    Pyramid failure modes the envelope sweep surfaces — a window stolen
    by a colliding peak (corrupted symbol => CRC fail) and a truncated
    track (too few symbols) — neither of which a re-RUN of the tracker
    can see, because this packet's energy is already subtracted.  On
    success the packet's subtraction is redone with the corrected
    symbols.  Returns True if anything improved."""
    n = cfg.num_samples
    progressed = False
    for rec in recs:
        if rec.get("done"):
            continue
        q: SicPacket = rec["entry"]
        r = decode(q.symbols, cfg)
        if _is_clean(r, cfg):
            rec["done"] = True
            continue
        nsym = _nsym_of(r, cfg)
        if nsym is None or nsym < 8:
            continue
        start = rec.get("start")
        if start is None:
            guess = np.zeros(nsym, np.uint16)
            guess[:min(len(q.symbols), nsym)] = q.symbols[:nsym]
            tmpl = modulate(guess, cfg, pad_front=0, pad_back=0)
            if fast_align:
                start = _align_fast(residual, tmpl, cfg, q.position, device)
            if start is None:
                start = _align(residual, tmpl, cfg, q.position)
            rec["start"] = start
        if start is None:
            continue
        need = (49 * n) // 4 + nsym * n
        if start + need > residual.shape[0]:
            continue
        clean = np.array(residual[start:start + need], copy=True)
        own = rec.get("own")
        if own is not None:
            m = min(len(own), need)
            clean[:m] += own[:m]
        syms2 = _reextract(clean, cfg, 0, nsym, device)
        if syms2 is None:
            continue
        r2 = decode(syms2, cfg)
        if not _is_clean(r2, cfg):
            continue
        # Corrected decode: undo the stale subtraction, re-subtract the
        # now-exact reconstruction, and update the packet in place.
        if own is not None:
            residual[start:start + len(own)] += own
        sub, captured, _, own2 = _subtract(residual, syms2, cfg,
                                           q.position, start=start)
        rec["own"] = own2
        q.symbols = syms2
        q.subtracted = sub
        q.captured = captured
        q.refined = True
        rec["done"] = True
        progressed = True
    return progressed


def sic_demodulate(iq, cfg: LoraConfig, max_passes: int = 3,
                   max_peaks: int = 16, backend: str = "xla",
                   grace: int = 0, use_native: bool | None = None,
                   refine: bool = True, fast_align: bool = False,
                   lattice_block_hops: int | None = None,
                   split_repeats: bool = False,
                   known: list | None = None,
                   residual_gate: float | None = None,
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> list[SicPacket]:
    """IQ stream -> every recoverable colliding packet, with successive
    interference cancellation between Pyramid passes (module doc).

    Drop-in superset of models.pyramid.pyramid_demodulate: pass 0 yields
    exactly its packets; later passes add packets only visible once
    stronger decoded packets are subtracted, and ``refine`` re-reads
    corrupted/truncated tracks in place once their colliders are
    cancelled (_refine).  ``max_passes`` bounds the loop; it exits early
    when a pass neither finds nor fixes anything.  The lattice and the
    tone probes run on ``device`` (the card unless the caller passes
    ``device="cpu"``); ``use_native`` selects the tracker as in
    pyramid_demodulate.

    ``known``: [(position, symbols), ...] packets ALREADY tracked for
    this buffer (the gateway's fast path) — pass 0 then uses them
    directly instead of re-running the Pyramid pass.
    ``residual_gate``: after pass 0's cancellations, stop if the residual
    keeps less than this fraction of the original energy — the window is
    explained by its decoded packets.  A masked collider at amplitude
    ratio 0.2 holds ~3.8 % of the window's power, so the gateway default
    of 2 % keeps the full 66/66 recovery envelope while single-packet
    windows pay only one subtraction instead of two dense demod passes.
    Gate failures fall through to the full loop — an unsubtractable known
    (alignment mis-fit) leaves the energy in place, which reads as
    unexplained."""
    dev = resolve_device(device)
    if np.iscomplexobj(iq):
        residual = np.array(iq, dtype=np.complex64, copy=True)
    else:
        ri = np.asarray(iq, np.float32)
        residual = (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)

    n = cfg.num_samples
    e0 = float(np.vdot(residual, residual).real)
    out: list[SicPacket] = []
    recs: list[dict] = []
    seen: list[tuple[bytes, int]] = []      # (symbol bytes, position)

    for p in range(max_passes):
        if p == 0 and known is not None:
            found = [(int(ts), np.asarray(syms, np.uint16))
                     for ts, syms in known]
        else:
            found = _demod_pass(to_ri(residual), cfg, max_peaks, backend,
                                grace, use_native, lattice_block_hops,
                                split_repeats, dev)
        new = []
        for ts, syms in found:
            key = syms.tobytes()
            if any(k == key and abs(ts - kt) < 4 * n for k, kt in seen):
                continue
            seen.append((key, ts))
            new.append((ts, syms))
        progressed = False
        for ts, syms in new:
            _, trimmed = _trim_to_packet(syms, cfg)
            sub, captured, start, own = (False, 0.0, None, None)
            if trimmed is not None and p + 1 < max_passes:
                sub, captured, start, own = _subtract(
                    residual, trimmed, cfg, ts, fast_align=fast_align,
                    device=dev)
                progressed = progressed or sub
            q = SicPacket(position=int(ts), symbols=syms, sic_pass=p,
                          subtracted=sub, captured=captured)
            out.append(q)
            recs.append({"entry": q, "start": start, "own": own})
        if refine:
            progressed = _refine(residual, cfg, recs, fast_align=fast_align,
                                 device=dev) or progressed
        if residual_gate is not None and e0 > 0:
            # Residual-energy gate (docstring): the window is explained
            # — whatever is left is below the weakest recoverable
            # collider — so skip the remaining demod passes.
            e_res = float(np.vdot(residual, residual).real)
            if e_res < residual_gate * e0:
                break
        if p == 0 and known is not None:
            # The known-packet pass carries no self-derived evidence:
            # unless the gate above declared the window explained,
            # always run at least one dense pass — a known that fails
            # to align leaves progressed=False, but the dense pass's
            # own timestamps may still recover the window (and with
            # residual_gate=None this is what makes the loop truly
            # unconditional).
            continue
        if not progressed:
            break
    out.sort(key=lambda q: q.position)
    return out


def sic_symbol_streams(iq, cfg: LoraConfig, **kw) -> list[np.ndarray]:
    """pyramid_demodulate-shaped convenience: just the symbol vectors."""
    return [q.symbols for q in sic_demodulate(iq, cfg, **kw)]
