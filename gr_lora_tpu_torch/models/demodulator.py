"""Single-packet demodulator: IQ stream -> symbol vectors.

Port of gr_lora_tpu/models/demodulator.py, the reference's 7-state FSM
(demod_impl.cc:293-628).  The JAX package runs it as a ``lax.while_loop``
vmapped over lanes; here the same step runs batched over a leading lane
axis on ``models/fsm_loop.StepLoop`` (captured in a CUDA graph on the card,
eager on the CPU), with no host synchronisation inside a step.  Each step
takes the lanes' windows in one gather per data dependency and transforms
them with one ``ops/dft.ZoomDft`` call per dechirp direction (the "down"
plan on the window at ``ptr``; the "up" plan on it and on the CFO window);
``sfd_compute``, ``parse`` and ``emit`` are computed for every lane and
selected, as vmap computes both sides of a ``lax.cond``.  That plain
``body`` runs on the CPU; on the card a loop steps through
``ops/fsm_step.FsmStep``, the same step as three hand-written kernels
around the same two FFTs.

States: 0 RESET, 1 PREFILL, 2 DETECT_PREAMBLE, 3 SFD_SYNC, 4 READ_HEADER,
5 READ_PAYLOAD, 6 OUT (reference enum: include/lora/demod.h:41-49).

The output slots stay int32 on the device; the host-facing functions
cast them to the JAX package's dtypes (uint16 symbols).  The transform is
an f32 FFT, where the JAX package's is a matmul at ``cfg.precision``.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import (DEMOD_SYNC_RECOVERY_COUNT, REQUIRED_PREAMBLE_CHIRPS,
                      LoraConfig)
from ..core.header import calc_sym_num
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..ops.cplx import cmag, to_ri
from ..ops.dechirp import band_peak, device_plan
from ..ops.fsm_step import FsmStep
from .fsm_loop import BUILT_CACHE, StepLoop, lane_mask, offsets, windows

_RESET, _PREFILL, _DETECT, _SFD, _HEADER, _PAYLOAD, _OUT = range(7)


def _fpmod(x, n):
    """Python-style float modulo (reference: utilities.h:48-51); floor
    modulo, as ``jnp.mod``."""
    return torch.remainder(torch.remainder(x, n) + n, n)


def _pmod(x, n):
    return torch.remainder(torch.remainder(x, n) + n, n)


def _popcount8(x):
    """Popcount of a uint8-ranged int32."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _header_checksum(length, cr_crc):
    """5-bit header checksum of int32 tensors (reference:
    utilities.h:96-120)."""
    a = [(length >> (4 + k)) & 1 for k in range(4)]
    b = [(length >> k) & 1 for k in range(4)]
    c = [(cr_crc >> k) & 1 for k in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def compensate(symbols, count, nsym: float, modulus: float, enabled: bool,
               wrap_out):
    """The LDR bin-drift integrator of both FSMs, over the last axis.

    The JAX package runs it as a ``lax.scan``: ``comp`` starts at 0 and
    ``v_last`` at 1, and each live symbol subtracts its wrapped drift
    ``fpmod(v - v_last, modulus)``.  Here that is a ``torch.cumsum`` of the
    masked drifts.  It is exact, whatever the order of summation: each
    symbol is ``fpmod((midx - cfo) / fft_factor, nsym)`` with integer
    ``midx`` and ``cfo``, so every drift and every partial sum is a small
    multiple of 1 / fft_factor.  Returns int32 with zeros past ``count``.
    """
    ms = symbols.shape[-1]
    if isinstance(count, torch.Tensor):
        count = count[..., None]
    live = offsets(ms, symbols.device) < count
    if enabled:
        prev = torch.cat([torch.ones_like(symbols[..., :1]),
                          symbols[..., :-1]], dim=-1)
        drift = _fpmod(symbols - prev, modulus)
        drift = torch.where(drift < modulus / 2, drift, drift - modulus)
        comp = -torch.cumsum(torch.where(live, drift, 0.0), dim=-1)
        v = symbols + comp
    else:
        v = symbols
    out = wrap_out(torch.floor(_fpmod(v, nsym) + 0.5), nsym)
    return torch.where(live, out, 0.0).to(torch.int32)


def _dynamic_compensation(symbols, count, cfg: LoraConfig):
    """LDR bin-drift integrator (reference: demod_impl.cc:263-284).

    symbols: float32 [..., MS]; only the first ``count`` (an int, or an
    int32 tensor [...]) entries are live.  Returns int32 [..., MS]
    compensated symbols (zero past count); the reference zeroes the
    integrator when !ldr (:280).
    """
    return compensate(symbols, count, float(cfg.num_symbols), 4.0,
                      cfg.ldr, _pmod)


@lru_cache(maxsize=None)
def _header_tables(sf: int, device: torch.device):
    """The deinterleave shifts [ppm, 8], the bit weights [8] and the
    Hamming fix table, on ``device``."""
    ppm = sf - 2
    y = np.arange(ppm)[:, None]
    i = np.arange(8)[None, :]
    sh = torch.from_numpy(((y - i) % ppm).astype(np.int32)).to(device)
    bit = torch.from_numpy(np.arange(8, dtype=np.int32)).to(device)
    fix = torch.from_numpy(np.array([0, 0, 0, 0x08, 0, 0x04, 0x01, 0x02],
                                    np.int32)).to(device)
    return sh, bit, fix


def _parse_header(comp8, cfg: LoraConfig):
    """Explicit-header parse of the 8 compensated header symbols, int32
    [..., 8] (``_parse_header_jnp``).

    Mirrors decode_impl.cc:299-355 (normalize /4, Gray, deinterleave at
    ppm=sf-2/rdd=4, Hamming-correct, checksum).  Returns
    (is_valid, payload_len, cr, crc, packet_symbol_len), each [...].
    """
    sf = cfg.sf
    sh, bit, fix = _header_tables(sf, comp8.device)
    v = torch.div(comp8, 4, rounding_mode="floor").to(torch.int32)
    g = v ^ (v >> 1)
    # Deinterleave: cw[y] bit i = bit ((y - i) mod ppm) of g[i].
    bits = (g[..., None, :] >> sh) & 1
    cw = (bits << bit).sum(dim=-1, dtype=torch.int32)
    # Hamming syndrome correction (decode masks, decode_impl.cc:36-43,197-222).
    p1 = _popcount8(cw & 0x2E) & 1
    p2 = _popcount8(cw & 0x4B) & 1
    p3 = _popcount8(cw & 0x17) & 1
    syndrome = (p3 << 2) | (p2 << 1) | p1
    cw = cw ^ fix[syndrome.to(torch.int64)]
    nib = cw & 0xF
    plen = (nib[..., 0] << 4) | nib[..., 1]
    crc = nib[..., 2] & 1
    cr = nib[..., 2] >> 1
    cks = (nib[..., 3] << 4) | nib[..., 4]
    valid = cks == _header_checksum(plen, nib[..., 2] & 0xF)
    # Packet symbol count (demod_impl.cc:250; explicit header => -5*!h == 0):
    # ceil((2 plen - sf + 7 + 4 crc) / denom) as an integer division, exact
    # on every device (the card divides a tensor by a Python number as a
    # product with its f32 reciprocal, whose ceil can be one too many).
    denom = sf - 2 * int(cfg.ldr)
    num = 2 * plen - sf + 7 + 4 * crc
    blocks = -torch.div(-num, denom, rounding_mode="floor")
    psl = 8 + torch.clamp((4 + cr) * blocks, min=0)
    return valid, plen, cr, crc, psl.to(torch.int32)


class _State(NamedTuple):
    """The FSM state of every lane, each field with a leading lane axis
    (``_State`` of the JAX package, same fields in the same order)."""

    ptr: torch.Tensor
    st: torch.Tensor
    hist: torch.Tensor          # int32[L, REQUIRED_PREAMBLE_CHIRPS]
    hist_len: torch.Tensor
    sync_cnt: torch.Tensor
    cfo: torch.Tensor
    snr: torch.Tensor           # peak/mean ratio at preamble detection
    syms: torch.Tensor          # float32[L, MS]
    sym_cnt: torch.Tensor
    pkt_sym_len: torch.Tensor
    hdr_received: torch.Tensor
    hdr_valid: torch.Tensor
    pkt_start: torch.Tensor     # sample index of preamble detection (buffer-local)
    base: torch.Tensor          # global stream index of buffer sample 0
    out_syms: torch.Tensor      # int32[L, MP, MS] (uint16 at the host)
    out_len: torch.Tensor       # int32[L, MP]
    out_pos: torch.Tensor       # int32[L, MP] packet start (global stream index)
    out_snr: torch.Tensor       # float32[L, MP] peak/mean ratio at detection
    out_cnt: torch.Tensor
    it: torch.Tensor


def max_packet_symbols(cfg: LoraConfig) -> int:
    """Static bound on symbols per packet for buffer sizing.

    At least 9: the FSM (like the reference, demod_impl.cc:531-553) pushes a
    9th symbol while still in S_READ_HEADER before it can transition, so even
    an 8-symbol packet emits 9 symbols.
    """
    if not cfg.explicit_header:
        return max(
            calc_sym_num(cfg.payload_len, sf=cfg.sf, cr=cfg.cr, crc=cfg.crc,
                         ldr=cfg.ldr, explicit_header=False),
            9,
        )
    return max(
        calc_sym_num(255, sf=cfg.sf, cr=cr, crc=True, ldr=cfg.ldr,
                     explicit_header=True)
        for cr in range(1, 5)
    )


@lru_cache(maxsize=None)
def _machine(cfg: LoraConfig, max_packets: int):
    """The demod FSM transition function, shared by the whole-buffer and
    streaming runs.  Returns (body, init_state, kernel):
    ``body(iq [L, T, 2], s, active [L]) -> s`` steps every lane and leaves
    inactive lanes unchanged; ``init_state(lanes, base, ptr, device)``;
    ``kernel(loop)`` builds the same step as kernels for a StepLoop on
    the card (``ops/fsm_step.FsmStep``)."""
    n = cfg.num_samples
    k = cfg.bin_size
    fac = cfg.fft_factor
    p = cfg.p
    nsym = cfg.num_symbols
    ms = max_packet_symbols(cfg)
    mp = max_packets
    lookback = (21 * n) // 4   # 5.25 symbols, CFO re-estimate (demod_impl.cc:486)
    drift_max = cfg.preamble_drift_max
    implicit_psl = 0 if cfg.explicit_header else cfg.packet_symbol_len()
    npre = REQUIRED_PREAMBLE_CHIRPS

    def init_state(lanes: int, base: int, ptr: int,
                   device: torch.device) -> _State:
        def full(shape, value, dtype):
            return torch.full((lanes,) + shape, value, dtype=dtype,
                              device=device)

        i32, f32 = torch.int32, torch.float32
        return _State(
            ptr=full((), ptr, i32), st=full((), _RESET, i32),
            hist=full((npre,), 0, i32), hist_len=full((), 0, i32),
            sync_cnt=full((), 0, i32), cfo=full((), 0.0, f32),
            snr=full((), 0.0, f32), syms=full((ms,), 0.0, f32),
            sym_cnt=full((), 0, i32), pkt_sym_len=full((), implicit_psl, i32),
            hdr_received=full((), False, torch.bool),
            hdr_valid=full((), False, torch.bool),
            pkt_start=full((), 0, i32), base=full((), base, i32),
            out_syms=full((mp, ms), 0, i32), out_len=full((mp,), 0, i32),
            out_pos=full((mp,), -1, i32), out_snr=full((mp,), 0.0, f32),
            out_cnt=full((), 0, i32), it=full((), 0, i32))

    def body(iq, s: _State, active) -> _State:
        dev = iq.device
        # A lane past its loop condition takes no branch (state code -1)
        # and keeps ptr, hist and it below: vmap's frozen lane.
        code = torch.where(active, s.st, -1)
        win = windows(iq, s.ptr[:, None], n)                 # [L, 1, n, 2]

        # ---- sfd_compute's transforms, for every lane (lax.cond under vmap).
        dlo, dhi = device_plan("down", cfg.sf, p, fac, dev)(win[:, 0])
        didx, dval = band_peak(dlo, dhi, cfg)
        idx = torch.where(didx > k // 2, didx - k, didx)
        nc_f = 2.25 * n + p * idx.to(torch.float32) / 2.0 / fac
        nc_sfd = torch.floor(nc_f + 0.5).to(torch.int32)
        cfo_start = torch.clamp(s.ptr + nc_sfd - lookback, min=0)
        cfo_win = windows(iq, cfo_start[:, None], n)
        lo, hi = device_plan("up", cfg.sf, p, fac, dev)(
            torch.cat([win, cfo_win], dim=1))                # [L, 2, K, 2]
        pidx, pval = band_peak(lo, hi, cfg)
        midx, mval, cidx = pidx[:, 0], pval[:, 0], pidx[:, 1]
        # Peak-to-mean of the ABS fold: the SNR proxy recorded at detection.
        folded = cmag(lo[:, 0]) + cmag(hi[:, 0])
        sval, smean = folded.amax(dim=-1), folded.mean(dim=-1)

        hist = torch.cat([midx[:, None], s.hist[:, :-1]], dim=1)
        hist_len = torch.clamp(s.hist_len + 1, max=npre)
        nc = torch.full_like(s.ptr, n)
        st = s.st

        # ---- S_RESET: clear and go to PREFILL (demod_impl.cc:369-386).
        do_reset = code == _RESET
        hist_len = torch.where(do_reset, 0, hist_len)
        sync_cnt = torch.where(do_reset, 0, s.sync_cnt)
        sym_cnt = torch.where(do_reset, 0, s.sym_cnt)
        hdr_received = s.hdr_received & ~do_reset
        hdr_valid = s.hdr_valid & ~do_reset
        st = torch.where(do_reset, _PREFILL, st)

        # ---- S_PREFILL (demod_impl.cc:390-401).
        st = torch.where((code == _PREFILL) & (hist_len >= npre), _DETECT, st)

        # ---- S_DETECT_PREAMBLE (demod_impl.cc:406-438).
        do_det = code == _DETECT
        pre_idx = hist[:, 0]
        dis = _pmod(pre_idx[:, None] - hist[:, 1:], k)
        # mval > 0 gates out exactly-zero windows (halo padding).
        pre_found = ((dis <= drift_max) | (dis >= k - drift_max)).all(dim=1) \
            & (mval > 0)
        det_hit = do_det & pre_found
        nc = torch.where(det_hit, n - (p * pre_idx) // fac, nc)
        st = torch.where(det_hit, _SFD, st)
        pkt_start = torch.where(det_hit, s.ptr, s.pkt_start)
        snr = torch.where(det_hit, sval / torch.clamp(smean, min=1e-20),
                          s.snr)

        # ---- S_SFD_SYNC (demod_impl.cc:444-504).
        do_sfd = code == _SFD
        bail = do_sfd & (s.sync_cnt > DEMOD_SYNC_RECOVERY_COUNT)
        sync_cnt = torch.where(do_sfd, sync_cnt + 1, sync_cnt)
        detect = do_sfd & (dval > mval)
        nc = torch.where(detect, nc_sfd, nc)
        cfo = torch.where(detect, cidx.to(torch.float32), s.cfo)
        # Bail sets RESET, but an SFD hit in the same call overrides
        # (reference has no else between the two, demod_impl.cc:449-501).
        st = torch.where(bail & ~detect, _RESET, st)
        st = torch.where(detect, _HEADER, st)

        # ---- S_READ_HEADER (demod_impl.cc:508-554).
        do_hdr = code == _HEADER
        bin_idx = _fpmod((midx.to(torch.float32) - cfo) / fac, float(nsym))
        slot = offsets(ms, dev) == torch.clamp(sym_cnt, max=ms - 1)[:, None]
        syms = torch.where(do_hdr[:, None] & slot, bin_idx[:, None], s.syms)
        sym_cnt = torch.where(do_hdr, torch.clamp(sym_cnt + 1, max=ms),
                              sym_cnt)
        pkt_sym_len = s.pkt_sym_len

        if cfg.explicit_header:
            hdr_trigger = do_hdr & (sym_cnt == 8)
            comp8 = _dynamic_compensation(syms[:, :8], 8, cfg)
            valid, _, _, _, psl = _parse_header(comp8, cfg)
            hdr_received = hdr_received | hdr_trigger
            hdr_valid = torch.where(hdr_trigger, valid, hdr_valid)
            pkt_sym_len = torch.where(hdr_trigger & valid, psl, pkt_sym_len)

            go = do_hdr & (sym_cnt > 8) & hdr_received
            st = torch.where(go & ~hdr_valid, _RESET, st)
            st = torch.where(go & hdr_valid, _PAYLOAD, st)
        else:
            pkt_sym_len = torch.where(do_hdr, implicit_psl, pkt_sym_len)
            st = torch.where(do_hdr & (sym_cnt > 8), _PAYLOAD, st)

        # ---- S_READ_PAYLOAD (demod_impl.cc:558-580).
        do_pay = code == _PAYLOAD
        done = do_pay & (s.sym_cnt >= pkt_sym_len)
        push = do_pay & ~done
        slot = offsets(ms, dev) == torch.clamp(sym_cnt, max=ms - 1)[:, None]
        syms = torch.where(push[:, None] & slot, bin_idx[:, None], syms)
        sym_cnt = torch.where(push, torch.clamp(sym_cnt + 1, max=ms), sym_cnt)
        st = torch.where(done, _OUT, st)

        # ---- S_OUT (demod_impl.cc:585-607): emit into the next free slot.
        # out_cnt counts every completed packet (uncapped) so slot overflow
        # is observable; callers report min(cnt, mp) live slots and
        # cnt - mp dropped (the reference only printf's, SURVEY §5).
        do_out = code == _OUT
        comp = _dynamic_compensation(syms, sym_cnt, cfg)
        row = offsets(mp, dev) == torch.clamp(s.out_cnt, max=mp - 1)[:, None]
        put = (do_out & (s.out_cnt < mp))[:, None] & row     # [L, MP]
        out_syms = torch.where(put[..., None], comp[:, None, :], s.out_syms)
        out_len = torch.where(put, sym_cnt[:, None], s.out_len)
        out_pos = torch.where(put, (pkt_start + s.base)[:, None], s.out_pos)
        out_snr = torch.where(put, snr[:, None], s.out_snr)
        out_cnt = s.out_cnt + do_out.to(torch.int32)
        st = torch.where(do_out, _RESET, st)

        return _State(
            ptr=s.ptr + torch.where(active, nc, 0), st=st,
            hist=torch.where(lane_mask(active, hist), hist, s.hist),
            hist_len=torch.where(active, hist_len, s.hist_len),
            sync_cnt=sync_cnt, cfo=cfo, snr=snr, syms=syms, sym_cnt=sym_cnt,
            pkt_sym_len=pkt_sym_len, hdr_received=hdr_received,
            hdr_valid=hdr_valid, pkt_start=pkt_start, base=s.base,
            out_syms=out_syms, out_len=out_len, out_pos=out_pos,
            out_snr=out_snr, out_cnt=out_cnt,
            it=s.it + active.to(torch.int32))

    return body, init_state, partial(FsmStep, cfg, max_packets)


def _outputs(final: _State, mp: int):
    """(packets int32[L, MP, MS], lengths, positions, count, dropped, snr)
    of a final state."""
    return (final.out_syms, final.out_len, final.out_pos,
            torch.clamp(final.out_cnt, max=mp),
            torch.clamp(final.out_cnt - mp, min=0), final.out_snr)


def _fresh_outputs(s: _State, mp: int) -> _State:
    """``s`` with fresh output slots and iteration budget (the streaming
    run's per-block reset)."""
    return s._replace(out_syms=torch.zeros_like(s.out_syms),
                      out_len=torch.zeros_like(s.out_len),
                      out_pos=torch.full_like(s.out_pos, -1),
                      out_snr=torch.zeros_like(s.out_snr),
                      out_cnt=torch.zeros_like(s.out_cnt),
                      it=torch.zeros_like(s.it))


class Demod:
    """The whole-buffer demodulator for one input length on one device
    (what ``demod_fn`` returns): ``fn(iq [..., T, 2]) -> (packets
    int32[..., MP, MS], lengths int32[..., MP], positions int32[..., MP],
    count int32[...], dropped int32[...], snr float32[..., MP])`` as
    tensors on the device, batched over the leading axes (the JAX
    package's ``jax.vmap(demod_fn(...))``).  One ``StepLoop`` per lane
    count, built at its first call.

    The buffer is ``PAD_FRONT`` symbols of zeros (the GR history prefill,
    demod_impl.cc:130,299-301), the input, ``PAD_BACK`` symbols of zeros;
    a lane runs while ``ptr + REACH`` symbols fit and for at most
    ``ITERS_PER_SYMBOL`` steps a buffer symbol (+ 64).  models/weak.py's
    ``WeakDemod`` is this class with the weak machine's constants."""

    PAD_FRONT, PAD_BACK, REACH, ITERS_PER_SYMBOL = 6, 1, 1, 8
    machine = staticmethod(_machine)
    outputs = staticmethod(_outputs)

    def __init__(self, cfg: LoraConfig, num_samples_total: int,
                 max_packets: int, device: torch.device):
        n = cfg.num_samples
        self.cfg = cfg
        self.num_samples_total = num_samples_total
        self.max_packets = max_packets
        self.device = device
        self.body, self.init_state, self.kernel = self.machine(
            cfg, max_packets)
        self.pad_front = self.PAD_FRONT * n
        self.buf_len = self.pad_front + num_samples_total + self.PAD_BACK * n
        self.max_iters = self.ITERS_PER_SYMBOL * (self.buf_len // n) + 64
        self.loops: dict[int, StepLoop] = {}

    def make_loop(self, lanes: int, graphed: bool | None = None) -> StepLoop:
        init = self.init_state(lanes, -self.pad_front, self.pad_front,
                               self.device)
        return StepLoop(self.body, init, self.buf_len,
                        self.REACH * self.cfg.num_samples, self.max_iters,
                        graphed, self.kernel)

    def run(self, loop: StepLoop, iq: torch.Tensor):
        """Fill ``loop``'s buffer with iq [lanes, T, 2] and run it from
        the initial state; returns the outputs."""
        lanes = iq.shape[0]
        pad = self.pad_front
        loop.iq[:, pad:pad + self.num_samples_total].copy_(iq)
        final = loop.run(self.init_state(lanes, -pad, pad, self.device))
        return self.outputs(final, self.max_packets)

    def __call__(self, iq):
        x = torch.as_tensor(iq, dtype=torch.float32).to(self.device)
        lead = x.shape[:-2]
        x = x.reshape(-1, self.num_samples_total, 2)
        lanes = x.shape[0]
        if lanes not in self.loops:
            self.loops[lanes] = self.make_loop(lanes)
        outs = self.run(self.loops[lanes], x)
        return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


def demod_fn(cfg: LoraConfig, num_samples_total: int, max_packets: int = 8,
             device: str | torch.device = DEFAULT_DEVICE) -> Demod:
    """The demodulator for a fixed input length on ``device`` (the card
    unless the caller asks for the CPU).  See ``Demod``."""
    return _demod(cfg, num_samples_total, max_packets,
                  resolve_device(device))


@lru_cache(maxsize=BUILT_CACHE)
def _demod(cfg, num_samples_total, max_packets, device) -> Demod:
    return Demod(cfg, num_samples_total, max_packets, device)


# ---------------------------------------------------------------------------
# Streaming: carried FSM state across fixed-size blocks.
# ---------------------------------------------------------------------------

def stream_tail_len(cfg: LoraConfig) -> int:
    """Carried history per block: covers the 5.25-symbol CFO lookback, the
    current symbol window, and slack — the GR ``set_history`` analog
    (demod_impl.cc:130)."""
    return 8 * cfg.num_samples


class Stream:
    """The step of a streaming FSM (what ``demod_stream_fn`` returns with
    its ``init``; models/weak.py's streamer too): the state of every lane
    carried from block to block, one ``StepLoop`` per lane count.

    ``machine`` is (body, init_state, kernel); ``outputs(final, mp)`` the
    block's outputs, ``fresh(s, mp)`` the per-block reset; ``reanchor``
    the (field, sign) pairs shifted by ``block_len`` after each block."""

    def __init__(self, machine, block_len: int, max_packets: int,
                 device: torch.device, tail_len: int, reach: int,
                 max_iters: int, outputs, fresh, reanchor):
        self.body, self.init_state, self.kernel = machine
        self.block_len, self.mp = block_len, max_packets
        self.device = device
        self.tail_len = tail_len
        self.buf_len = tail_len + block_len
        self.reach, self.max_iters = reach, max_iters
        self.outputs, self.fresh = outputs, fresh
        self.reanchor = reanchor
        self.loops: dict[int, StepLoop] = {}

    def make_loop(self, lanes: int, graphed: bool | None = None) -> StepLoop:
        return StepLoop(self.body, self.init(lanes)[0], self.buf_len,
                        self.reach, self.max_iters, graphed, self.kernel)

    def step(self, carry, block):
        """``step(carry, block [L, block_len, 2]) -> (carry, outs)``: outs
        are the slots of the packets completed during this block."""
        s, tail = carry
        lanes = tail.shape[0]
        if lanes not in self.loops:
            self.loops[lanes] = self.make_loop(lanes)
        loop = self.loops[lanes]
        loop.iq[:, :self.tail_len].copy_(tail)
        loop.iq[:, self.tail_len:].copy_(block)
        final = loop.run(self.fresh(s, self.mp))
        outs = self.outputs(final, self.mp)
        # Re-anchor coordinates for the next block: its buffer starts at the
        # current buffer's sample ``block_len``.
        shift = self.block_len
        final = final._replace(**{f: getattr(final, f) + sign * shift
                                  for f, sign in self.reanchor})
        return (final, loop.iq[:, -self.tail_len:].clone()), outs

    def init(self, lanes: int = 1):
        s = self.init_state(lanes, -self.tail_len, self.tail_len,
                            self.device)
        return s, torch.zeros(lanes, self.tail_len, 2, device=self.device)


def demod_stream_fn(cfg: LoraConfig, block_len: int, max_packets: int = 8,
                    device: str | torch.device = DEFAULT_DEVICE):
    """Streaming demodulator: process the unbounded IQ stream in fixed
    ``block_len`` chunks with all FSM state (including partially received
    packets) carried between calls.

    Returns (step, init) where ``init(lanes=1) -> carry`` and
    ``step(carry, block float32[lanes, block_len, 2]) -> (carry, outs)``;
    outs is (packets, lengths, positions, count, dropped, snr) for packets
    *completed during this block* (positions are global stream sample
    indices), each with the lane axis.
    """
    stream = _stream(cfg, block_len, max_packets, resolve_device(device))
    return stream.step, stream.init


@lru_cache(maxsize=BUILT_CACHE)
def _stream(cfg, block_len, max_packets, device) -> Stream:
    n = cfg.num_samples
    if block_len < n:
        raise ValueError(f"block_len must be >= one symbol ({n})")
    tail_len = stream_tail_len(cfg)
    max_iters = 8 * ((tail_len + block_len) // n) + 64
    return Stream(_machine(cfg, max_packets), block_len, max_packets,
                  device, tail_len, n, max_iters, _outputs, _fresh_outputs,
                  (("ptr", -1), ("pkt_start", -1), ("base", 1)))


class HostSlots:
    """Two sets of host buffers for a streamer's per-block outputs, filled
    without blocking (pinned memory, behind a CUDA event, on the card), so
    block i's outputs can travel while block i + 1 is stepped."""

    def __init__(self, device: torch.device):
        self.device = device
        self._sets = [None, None]
        self._next = 0

    def fetch(self, outs):
        """Start copying ``outs`` to the host; returns a handle for
        ``wait``."""
        i, self._next = self._next, 1 - self._next
        cuda = self.device.type == "cuda"
        if self._sets[i] is None or any(
                h.shape != o.shape for h, o in zip(self._sets[i], outs)):
            self._sets[i] = [torch.empty(o.shape, dtype=o.dtype,
                                         pin_memory=cuda) for o in outs]
        for h, o in zip(self._sets[i], outs):
            h.copy_(o, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return self._sets[i], event

    @staticmethod
    def wait(handle) -> list[np.ndarray]:
        bufs, event = handle
        if event is not None:
            event.synchronize()
        return [b.numpy().copy() for b in bufs]


def host_ri(iq) -> np.ndarray:
    """Complex or [..., 2] float IQ as a host float32 [T, 2] array."""
    if np.iscomplexobj(iq):
        iq = to_ri(np.asarray(iq))
    return np.asarray(iq, np.float32).reshape(-1, 2)


class StreamingDemodulator:
    """Host-facing stateful wrapper: feed arbitrary chunks, collect packets.

    The step runs on ``device`` (the card unless the caller asks for the
    CPU); partial packets survive chunk boundaries because the whole FSM
    state is carried, so no overlap re-processing is needed."""

    def __init__(self, cfg: LoraConfig, block_len: int | None = None,
                 max_packets: int = 8, pipelined: bool = False,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_len = block_len or 64 * cfg.num_samples
        self._step, init = demod_stream_fn(cfg, self.block_len, max_packets,
                                           self.device)
        self._carry = init()
        self._pending = np.zeros((0, 2), np.float32)
        #: Completed packets that overflowed the per-block output slots
        #: (raise ``max_packets`` if this ever becomes nonzero).
        self.dropped = 0
        #: Peak/mean SNR-proxy ratio for the packets returned by the MOST
        #: RECENT feed()/flush() call, in order (convert with
        #: snr_db_estimate); reset at each call.
        self.snr_ratios: list[float] = []
        # Double buffering: with ``pipelined`` block i's outputs are
        # copied to pinned host memory behind an event and read on the
        # NEXT feed call (results shift one block later; flush() always
        # drains), as the JAX package's async dispatch does.
        self._pipelined = pipelined
        self._slots = HostSlots(self.device)
        self._inflight = None

    def _drain_outs(self, handle) -> list[tuple[int, np.ndarray]]:
        syms, lens, pos, cnt, dropped, snr = (
            x[0] for x in HostSlots.wait(handle))
        self.dropped += int(dropped)
        self.snr_ratios += [float(snr[r]) for r in range(int(cnt))]
        return [(int(pos[r]), syms[r, :lens[r]].astype(np.uint16))
                for r in range(int(cnt))]

    def feed(self, iq) -> list[tuple[int, np.ndarray]]:
        """Consume IQ (complex or [T, 2] float32); returns completed packets
        as (global_position, symbols) tuples."""
        self.snr_ratios = []
        buf = np.concatenate([self._pending, host_ri(iq)])
        out: list[tuple[int, np.ndarray]] = []
        nfull = buf.shape[0] // self.block_len
        for b in range(nfull):
            block = torch.from_numpy(
                buf[b * self.block_len:(b + 1) * self.block_len][None])
            self._carry, outs = self._step(self._carry,
                                           block.to(self.device))
            handle = self._slots.fetch(outs)
            if self._pipelined:
                if self._inflight is not None:
                    out += self._drain_outs(self._inflight)
                self._inflight = handle
            else:
                out += self._drain_outs(handle)
        self._pending = buf[nfull * self.block_len:]
        return out

    def flush(self) -> list[tuple[int, np.ndarray]]:
        """Pad the residue with silence and drain in-flight packets."""
        drain = self.block_len + 2 * stream_tail_len(self.cfg)
        pad = (-(self._pending.shape[0] + drain)) % self.block_len
        silence = np.zeros((drain + pad, 2), np.float32)
        out = self.feed(silence)          # resets snr_ratios for this call
        if self._inflight is not None:
            out += self._drain_outs(self._inflight)
            self._inflight = None
        return out

    # -- checkpoint/resume: the JAX package's keys, shapes and dtypes
    #    (``carry_0`` .. ``carry_19``: the _State fields in order, lane axis
    #    dropped, symbols as uint16; ``carry_20``: the tail; ``pending``),
    #    so a checkpoint loads across both packages.
    def state_dict(self) -> dict:
        s, tail = self._carry
        d = {}
        for i, (name, x) in enumerate(zip(_State._fields, s)):
            a = x[0].cpu().numpy()
            d[f"carry_{i}"] = a.astype(np.uint16) if name == "out_syms" \
                else a
        d[f"carry_{len(s)}"] = tail[0].cpu().numpy()
        d["pending"] = self._pending.copy()
        return d

    def load_state_dict(self, d: dict) -> None:
        s, tail = self._carry
        new = []
        for i, x in enumerate(s):
            a = np.asarray(d[f"carry_{i}"])
            if a.dtype == np.uint16:
                a = a.astype(np.int32)
            new.append(torch.from_numpy(np.array(a, copy=True))[None]
                       .to(device=self.device, dtype=x.dtype))
        t = np.asarray(d[f"carry_{len(s)}"], np.float32)
        self._carry = (_State(*new),
                       torch.from_numpy(t.copy())[None].to(self.device))
        self._pending = np.asarray(d["pending"], np.float32).copy()


def make_demodulator(cfg: LoraConfig, num_samples_total: int,
                     max_packets: int = 8,
                     device: str | torch.device = DEFAULT_DEVICE) -> Demod:
    """The demodulator for a fixed input length (the JAX package's jitted
    wrapper; here ``demod_fn`` itself, as PyTorch runs eagerly)."""
    return demod_fn(cfg, num_samples_total, max_packets, device)


def demodulate(iq, cfg: LoraConfig, max_packets: int = 8,
               device: str | torch.device = DEFAULT_DEVICE):
    """Convenience host API: complex64 (or [T,2] float32) IQ, or a
    float32 [T, 2] tensor (used where it lies when that is ``device``) ->
    list of uint16 symbol arrays, one per detected packet."""
    x = iq.reshape(-1, 2) if isinstance(iq, torch.Tensor) \
        else torch.from_numpy(host_ri(iq))
    fn = make_demodulator(cfg, x.shape[0], max_packets, device)
    out_syms, out_len, _, out_cnt, _, _ = (o.cpu().numpy() for o in fn(x))
    return [out_syms[i, :out_len[i]].astype(np.uint16)
            for i in range(int(out_cnt))]


def snr_db_estimate(ratio, cfg: LoraConfig):
    """Convert the FSM's peak/mean detection ratio to an in-band SNR
    estimate in dB.

    For a tone of amplitude A in complex noise of per-component std s at
    fs = p*bw: peak = N*A, and the mean folded-bin magnitude is
    2*s*sqrt(N)*sqrt(pi/2) (Rayleigh mean of two folded bands), so
    in-band SNR = A^2 p / (2 s^2) = (pi p / N) * ratio^2.
    """
    n = cfg.num_samples
    r = np.maximum(np.asarray(ratio, np.float64), 1e-12)
    return 10.0 * np.log10(np.pi * cfg.p / n * r * r)
