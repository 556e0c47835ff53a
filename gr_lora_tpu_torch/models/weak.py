"""Weak-signal demodulator: non-coherent two-copy combining (+3 dB).

Port of gr_lora_tpu/models/weak.py, the reference weak_demod block
(lib/weak_demod_impl.cc).  Its 6-state FSM runs on the same device loop as
the plain demodulator (``models/fsm_loop.StepLoop``): one batched step
over a leading lane axis, captured in a CUDA graph on the card, eager on
the CPU.  The waveform carries every symbol **twice**; each peak search
sums the folded dechirped-FFT magnitudes of two consecutive symbol periods
before the argmax (weak_demod_impl.cc:172-194).  A step gathers its four
pair windows of 2n samples (up at ``ptr``, down at ``ptr`` and at
``ptr + n``, up at ``cfo_start``) and transforms them with one ZoomDft call
per dechirp direction.

Payload layout consumed by the reference FSM (weak_demod_impl.cc:398-438):
two double-symbols, a 4-symbol-period skip ("checksum of header symbols"),
then repeating [double-symbol, double-symbol, 1-period skip].  Packet length
is the explicit ``sym_num`` parameter — there is no header feedback.

``modulate_weak`` and ``weak_packet_duration`` are the port's NumPy copies
(tests/test_torch_weak.py pins them equal to the originals).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import (WEAK_DEMOD_SYNC_RECOVERY_COUNT,
                      WEAK_REQUIRED_PREAMBLE_CHIRPS, LoraConfig)
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..ops.chirp import chirp_tables
from ..ops.cplx import cmag
from ..ops.dechirp import device_plan
from .demodulator import (Demod, HostSlots, Stream, _fpmod, compensate,
                          host_ri)
from .fsm_loop import BUILT_CACHE, lane_mask, offsets, windows
from .modulator import NUM_PREAMBLE_CHIRPS

_RESET, _PREFILL, _DETECT, _SFD, _PAYLOAD, _OUT = range(6)


# ---------------------------------------------------------------------------
# Weak-mode TX (fixture generator).
# ---------------------------------------------------------------------------

def modulate_weak(symbols: np.ndarray, cfg: LoraConfig, p: int | None = None,
                  pad_front: int | None = None,
                  pad_back: int | None = None) -> np.ndarray:
    """Symbols -> weak-mode IQ: preamble | sync | SFD | s0 s0 s1 s1 |
    4 filler periods | [s2 s2 s3 s3 filler] ... — the layout the weak FSM's
    consume pattern expects (weak_demod_impl.cc:398-438)."""
    p = cfg.p if p is None else p
    up, down = chirp_tables(cfg.sf, p)
    n = p << cfg.sf
    if pad_front is None:
        pad_front = 4 * n
    if pad_back is None:
        pad_back = 4 * n + 128 * p

    i = np.arange(n)
    chunks = [np.zeros(pad_front, dtype=np.complex64)]
    chunks.append(np.tile(up, NUM_PREAMBLE_CHIRPS))
    for nib in ((cfg.sync_word & 0xF0) >> 4, cfg.sync_word & 0x0F):
        chunks.append(up[(8 * nib * p + i) % n])
    j = np.arange(2 * n + n // 4)
    chunks.append(down[j % n])

    filler = np.zeros(n, dtype=np.complex64)
    syms = list(np.asarray(symbols, dtype=np.int64))

    def dbl(s):
        c = up[(int(s) * p + i) % n]
        return np.concatenate([c, c])

    for k, s in enumerate(syms):
        chunks.append(dbl(s))
        if k == 1:
            chunks.extend([filler] * 4)          # header-checksum skip (4 periods)
        elif k >= 2 and (k % 2) == 1:
            chunks.append(filler)                # 1-period skip after each pair
    chunks.append(np.zeros(pad_back, dtype=np.complex64))
    return np.concatenate(chunks).astype(np.complex64)


def weak_packet_duration(sym_num: int, cfg: LoraConfig,
                         p: int | None = None) -> int:
    p = cfg.p if p is None else p
    n = p << cfg.sf
    periods = 0
    for k in range(sym_num):
        periods += 2
        if k == 1:
            periods += 4
        elif k >= 2 and (k % 2) == 1:
            periods += 1
    return (NUM_PREAMBLE_CHIRPS + 2) * n + (2 * n + n // 4) + periods * n


# ---------------------------------------------------------------------------
# The FSM.
# ---------------------------------------------------------------------------

def _pair_peak(win2, cfg: LoraConfig, *, down: bool):
    """Pair windows [..., 2n, 2] -> (argmax int32, val) of the summed
    folded spectra of their two symbol periods (weak_demod_impl.cc:172-194).
    Ties go to the first bin, as ``jnp.argmax``."""
    n = cfg.num_samples
    w = win2.reshape(win2.shape[:-2] + (2, n, 2))
    lo, hi = device_plan("down" if down else "up", cfg.sf, cfg.p,
                         cfg.fft_factor, win2.device)(w)
    folded = (cmag(lo) + cmag(hi)).sum(dim=-2)
    idx = torch.argmax(folded, dim=-1)
    return idx.to(torch.int32), torch.gather(folded, -1, idx[..., None])[..., 0]


class _State(NamedTuple):
    """The weak FSM state of every lane, each field with a leading lane
    axis (``_State`` of the JAX weak module, same fields, same order)."""

    ptr: torch.Tensor
    st: torch.Tensor
    hist: torch.Tensor
    hist_len: torch.Tensor
    sync_cnt: torch.Tensor
    cfo: torch.Tensor
    syms: torch.Tensor
    sym_cnt: torch.Tensor       # symbols pushed
    iter_cnt: torch.Tensor      # payload FSM iterations (reference sym_cnt)
    out_syms: torch.Tensor      # int32[L, MP, sym_num] (uint16 at the host)
    out_len: torch.Tensor
    out_cnt: torch.Tensor
    it: torch.Tensor


def _dynamic_compensation(symbols, count, cfg: LoraConfig):
    """Reference weak_demod_impl.cc:196-217: modulus = ldr ? 4 : 1, always
    applied (unlike the plain demod, which zeroes it when !ldr).  With
    cfg.weak_compensation == "ldr-only" the !ldr integrator is disabled.
    ``count`` is an int or an int32 tensor [...]; returns int32."""
    disabled = cfg.weak_compensation == "ldr-only" and not cfg.ldr
    return compensate(symbols, count, float(cfg.num_symbols),
                      4.0 if cfg.ldr else 1.0, not disabled, torch.remainder)


@lru_cache(maxsize=None)
def _weak_machine(cfg: LoraConfig, max_packets: int):
    """The weak FSM transition function, shared by the whole-buffer and
    streaming runs.  Returns (body, init_state, kernel) as
    models/demodulator._machine does; no kernel: the plain body runs on
    the card too."""
    n = cfg.num_samples
    k = cfg.bin_size
    fac = cfg.fft_factor
    p = cfg.p
    nsym = cfg.num_symbols
    ms = cfg.weak_sym_num
    mp = max_packets
    drift_max = cfg.preamble_drift_max
    npre = WEAK_REQUIRED_PREAMBLE_CHIRPS

    def init_state(lanes: int, base: int, ptr: int,
                   device: torch.device) -> _State:
        del base                    # the weak outputs carry no position

        def full(shape, value, dtype):
            return torch.full((lanes,) + shape, value, dtype=dtype,
                              device=device)

        i32, f32 = torch.int32, torch.float32
        return _State(
            ptr=full((), ptr, i32), st=full((), _RESET, i32),
            hist=full((npre,), 0, i32), hist_len=full((), 0, i32),
            sync_cnt=full((), 0, i32), cfo=full((), 0.0, f32),
            syms=full((ms,), 0.0, f32), sym_cnt=full((), 0, i32),
            iter_cnt=full((), 0, i32), out_syms=full((mp, ms), 0, i32),
            out_len=full((mp,), 0, i32), out_cnt=full((), 0, i32),
            it=full((), 0, i32))

    def body(iq, s: _State, active) -> _State:
        dev = iq.device
        code = torch.where(active, s.st, -1)
        # Pair windows at ptr and ptr + n (each clamped on its own, as
        # dynamic_slice does), then the CFO window once its start is known.
        wins = windows(iq, torch.stack([s.ptr, s.ptr + n], dim=1), 2 * n)
        dpk, dval = _pair_peak(wins, cfg, down=True)          # [L, 2]
        d0_idx, d0_val, d1_val = dpk[:, 0], dval[:, 0], dval[:, 1]
        off = torch.where(d0_idx > k // 2, d0_idx - k, d0_idx)
        nc_f = 2.25 * n + p * off.to(torch.float32) / 2.0 / fac
        nc_sfd = torch.floor(nc_f + 0.5).to(torch.int32)
        cfo_start = torch.clamp(s.ptr + nc_sfd - (25 * n) // 4, min=0)
        cfo_win = windows(iq, cfo_start[:, None], 2 * n)
        upk, uval = _pair_peak(torch.cat([wins[:, :1], cfo_win], dim=1),
                               cfg, down=False)
        midx, mval, cidx = upk[:, 0], uval[:, 0], upk[:, 1]

        push_hist = mval > 0
        hist = torch.where(push_hist[:, None],
                           torch.cat([midx[:, None], s.hist[:, :-1]], dim=1),
                           s.hist)
        hist_len = torch.where(push_hist, torch.clamp(s.hist_len + 1,
                                                      max=npre), s.hist_len)
        nc = torch.full_like(s.ptr, n)

        # WS_RESET (weak_demod_impl.cc:278-296).
        do_reset = code == _RESET
        hist_len = torch.where(do_reset, 0, hist_len)
        sync_cnt = torch.where(do_reset, 0, s.sync_cnt)
        sym_cnt = torch.where(do_reset, 0, s.sym_cnt)
        iter_cnt = torch.where(do_reset, 0, s.iter_cnt)
        st = torch.where(do_reset, _PREFILL, s.st)

        # WS_PREFILL (:299-309).
        st = torch.where((code == _PREFILL) & (hist_len >= npre), _DETECT, st)

        # WS_DETECT_PREAMBLE (:312-349).
        do_det = code == _DETECT
        pre_idx = hist[:, 0]
        dis = torch.remainder(pre_idx[:, None] - hist[:, 1:] + k, k)
        pre_found = ((dis <= drift_max) | (dis >= k - drift_max)).all(dim=1) \
            & (mval > 0)
        det_hit = do_det & pre_found
        nc = torch.where(det_hit, n - (p * pre_idx) // fac, nc)
        st = torch.where(det_hit, _SFD, st)

        # WS_SFD_SYNC (:352-399).  Reference: only the i==0 branch can
        # sync (:377-380).
        do_sfd = code == _SFD
        bail = do_sfd & (s.sync_cnt > WEAK_DEMOD_SYNC_RECOVERY_COUNT)
        sync_cnt = torch.where(do_sfd, sync_cnt + 1, sync_cnt)
        detect = do_sfd & (d0_val >= d1_val) & (d0_val > mval)
        nc = torch.where(detect, nc_sfd, nc)
        cfo = torch.where(detect, cidx.to(torch.float32), s.cfo)
        st = torch.where(bail & ~detect, _RESET, st)
        st = torch.where(detect, _PAYLOAD, st)

        # WS_READ_PAYLOAD (:402-447): consume pattern over iter_cnt.
        do_pay = code == _PAYLOAD
        done = do_pay & (s.sym_cnt >= ms)
        act = do_pay & ~done
        bin_idx = _fpmod((midx.to(torch.float32) - cfo) / fac, float(nsym))
        first_two = s.iter_cnt < 2
        cksum_skip = s.iter_cnt == 2
        later_skip = (s.iter_cnt >= 3) & (torch.remainder(s.iter_cnt - 3, 3)
                                          == 2)
        push = act & (first_two | ((s.iter_cnt >= 3) & ~later_skip))
        skip = torch.where(later_skip, n, torch.full_like(nc, 2 * n))
        nc = torch.where(act, torch.where(cksum_skip, 4 * n, skip), nc)
        slot = offsets(ms, dev) == torch.clamp(sym_cnt, max=ms - 1)[:, None]
        syms = torch.where(push[:, None] & slot, bin_idx[:, None], s.syms)
        sym_cnt = torch.where(push, torch.clamp(sym_cnt + 1, max=ms), sym_cnt)
        iter_cnt = torch.where(act, iter_cnt + 1, iter_cnt)
        st = torch.where(done, _OUT, st)

        # WS_OUT (:451-471): out_cnt uncapped, so overflow is visible.
        do_out = code == _OUT
        comp = _dynamic_compensation(syms, sym_cnt, cfg)
        row = offsets(mp, dev) == torch.clamp(s.out_cnt, max=mp - 1)[:, None]
        put = (do_out & (s.out_cnt < mp))[:, None] & row
        out_syms = torch.where(put[..., None], comp[:, None, :], s.out_syms)
        out_len = torch.where(put, sym_cnt[:, None], s.out_len)
        out_cnt = s.out_cnt + do_out.to(torch.int32)
        st = torch.where(do_out, _RESET, st)

        return _State(
            ptr=s.ptr + torch.where(active, nc, 0), st=st,
            hist=torch.where(lane_mask(active, hist), hist, s.hist),
            hist_len=torch.where(active, hist_len, s.hist_len),
            sync_cnt=sync_cnt, cfo=cfo, syms=syms, sym_cnt=sym_cnt,
            iter_cnt=iter_cnt, out_syms=out_syms, out_len=out_len,
            out_cnt=out_cnt, it=s.it + active.to(torch.int32))

    return body, init_state, None


def _outputs(final: _State, mp: int):
    """(syms int32[L, MP, sym_num], lens, count, dropped)."""
    return (final.out_syms, final.out_len,
            torch.clamp(final.out_cnt, max=mp),
            torch.clamp(final.out_cnt - mp, min=0))


def _fresh_outputs(s: _State, mp: int) -> _State:
    return s._replace(out_syms=torch.zeros_like(s.out_syms),
                      out_len=torch.zeros_like(s.out_len),
                      out_cnt=torch.zeros_like(s.out_cnt),
                      it=torch.zeros_like(s.it))


class WeakDemod(Demod):
    """The whole-buffer weak demodulator for one input length on one
    device (what ``weak_demod_fn`` returns): ``fn(iq [..., T, 2]) ->
    (syms int32[..., MP, sym_num], lens, count, dropped)`` as tensors on
    the device, batched over the leading axes; ``dropped`` counts packets
    that overflowed the slots.  Demod with 13 symbols of history
    prefill (WEAK_DEMOD_HISTORY=7 + slack), 4 of tail, lanes running while
    their 2n pair window fits."""

    PAD_FRONT, PAD_BACK, REACH, ITERS_PER_SYMBOL = 13, 4, 2, 4
    machine = staticmethod(_weak_machine)
    outputs = staticmethod(_outputs)


def weak_demod_fn(cfg: LoraConfig, num_samples_total: int,
                  max_packets: int = 4,
                  device: str | torch.device = DEFAULT_DEVICE) -> WeakDemod:
    """The weak demodulator for a fixed input length on ``device`` (the
    card unless the caller asks for the CPU).  See ``WeakDemod``."""
    return _weak_demod(cfg, num_samples_total, max_packets,
                       resolve_device(device))


@lru_cache(maxsize=BUILT_CACHE)
def _weak_demod(cfg, num_samples_total, max_packets, device) -> WeakDemod:
    return WeakDemod(cfg, num_samples_total, max_packets, device)


def weak_stream_fn(cfg: LoraConfig, block_len: int, max_packets: int = 4,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Streaming weak demodulator: fixed blocks, carried FSM state — the
    GR-streaming analog of the reference weak_demod block.  Returns
    (step, init) as models/demodulator.demod_stream_fn does; outs is
    (syms, lens, count, dropped).

    The carried tail must cover the 25n/4 CFO look-back plus the pair
    window; the FSM stops 3n before the buffer end because the SFD branch
    reads one symbol ahead of its 2n pair window (unprocessed samples ride
    into the next block's tail).
    """
    stream = _weak_stream(cfg, block_len, max_packets, resolve_device(device))
    return stream.step, stream.init


@lru_cache(maxsize=BUILT_CACHE)
def _weak_stream(cfg, block_len, max_packets, device) -> Stream:
    n = cfg.num_samples
    tail_len = 16 * n
    if block_len < 4 * n:
        raise ValueError(f"block_len must be >= 4 symbols ({4 * n})")
    max_iters = 4 * ((tail_len + block_len) // n) + 64
    return Stream(_weak_machine(cfg, max_packets), block_len, max_packets,
                  device, tail_len, 3 * n, max_iters, _outputs,
                  _fresh_outputs, (("ptr", -1),))


class StreamingWeakDemodulator:
    """Host-facing stateful wrapper: feed chunks, collect weak packets."""

    def __init__(self, cfg: LoraConfig, block_len: int | None = None,
                 max_packets: int = 4,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_len = block_len or 64 * cfg.num_samples
        self._step, init = weak_stream_fn(cfg, self.block_len, max_packets,
                                          self.device)
        self._carry = init()
        self._pending = np.zeros((0, 2), np.float32)
        self._slots = HostSlots(self.device)
        self.dropped = 0

    def feed(self, iq) -> list[np.ndarray]:
        buf = np.concatenate([self._pending, host_ri(iq)])
        out: list[np.ndarray] = []
        nfull = buf.shape[0] // self.block_len
        for b in range(nfull):
            block = torch.from_numpy(
                buf[b * self.block_len:(b + 1) * self.block_len][None])
            self._carry, outs = self._step(self._carry,
                                           block.to(self.device))
            syms, lens, cnt, dropped = (
                x[0] for x in HostSlots.wait(self._slots.fetch(outs)))
            self.dropped += int(dropped)
            out += [syms[r, :lens[r]].astype(np.uint16)
                    for r in range(int(cnt))]
        self._pending = buf[nfull * self.block_len:]
        return out

    def flush(self) -> list[np.ndarray]:
        drain = self.block_len + 40 * self.cfg.num_samples
        pad = (-(self._pending.shape[0] + drain)) % self.block_len
        return self.feed(np.zeros((drain + pad, 2), np.float32))


def make_weak_demodulator(cfg: LoraConfig, num_samples_total: int,
                          max_packets: int = 4,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> WeakDemod:
    return weak_demod_fn(cfg, num_samples_total, max_packets, device)


def weak_demodulate(iq, cfg: LoraConfig, max_packets: int = 4,
                    device: str | torch.device = DEFAULT_DEVICE):
    """Host API: IQ -> list of uint16 symbol arrays (length cfg.weak_sym_num)."""
    x = host_ri(iq)
    fn = make_weak_demodulator(cfg, x.shape[0], max_packets, device)
    out_syms, out_len, out_cnt, _ = (o.cpu().numpy()
                                     for o in fn(torch.from_numpy(x)))
    return [out_syms[i, :out_len[i]].astype(np.uint16)
            for i in range(int(out_cnt))]
