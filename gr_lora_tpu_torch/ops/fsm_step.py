"""The demodulator FSM's step as hand-written kernels around cuFFT.

``FsmStep`` runs one step of every lane of a ``models/fsm_loop.StepLoop``
built for the demod machine (``models/demodulator._machine``), in place
on the loop's static state tensors: ``fsm_win``, an FFT of the down
buffer, ``fsm_sfd``, an FFT of the up buffer, ``fsm_update``
(``csrc/fsm_step.cu`` says what each computes).  The FFTs are
``torch.fft.fft`` on static buffers whose tails past one window are zeroed
here, once, so no pad copy runs a step.  The plain ``body`` stays the
machine's plain version: it runs on CPU tensors and is what the kernels
are held to on the card.

On CUDA tensors the step launches the kernels of the built library or
raises; a step on CPU tensors needs a ``library`` with the same entry
points (the tests' host build of the source).  The step launches on the
card of its tensors, whichever card is current.  ``launches`` counts the
kernels launched from Python, three a step (a graph's warm-up steps
included); a step captured into a CUDA graph launches nothing then, and
its replays launch from the graph: neither counts.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..config import (DEMOD_SYNC_RECOVERY_COUNT, REQUIRED_PREAMBLE_CHIRPS,
                      LoraConfig, PeakSearch)
from . import _build
from .dechirp import _rotations, device_plan

#: Hand-written kernel launches (``fsm_win``, ``fsm_sfd``, ``fsm_update``)
#: made by ``FsmStep`` outside graph captures and replays.
launches = 0

#: The state's fields in ``csrc/fsm_step.cu``'s ``Args`` order (the
#: ``_State`` fields of models/demodulator.py), with their dtypes.
STATE_FIELDS = (
    ("ptr", torch.int32), ("st", torch.int32), ("hist", torch.int32),
    ("hist_len", torch.int32), ("sync_cnt", torch.int32),
    ("cfo", torch.float32), ("snr", torch.float32), ("syms", torch.float32),
    ("sym_cnt", torch.int32), ("pkt_sym_len", torch.int32),
    ("hdr_received", torch.bool), ("hdr_valid", torch.bool),
    ("pkt_start", torch.int32), ("base", torch.int32),
    ("out_syms", torch.int32), ("out_len", torch.int32),
    ("out_pos", torch.int32), ("out_snr", torch.float32),
    ("out_cnt", torch.int32), ("it", torch.int32),
)
_BUFFERS = ("iq", "chirp_dn", "chirp_up", "rot", "down_in", "down_out",
            "up_in", "up_out", "nc_sfd", "dval")
_NUMBERS = ("lanes", "buf_len", "reach", "max_iters", "n", "fft", "bins",
            "ms", "mp", "sf", "p", "fac", "nsym", "lookback", "drift_max",
            "implicit_psl", "npre", "recovery", "peak_search", "phase_k",
            "explicit_header", "ldr")
#: The kernels' C entry points, in launch order.
ENTRIES = ("grl_fsm_win", "grl_fsm_sfd", "grl_fsm_update")


class FsmArgs(ctypes.Structure):
    """``fsm::Args`` of csrc/fsm_step.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name, _ in STATE_FIELDS]
                + [(name, ctypes.c_void_p) for name in _BUFFERS]
                + [(name, ctypes.c_int) for name in _NUMBERS])


class FsmStep:
    """One step of every lane of ``loop`` (a StepLoop of the demod machine
    for ``cfg`` with ``max_packets`` output slots) through the kernels:
    calling it updates ``loop.state`` in place.  Built with the loop; the
    buffers and the state's addresses are fixed from then on, so the step
    can be captured in a CUDA graph."""

    def __init__(self, cfg: LoraConfig, max_packets: int, loop,
                 library: ctypes.CDLL | None = None):
        state, iq = loop.state, loop.iq
        device = iq.device
        if device.type != "cuda" and library is None:
            raise ValueError("the FSM step's kernels run on CUDA tensors "
                             "(or through a host build of the source)")
        for name, dtype in STATE_FIELDS:
            x = getattr(state, name)
            if x.dtype != dtype or not x.is_contiguous() \
                    or x.device != device:
                raise ValueError(f"state field {name}: {x.dtype} on "
                                 f"{x.device}, contiguous "
                                 f"{x.is_contiguous()}")
        lanes, n, f = iq.shape[0], cfg.num_samples, cfg.fft_size
        self.library = library
        self.iq, self.state = iq, state
        self.chirp_dn = device_plan("down", cfg.sf, cfg.p, cfg.fft_factor,
                                    device).mod
        self.chirp_up = device_plan("up", cfg.sf, cfg.p, cfg.fft_factor,
                                    device).mod
        k = cfg.peak_phase_k if cfg.peak_search == PeakSearch.PHASE else 1
        self.rot = _rotations(k, device)
        c64 = torch.complex64
        self.down_in = torch.zeros(lanes, f, dtype=c64, device=device)
        self.up_in = torch.zeros(lanes, 2, f, dtype=c64, device=device)
        self.nc_sfd = torch.zeros(lanes, dtype=torch.int32, device=device)
        self.dval = torch.zeros(lanes, dtype=torch.float32, device=device)
        a = FsmArgs()
        for name, _ in STATE_FIELDS:
            setattr(a, name, getattr(state, name).data_ptr())
        for name in ("iq", "chirp_dn", "chirp_up", "rot", "down_in", "up_in",
                     "nc_sfd", "dval"):
            setattr(a, name, getattr(self, name).data_ptr())
        numbers = dict(
            lanes=lanes, buf_len=iq.shape[1], reach=loop.reach,
            max_iters=loop.max_iters, n=n, fft=f, bins=cfg.bin_size,
            ms=state.syms.shape[1], mp=max_packets, sf=cfg.sf, p=cfg.p,
            fac=cfg.fft_factor, nsym=cfg.num_symbols,
            lookback=(21 * n) // 4, drift_max=cfg.preamble_drift_max,
            implicit_psl=0 if cfg.explicit_header
            else cfg.packet_symbol_len(),
            npre=REQUIRED_PREAMBLE_CHIRPS,
            recovery=DEMOD_SYNC_RECOVERY_COUNT,
            peak_search=int(cfg.peak_search), phase_k=k,
            explicit_header=int(cfg.explicit_header), ldr=int(cfg.ldr))
        for name, value in numbers.items():
            setattr(a, name, value)
        if state.out_syms.shape[1] != max_packets:
            raise ValueError("max_packets differs from the state's slots")
        self.args = a

    def _launch(self, lib, entry: str, stream, counted: bool) -> None:
        global launches
        _build.check(entry, getattr(lib, entry)(ctypes.addressof(self.args),
                                                stream))
        launches += counted

    def __call__(self) -> None:
        lib = self.library or _build.library()
        cuda = self.iq.is_cuda
        guard = torch.cuda.device(self.iq.device) if cuda \
            else contextlib.nullcontext()
        with guard:
            stream = _build.stream_of(self.iq) if cuda else None
            counted = not (cuda and torch.cuda.is_current_stream_capturing())
            win, sfd, update = ENTRIES
            self._launch(lib, win, stream, counted)
            down = torch.fft.fft(self.down_in)
            self.args.down_out = down.data_ptr()
            self._launch(lib, sfd, stream, counted)
            up = torch.fft.fft(self.up_in)
            self.args.up_out = up.data_ptr()
            self._launch(lib, update, stream, counted)
