"""Debug taps and profiling — the reference's DUMP_IQ/DEBUG levels, redone.

Twin of gr_lora_tpu/debug.py.  The reference compiles dumps in with
``#define DUMP_IQ 1`` and writes raw streams to fixed filenames from
inside each block (demod_impl.cc:33,337-355, pyramid_demod_impl.cc:34,
574-591, mod_impl.cc:28,136-138).  Here the per-stage tensors are
ordinary outputs: ``rx_taps`` computes them in one batched pass on
``device`` and ``dump_rx_taps`` writes .npy files; ``profile`` wraps
``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path

import numpy as np
import torch

from .config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from .device import DEFAULT as DEFAULT_DEVICE
from .device import resolve as resolve_device
from .ops.chirp import chirp_tables
from .ops.cplx import cmag, cmul, to_ri
from .ops.dechirp import frame_signal, pyramid_spectra, up_bands


@torch.no_grad()
def rx_taps(iq, cfg: LoraConfig, hop: int | None = None,
            device=DEFAULT_DEVICE) -> dict:
    """Per-stage RX tensors for a capture, on ``device``: raw frames,
    dechirped frames, folded up-chirp spectra, and the pyramid spectra
    triple.

    Equivalent streams in the reference: ``raw.out``, ``up_windowless.out``,
    ``fft.out`` (demod_impl.cc:337-355, pyramid_demod_impl.cc:574-591).
    """
    dev = resolve_device(device)
    if isinstance(iq, torch.Tensor):
        x = iq.to(dev, torch.float32)
    else:
        a = np.asarray(iq)
        if np.iscomplexobj(a):
            a = to_ri(a)
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    n = cfg.num_samples
    hop = hop or n // PYRAMID_OVERLAP_FACTOR
    num = max((x.shape[0] - n) // hop + 1, 0)
    frames = frame_signal(x, n, hop, num)

    _, down = chirp_tables(cfg.sf, cfg.p)
    dc = np.stack([down.real, down.imag], -1).astype(np.float32)
    dechirped = cmul(frames, torch.from_numpy(dc).to(dev))

    lo, hi = up_bands(frames, cfg)
    folded = cmag(lo) + cmag(hi)

    fft_add, fft_add_w, h_single = pyramid_spectra(frames, cfg)
    return {
        "raw": frames,
        "dechirped": dechirped,
        "folded": folded,
        "pyramid_fft_add": fft_add,
        "pyramid_fft_add_w": fft_add_w,
        "pyramid_h_single": h_single,
    }


def dump_rx_taps(iq, cfg: LoraConfig, out_dir: str | Path,
                 hop: int | None = None, device=DEFAULT_DEVICE) -> dict:
    """Write every tap to ``out_dir/<name>.npy``; returns the arrays."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    taps = {k: v.cpu().numpy()
            for k, v in rx_taps(iq, cfg, hop, device).items()}
    for name, arr in taps.items():
        np.save(out_dir / f"{name}.npy", arr)
    return taps


@contextlib.contextmanager
def profile(log_dir: str | Path | None = None):
    """Device trace: ``with debug.profile() as d: run()`` writes
    ``d / "trace.json"`` (Chrome trace format; CUDA activity where a card
    is present).  Without ``log_dir`` a fresh temporary directory."""
    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="gr_lora_profile_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))
