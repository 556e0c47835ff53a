"""P1 and P2: the probe kernels (``csrc/probes.cu``).

- :class:`RateProbe` (P1) replaces bench.py ``_measure_mm_tf``: ``steps``
  steps of four bf16 products ``x[j] @ w`` ([rows, depth] @ [depth,
  width], f32 accumulate) into the slabs of one f32 scratch; the output
  [1, 1] is ``scratch[0, 0] + scratch[rows-1, 4 width - 1]``.  It measures
  the tensor-core rate a hand-written wgmma + TMA kernel attains at the
  dot shape of the main path (bench.py:636-639: (256, 512, 4352) at SF8
  x ff 8).  The kernel takes rows a multiple of 128, depth of 64 and
  width of 256 (:data:`TILE`).
- :class:`OverlapProbe` (P2) replaces tools/overlap_probe.py ``make``:
  ``steps`` steps of one product ``x @ w`` (kind ``"mxu"``), of the f32
  chain :func:`chain_round` ``rounds`` times over a [rows, 1280] slab
  (``"vpu"``), or both (``"both"``); the output [1, 1] is
  ``scratch[0, 0] + slab[0, 0]`` (0 for the scratch where no product ran).
  It asks whether the products P1 runs (``wgmma`` + TMA) retire while an
  independent f32 chain runs on the CUDA cores of the same SMs: the chain
  runs between a stage's commit and its wait, paced over the stages
  (:func:`overlap_grid`, :func:`chain_split`).  The kernel takes P1's
  tile multiples (:data:`TILE`).

Each step repeats the same products, so each plain version computes them
once.  On a CPU tensor the probes run their plain versions; on a CUDA
tensor they launch the kernel (the plain versions there are what the
kernels are checked against).  :func:`probe_inputs` makes the JAX probes'
inputs from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .rdft_spectra import bf16_matmul

#: The main path's dot shape (rows, depth, width) at SF8 x ff 8.
MAIN_SHAPE = (256, 512, 4352)
#: P1's and P2's tile (rows, depth, width): every shape they take is a
#: multiple.
TILE = (128, 64, 256)
#: P2's chain slab width (tools/overlap_probe.py).
SLAB_COLS = 1280
#: P2's chain elements a consumer thread holds, at most, and the consumer
#: threads of a block (two warpgroups): copies of ``kChainPer`` and
#: ``kConsumers`` in ``csrc/probes.cu``, which must change with them.
CHAIN_PER = 10
CHAIN_THREADS = 256
_KINDS = {"mxu": 1, "vpu": 2, "both": 3}


def probe_inputs(rows: int, depth: int, width: int, batch: int = 4,
                 seed: int = 0):
    """(x bf16 [batch, rows, depth], w bf16 [depth, width], v0 f32
    [rows, SLAB_COLS]) from ``default_rng(seed)`` as the JAX probes draw
    them (normal x, then normal w, then uniform(0.5, 1.5) v0); P2 takes
    ``x[0]``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, rows, depth)).astype(np.float32)
    w = rng.normal(0, 1, (depth, width)).astype(np.float32)
    v0 = rng.uniform(0.5, 1.5, (rows, SLAB_COLS)).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(v0))


def overlap_grid(units: int, slab: int, sms: int) -> int:
    """P2's grid for ``units`` (step, tile) units and a ``slab``-element
    chain on ``sms`` SMs: one block an SM for the units, more where the
    slab needs them (block b holds elements b 256 + t + i 256 grid, i <
    :data:`CHAIN_PER`)."""
    per = CHAIN_PER * CHAIN_THREADS
    return max(min(units, sms), -(-slab // per))


def chain_split(block: int, grid: int, units: int, kblocks: int,
                total: int) -> tuple[list[int], int]:
    """The rounds of P2's chain that ``block`` runs beside each of its
    stages (``kblocks`` a unit, units block, block + grid, ...) and after
    its last, ``total`` in all: after s of the smax stages of the
    busiest block, total s // smax have run (``csrc/probes.cu``'s
    pacing)."""
    mine = (units - 1 - block) // grid + 1 if block < units else 0
    smax = -(-units // grid) * kblocks
    per, acc = [], 0
    for _ in range(mine * kblocks):
        acc += total
        per.append(acc // smax)
        acc %= smax
    return per, total - sum(per)


def chain_round(a: torch.Tensor) -> torch.Tensor:
    """One round of tools/overlap_probe.py ``vpu_chain``, one operation at
    a time (each rounded to f32 on its own)."""
    b = a * 1.0001 + 0.1
    m = torch.sqrt(a * a + b * b)
    g = torch.sqrt(torch.clamp_min(a + m, 0.1) * (b - m) * (b - m) + 1.0)
    return 0.25 * (m + g) + 0.5 * torch.maximum(m, g)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.is_cuda and x.dtype == w.dtype == torch.bfloat16
            and x.is_contiguous() and w.is_contiguous()
            and x.shape[-1] == w.shape[0] and x.device == w.device):
        raise ValueError("the probes take contiguous CUDA bf16 x [.., rows, "
                         "depth] and w [depth, width] on one device")


class RateProbe:
    """P1 (module docstring).  ``launches`` counts kernel launches made
    through ``__call__``; ``flops`` is the work of one call."""

    def __init__(self, steps: int = 16):
        self.steps = steps
        self.launches = 0

    def flops(self, x: torch.Tensor, w: torch.Tensor) -> int:
        return self.steps * x.shape[0] * 2 * x.shape[1] * x.shape[2] \
            * w.shape[1]

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x, w)[0]
        out = self.kernel(x, w)[0]
        self.launches += 1
        return out

    def plain(self, x: torch.Tensor, w: torch.Tensor):
        """(out [1, 1], scratch [rows, 4 width]): slab j of the scratch is
        ``x[j] @ w``."""
        y = bf16_matmul(x, w)                      # [4, rows, width]
        scratch = y.permute(1, 0, 2).reshape(y.shape[1], -1)
        return (y[0, 0, 0] + y[3, -1, -1]).reshape(1, 1), scratch

    def kernel(self, x: torch.Tensor, w: torch.Tensor):
        """The kernel's (out [1, 1], scratch [rows, 4 width]) for CUDA x
        [4, rows, depth] (not counted)."""
        _check(x, w)
        if x.ndim != 3 or x.shape[0] != 4:
            raise ValueError(f"x must be [4, rows, depth]: {tuple(x.shape)}")
        rows, depth = x.shape[1], x.shape[2]
        width = w.shape[1]
        if any(n % t for n, t in zip((rows, depth, width), TILE)):
            raise ValueError(f"P1 takes (rows, depth, width) in multiples of "
                             f"{TILE}: {(rows, depth, width)}")
        scratch = torch.empty((rows, 4 * width), dtype=torch.float32,
                              device=x.device)
        out = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
        lib = _build.library()
        with torch.cuda.device(x.device):
            err = lib.grl_rate_probe(x.data_ptr(), w.data_ptr(),
                                     scratch.data_ptr(), out.data_ptr(),
                                     rows, depth, width, self.steps,
                                     _build.stream_of(x))
        _build.check("grl_rate_probe", err)
        return out, scratch


class OverlapProbe:
    """P2 of one ``kind`` (module docstring).  ``launches`` counts kernel
    launches made through ``__call__``."""

    def __init__(self, kind: str, steps: int = 64, rounds: int = 2):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {tuple(_KINDS)}: {kind!r}")
        self.kind = kind
        self.steps = steps
        self.rounds = rounds
        self.launches = 0

    def __call__(self, x: torch.Tensor, w: torch.Tensor,
                 v0: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x, w, v0)[0]
        out = self.kernel(x, w, v0)[0]
        self.launches += 1
        return out

    def plain(self, x, w, v0):
        """(out [1, 1], scratch [rows, width] or None, slab)."""
        acc = bf16_matmul(x, w) if self.kind != "vpu" else None
        vs = v0
        if self.kind != "mxu":
            for _ in range(self.steps * self.rounds):
                vs = chain_round(vs)
        a = acc[0, 0] if acc is not None else torch.zeros((), device=x.device)
        return (a + vs[0, 0]).reshape(1, 1), acc, vs

    def kernel(self, x, w, v0):
        """The kernel's (out, scratch or None, slab) for CUDA x [rows,
        depth] (not counted); the slab is ``v0`` itself unless the chain
        ran."""
        _check(x, w)
        if x.ndim != 2 or not (v0.is_cuda and v0.dtype == torch.float32
                               and v0.is_contiguous()
                               and v0.device == x.device):
            raise ValueError("P2 takes x [rows, depth] and a contiguous "
                             "CUDA float32 slab on x's device")
        rows, depth = x.shape
        width = w.shape[1]
        if any(n % t for n, t in zip((rows, depth, width), TILE)):
            raise ValueError(f"P2 takes (rows, depth, width) in multiples of "
                             f"{TILE}: {(rows, depth, width)}")
        mxu, vpu = self.kind != "vpu", self.kind != "mxu"
        scratch = torch.empty((rows, width), dtype=torch.float32,
                              device=x.device) if mxu else None
        vs = torch.empty_like(v0) if vpu else v0
        out = torch.zeros((1, 1), dtype=torch.float32, device=x.device)
        lib = _build.library()
        with torch.cuda.device(x.device):
            err = lib.grl_overlap_probe(
                x.data_ptr(), w.data_ptr(),
                scratch.data_ptr() if mxu else None, v0.data_ptr(),
                vs.data_ptr(), out.data_ptr(), rows, depth, width,
                v0.numel(), self.steps, self.rounds, _KINDS[self.kind],
                _build.stream_of(x))
        _build.check("grl_overlap_probe", err)
        return out, scratch, vs
