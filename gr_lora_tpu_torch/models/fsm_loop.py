"""The device loop both receive state machines run on.

The JAX package runs its demodulator FSM (models/demodulator.py) and its
weak FSM (models/weak.py) as a ``lax.while_loop`` vmapped over lanes:
every lane's step is computed, and a lane whose own loop condition is
false keeps its state.  PyTorch has no device loop, so the port runs the
same form from the host: ``StepLoop`` holds the lanes' state as tensors
with a leading lane axis and applies the machine's batched, fixed-shape
step ``STEPS`` times between two looks at the host.  A step reads no value
back to the host; the host asks once every ``STEPS`` steps whether any
lane is still active.  Extra steps are harmless: the step leaves every
inactive lane as it was.

On the card the ``STEPS`` steps are captured once in a ``torch.cuda.
CUDAGraph`` (per loop: machine, lanes, buffer length) and replayed; a
capture that fails raises.  On the CPU the same steps run eagerly.  Both
run the same ``_steps``: the state and the sample buffer are static
tensors that a pass loads, the steps update in place, and the pass reads
back.  ``graphed`` chooses the route when the loop is built, from its
device; a loop built with ``graphed=False`` on the card (the eager timing
in chip_smoke.py, the card tests) runs the very same steps launch by
launch.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple

import torch

#: Steps between two host checks of "any lane active", and the length of
#: one captured graph.
STEPS = 32
#: Whole-buffer and streaming loops (input length, block length, device)
#: each FSM keeps built: each holds its sample buffers and graphs, so the
#: cache is bounded.
BUILT_CACHE = 16


@lru_cache(maxsize=None)
def offsets(width: int, device: torch.device) -> torch.Tensor:
    """int64 [width] 0..width-1 on ``device``: a window's sample offsets."""
    return torch.arange(width, device=device)


def windows(iq: torch.Tensor, starts: torch.Tensor, width: int):
    """[L, W, width, 2] windows of iq [L, T, 2] at starts [L, W], in one
    gather.  Each start is clamped into [0, T - width] first, as
    ``jax.lax.dynamic_slice`` clamps its start index, so no read leaves
    the buffer."""
    lanes, t = iq.shape[0], iq.shape[1]
    s = starts.clamp(0, t - width).to(torch.int64)
    idx = (s[..., None] + offsets(width, iq.device)).reshape(lanes, -1, 1)
    out = torch.gather(iq, 1, idx.expand(-1, -1, 2))
    return out.reshape(lanes, starts.shape[1], width, 2)


def lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [L] mask shaped to broadcast against ``like`` [L, ...]."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


class StepLoop:
    """Run ``body`` over the lanes of one static sample buffer until no
    lane is active.

    ``body(iq, s, active) -> s`` is one step of every lane, leaving the
    lanes where ``active`` is false unchanged.  A lane is active while
    ``ptr + reach <= buf_len`` and ``it < max_iters`` (the JAX package's
    loop conditions).  ``iq`` [lanes, buf_len, 2] is the buffer a pass
    fills before ``run``; ``state`` holds the static state tensors.
    """

    def __init__(self, body: Callable, init: NamedTuple, buf_len: int,
                 reach: int, max_iters: int, graphed: bool | None = None):
        device = init.ptr.device
        self.body = body
        self.buf_len = buf_len
        self.reach = reach
        self.max_iters = max_iters
        self.graphed = device.type == "cuda" if graphed is None else graphed
        self.iq = torch.zeros(init.ptr.shape[0], buf_len, 2, device=device)
        self.state = type(init)(*(x.clone() for x in init))
        self.graph = None
        #: Steps the last ``run`` took (a multiple of STEPS).
        self.steps = 0

    def active(self, s) -> torch.Tensor:
        return (s.ptr + self.reach <= self.buf_len) & (s.it < self.max_iters)

    def _steps(self) -> None:
        s = self.state
        for _ in range(STEPS):
            s = self.body(self.iq, s, self.active(s))
        for dst, src in zip(self.state, s):
            dst.copy_(src)

    def _load(self, state) -> None:
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def _capture(self) -> None:
        """Warm up on a side stream (cuFFT's plans and the allocator's
        blocks exist before capture), restore the state, capture."""
        start = type(self.state)(*(x.clone() for x in self.state))
        side = torch.cuda.Stream(self.iq.device)
        side.wait_stream(torch.cuda.current_stream(self.iq.device))
        with torch.cuda.stream(side):
            self._steps()
        torch.cuda.current_stream(self.iq.device).wait_stream(side)
        self._load(start)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._steps()
        self.graph = graph

    def run(self, state):
        """Load ``state``, step until no lane is active, return the final
        state (tensors of their own, so the next pass may reuse the
        static ones)."""
        self._load(state)
        if self.graphed and self.graph is None:
            self._capture()
        self.steps = 0
        while True:
            if self.graphed:
                self.graph.replay()
            else:
                self._steps()
            self.steps += STEPS
            if not bool(self.active(self.state).any()):
                break
        return type(self.state)(*(x.clone() for x in self.state))
