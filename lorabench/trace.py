"""Reading a ``torch.profiler`` trace of the traced window.

The raw kineto events are read once (no FunctionEvent tree): the device's
kernels, copies and sets with their times and CUPTI correlation ids, the
host's operators and ``record_function`` ranges, and the CUDA runtime
calls that launched each device event.  From them:

- ``busy_s``: the length of the union of the device intervals inside the
  window (``lorabench.stats.merge_intervals``), and ``window_s``, the
  window's own host range;
- ``device_time()``: device seconds of all its events, and
  ``graph_time()``: of those that ``cudaGraphLaunch`` replays launched
  (the FSM step's captured graphs);
- ``pageable_htod()``: host-to-device copies from pageable memory;
- ``breakdown()``: the ten device operations that took most time and the
  ten longest idle stretches by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from .stats import merge_intervals

WINDOW = "lorabench.window"


class Trace:
    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        from torch.autograd import DeviceType

        self.device = []                    # (start, end, name, corr)
        self.host = []                      # (start, end, name)
        self.ranges = defaultdict(list)     # name -> [(start, end)]
        launch = {}                         # CUPTI correlation -> (t, name)
        host_by_id = {}                     # op correlation id -> start
        linked = {}                         # device index -> op id
        for e in events:
            start, name = e.start_ns(), e.name()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith("lorabench."):
                    continue        # a range's mirror on the device's rows
                linked[len(self.device)] = e.linked_correlation_id()
                self.device.append((start, end, name, e.correlation_id()))
                continue
            if _is_runtime(e, name):
                launch[e.correlation_id()] = (start, name)
            else:
                host_by_id[e.correlation_id()] = start
            if name.startswith("lorabench."):
                self.ranges[name].append((start, end))
            if name != WINDOW:
                self.host.append((start, end, name))
        # Launch time and launcher of each device event: its runtime call,
        # else the host operator it is linked to.
        self.launched = []
        for i, (_, _, _, corr) in enumerate(self.device):
            t, by = launch.get(corr, (host_by_id.get(linked[i]), None))
            self.launched.append((t, by))
        win = self.ranges.get(WINDOW) or [(min(s for s, *_ in self.device),
                                           max(e for _, e, *_ in self.device))]
        self.t0, self.t1 = win[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self._busy = merge_intervals(
            [(max(s, self.t0), min(e, self.t1)) for s, e, *_ in self.device
             if e > self.t0 and s < self.t1])
        self.busy_s = sum(e - s for s, e in self._busy) / 1e9
        self.host.sort()

    def device_time(self) -> float:
        """Device seconds of every event of the trace."""
        return sum(e - s for s, e, _, _ in self.device) / 1e9

    def graph_time(self) -> float:
        """Device seconds of the events launched by CUDA graph replays."""
        return sum((e - s) / 1e9 for (s, e, _, _), (_, by)
                   in zip(self.device, self.launched)
                   if by is not None and "GraphLaunch" in by)

    def pageable_htod(self) -> list:
        """[(name, seconds)] of host-to-device copies from pageable
        memory."""
        return [(name, (e - s) / 1e9) for s, e, name, _ in self.device
                if "HtoD" in name and "Pageable" in name]

    def breakdown(self, top: int = 10) -> dict:
        by = defaultdict(float)
        for s, e, name, _ in self.device:
            by[_short(name)] += (e - s) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        starts = [s for s, _, _ in self.host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            label = "no_host_op"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 400, -1), -1):
                if self.host[j][1] >= mid:
                    label = _short(self.host[j][2])
                    break
            gaps[label] += (b - a) / 1e9
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def _is_runtime(event, name: str) -> bool:
    """A CUDA API call (it carries the CUPTI correlation id of what it
    launched).  Older releases' events have no activity type: then the
    call's name tells."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return str(kind()).startswith("cuda_")
    return name.startswith(("cuda", "cu")) and "::" not in name


def _short(name: str) -> str:
    """A kernel name cut to 64 characters of a metric-name alphabet."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:64]
