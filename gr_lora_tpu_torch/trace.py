"""Spans and counters of the port's receivers and gateways: one recorder.

Each ``TriggeredReceiver``, ``TriggeredPyramidGateway`` and
``PyramidGateway`` owns a ``Recorder`` (its ``recorder`` attribute).  It
is off until an operator turns it on (``rx.recorder.on = True``).

Off, a span is one flag check that returns a shared no-op context: no
CUDA event is recorded, no ``record_function`` range opened and nothing
kept.  A span given a ``key`` adds its host seconds to ``totals[key]``
on or off (the gateways' ``wall``), through a timer built once per key.

On, each call of the receiver or gateway (a ``__call__``, a ``feed``, a
``flush``) gets an id, and every span opened inside it keeps its name,
its start and end on the host clock (``time.perf_counter_ns``), the span
that opened it, the call's id and an ``sf``.  A device span also records
a pair of timing CUDA events on the current stream (from a pool), read
once when the call ends: after the call's own last fetch, so the
recorder adds no synchronisation.  On the CPU a device span is its host
interval.  While a profiler runs, every span opens a
``torch.profiler.record_function`` range of its name, so that under
``torch.profiler`` the spans are ``lora.`` ranges of the trace, on the
kernels' clock (with no profiler a range would record nothing, and cost
a dispatcher call each way).  ``count`` adds counters to the open call.

The calls are kept in a ring of the last ``capacity``; ``records()``
returns them as plain dicts and clears them.  There each call's device
spans lie on one device timeline, measured from an event recorded when
the call starts (the card is idle then, as it is between the receiver's
calls, so that timeline is the host's from the call's start).  The card
is idle wherever no device span covers it; each idle stretch is put down
to the host spans that ran meanwhile, innermost first, and
``summary(records)`` totals the calls.
"""

from __future__ import annotations

import functools
import itertools
import time
from collections import deque
from contextvars import ContextVar

import torch

#: Calls a recorder keeps.
CAPACITY = 64

_CALL_IDS = itertools.count(1)


class _Null:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _Null()


class _Tally:
    """A keyed span of a recorder that is off: its host seconds go to
    ``totals[key]``, as the gateways' hand-timed walls did."""

    __slots__ = ("totals", "key", "t0")

    def __init__(self, totals: dict, key: str):
        self.totals, self.key, self.t0 = totals, key, 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.totals[self.key] += time.perf_counter() - self.t0


class _Open:
    """A span of a recorder that is on."""

    __slots__ = ("rec", "name", "device", "sf", "key", "root", "row",
                 "range", "token")

    def __init__(self, rec, name, device, sf, key, root):
        self.rec, self.name, self.device = rec, name, device
        self.sf, self.key, self.root = sf, key, root

    def __enter__(self):
        self.rec._enter(self)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self)


class Recorder:
    """Spans and counters of one receiver or gateway on ``device``.

    ``on`` is the switch.  ``totals`` holds the host seconds of the keyed
    spans, one entry a key, kept on or off.  See the module docstring."""

    def __init__(self, device: torch.device | None = None, totals=(),
                 capacity: int = CAPACITY):
        self.on = False
        self.device = device
        self.totals = dict.fromkeys(totals, 0.0)
        self._tallies = {k: _Tally(self.totals, k) for k in totals}
        self._calls: deque = deque(maxlen=capacity)
        self._pool: list = []             # free timing events
        self._rows: list | None = None    # the open call's spans
        self._stack: list = []
        self._counts: list = []
        self._anchor = None
        self._call = 0

    # -- recording ------------------------------------------------------
    def call(self, name: str):
        """The root span of one call (a span, inside an open call)."""
        if not self.on:
            return _NULL
        return _Open(self, name, False, None, None, self._rows is None)

    def span(self, name: str, device: bool = False, sf: int | None = None,
             key: str | None = None):
        """A span of the open call; ``device``: its device time too;
        ``key``: its host seconds also go to ``totals[key]``."""
        if not self.on:
            return _NULL if key is None else self._tallies[key]
        return _Open(self, name, device, sf, key, self._rows is None)

    def count(self, name: str, value: int, sf: int | None = None) -> None:
        """A counter of the open call."""
        if self.on and self._rows is not None:
            self._counts.append((name, int(value), sf))

    def _event(self):
        ev = self._pool.pop() if self._pool else \
            torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _enter(self, s: _Open) -> None:
        if s.root:
            self._rows, self._stack, self._counts = [], [], []
            self._call = next(_CALL_IDS)
            s.token = _CURRENT.set(self)
            self._anchor = self._event() if self.device is not None \
                and self.device.type == "cuda" else None
        s.range = None
        if torch._C._autograd._profiler_enabled():
            s.range = torch.profiler.record_function(s.name)
            s.range.__enter__()
        parent = self._stack[-1] if self._stack else -1
        # name, parent, host start / end (ns), device, device start / end
        # (events, then ms), sf
        s.row = [s.name, parent, time.perf_counter_ns(), 0, s.device,
                 None, None, s.sf]
        if s.device and self._anchor is not None:
            s.row[5] = self._event()
        self._stack.append(len(self._rows))
        self._rows.append(s.row)

    def _exit(self, s: _Open) -> None:
        row = s.row
        if s.device and self._anchor is not None:
            row[6] = self._event()
        row[3] = time.perf_counter_ns()
        self._stack.pop()
        if s.range is not None:
            s.range.__exit__(None, None, None)
        if s.key is not None:
            self.totals[s.key] += (row[3] - row[2]) / 1e9
        if s.root:
            _CURRENT.reset(s.token)
            self._finish(s.name)

    def _finish(self, name: str) -> None:
        """Device spans to [start, end] ms on the call's timeline (on the
        CPU their host interval), their events back to the pool, the call
        into the ring."""
        rows, anchor = self._rows, self._anchor
        t0 = rows[0][2]
        devs = [r for r in rows if r[4]]
        if anchor is not None and devs and not devs[-1][6].query():
            # A caller that reads nothing back after its last device
            # span: wait for it (the receiver's last fetch always has).
            devs[-1][6].synchronize()
        for r in devs:
            if anchor is None:
                r[5], r[6] = (r[2] - t0) / 1e6, (r[3] - t0) / 1e6
            else:
                self._pool += (r[5], r[6])
                r[5], r[6] = anchor.elapsed_time(r[5]), \
                    anchor.elapsed_time(r[6])
        if anchor is not None:
            self._pool.append(anchor)
        self._calls.append((self._call, name, rows, self._counts))
        self._rows, self._anchor = None, None

    # -- reading ----------------------------------------------------------
    def records(self) -> list[dict]:
        """The calls kept, oldest first, as plain dicts, and clears them.

        A call: ``call`` (its id), ``name``, ``wall_ms``, ``busy_ms`` (the
        device spans' union), ``spans``, ``counters`` (``name``,
        ``value``, ``sf``) and ``idle_ms`` ({host span: device idle ms put
        down to it}).  A span: ``name``, ``call``, ``parent`` (its index
        in ``spans``, -1 for the root), ``start_ns`` / ``end_ns`` (host
        clock), ``self_ms`` (its duration less its children's),
        ``device_ms`` ([start, end] on the call's device timeline, or None
        for a host span) and ``sf``."""
        out = [_call_record(*c) for c in self._calls]
        self._calls.clear()
        return out


_OFF = Recorder()
#: The recorder of the call that is running (a receiver's, while it is
#: on): code below the receiver, such as the shared ``StepLoop``s, finds
#: it here.
_CURRENT: ContextVar[Recorder] = ContextVar("lora_recorder", default=_OFF)


def current() -> Recorder:
    """The recorder of the running call, or one that is always off."""
    return _CURRENT.get()


def traced_call(name: str):
    """Method decorator: each call of the method is a call of
    ``self.recorder``, with a root span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            with self.recorder.call(name):
                return fn(self, *args, **kwargs)
        return inner
    return wrap


def summary(records: list[dict]) -> dict:
    """Totals over the calls of ``records()``: ``calls``, ``wall_ms``,
    ``busy_ms``, ``idle_pct`` (100 × (1 − busy ÷ wall)); ``spans``: {name:
    {``n``, ``host_ms``, ``self_ms``, ``device_ms``}}; ``gaps_ms``:
    {``"a>b"``: device ms between a device span ``a`` and the next, ``b``};
    ``idle_ms``: {host span: device idle ms put down to it}; ``counters``:
    {name, or ``name.sf<N>``: total}."""
    out = {"calls": len(records), "wall_ms": 0.0, "busy_ms": 0.0,
           "spans": {}, "gaps_ms": {}, "idle_ms": {}, "counters": {}}
    for rec in records:
        out["wall_ms"] += rec["wall_ms"]
        out["busy_ms"] += rec["busy_ms"]
        for s in rec["spans"]:
            t = out["spans"].setdefault(s["name"], {
                "n": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0})
            t["n"] += 1
            t["host_ms"] += (s["end_ns"] - s["start_ns"]) / 1e6
            t["self_ms"] += s["self_ms"]
            if s["device_ms"] is not None:
                t["device_ms"] += s["device_ms"][1] - s["device_ms"][0]
        devs = sorted((s["device_ms"], s["name"]) for s in rec["spans"]
                      if s["device_ms"] is not None)
        for (prev, a), (nxt, b) in zip(devs, devs[1:]):
            key = f"{a}>{b}"
            out["gaps_ms"][key] = out["gaps_ms"].get(key, 0.0) \
                + max(nxt[0] - prev[1], 0.0)
        for k, v in rec["idle_ms"].items():
            out["idle_ms"][k] = out["idle_ms"].get(k, 0.0) + v
        for c in rec["counters"]:
            key = c["name"] if c["sf"] is None else f"{c['name']}.sf{c['sf']}"
            out["counters"][key] = out["counters"].get(key, 0) + c["value"]
    out["idle_pct"] = 100.0 * (1.0 - out["busy_ms"] / out["wall_ms"]) \
        if out["wall_ms"] > 0 else 0.0
    return out


def _union(intervals) -> list:
    """The union of [a, b] intervals, sorted, as [[a, b], ...]."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _call_record(call: int, name: str, rows: list, counts: list) -> dict:
    """One call of the ring as ``Recorder.records`` gives it."""
    t0 = rows[0][2]
    wall = (rows[0][3] - t0) / 1e6
    kids: list = [[] for _ in rows]
    for i, r in enumerate(rows[1:], 1):
        kids[r[1]].append(i)
    # Each span's own stretches of host time (ms from the call's start):
    # its interval less its children's.  Together they tile the call.
    own: list = []                             # (start, end, name)
    spans = []
    for i, r in enumerate(rows):
        a, b = (r[2] - t0) / 1e6, (r[3] - t0) / 1e6
        self_ms = b - a
        for k in kids[i]:
            c, d = (rows[k][2] - t0) / 1e6, (rows[k][3] - t0) / 1e6
            if c > a:
                own.append((a, c, r[0]))
            a = max(a, d)
            self_ms -= d - c
        if b > a:
            own.append((a, b, r[0]))
        spans.append({"name": r[0], "call": call, "parent": r[1],
                      "start_ns": r[2], "end_ns": r[3], "self_ms": self_ms,
                      "device_ms": [r[5], r[6]] if r[4] else None,
                      "sf": r[7]})
    own.sort()
    busy = _union([(max(r[5], 0.0), min(r[6], wall)) for r in rows
                   if r[4] and r[6] > 0.0 and r[5] < wall])
    edges = [0.0] + [x for iv in busy for x in iv] + [wall]
    idle: dict = {}
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        while j < len(own) and own[j][1] <= a:
            j += 1
        k = j
        while k < len(own) and own[k][0] < b:
            lo, hi = max(a, own[k][0]), min(b, own[k][1])
            if hi > lo:
                idle[own[k][2]] = idle.get(own[k][2], 0.0) + hi - lo
            k += 1
    return {"call": call, "name": name, "wall_ms": wall,
            "busy_ms": sum(b - a for a, b in busy), "spans": spans,
            "counters": [{"name": n, "value": v, "sf": sf}
                         for n, v, sf in counts],
            "idle_ms": idle}
