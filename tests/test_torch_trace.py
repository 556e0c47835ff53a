"""The port's recorder (gr_lora_tpu_torch/trace.py) in the triggered FSM
receiver and the Pyramid gateways, on the CPU.

Off, a call keeps nothing, records no CUDA event, opens no
``record_function`` range and returns the packets it returns on.  On,
each call is one root span whose id every span carries; the spans nest
as the receiver runs them; self time is a span's duration less its
children's; the counters agree with the receiver's own; the ring keeps
the last calls only.  Under ``torch.profiler`` each span is a range of
its name, nested alike.  The gateways' ``wall`` totals their spans' host
seconds under its keys, on or off.  The receiver's fixture: 2 channels x
2^16 samples at SF7-8.
"""

import time

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import trace
from gr_lora_tpu_torch.config import LoraConfig
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist import TriggeredReceiver
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
from gr_lora_tpu_torch.dist.triggered import scan_window
from gr_lora_tpu_torch.models.demodulator import demod_fn
from gr_lora_tpu_torch.models.fsm_loop import STEPS
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri

BASE = LoraConfig(sf=7, cr=1, crc=True, ldr=False, explicit_header=True,
                  payload_len=4, p=2, fft_factor=4, precision="highest")
T = 1 << 16

#: The receiver's spans and the span each is opened in.
PARENTS = {"lora.rx.upload": "lora.rx", "lora.rx.scan": "lora.rx",
           "lora.rx.fetch": "lora.rx", "lora.rx.events": "lora.rx",
           "lora.rx.slices": "lora.rx", "lora.rx.demod": "lora.rx",
           "lora.fsm.replay": "lora.rx.demod",
           "lora.fsm.check": "lora.rx.demod", "lora.rx.decode": "lora.rx",
           "lora.rx.dedupe": "lora.rx"}
DEVICE_SPANS = {"lora.rx.upload", "lora.rx.scan", "lora.rx.slices",
                "lora.fsm.replay"}


def _pkt(sf, payload):
    cfg = BASE.replace(sf=sf)
    return to_ri(modulate(encode(payload, cfg), cfg, pad_front=0,
                          pad_back=0))


def _feed(channels=2, t=T, spots=((0, 3000, 7, b"\x01\x02\x03\x04"),
                                  (1, 1000, 7, b"\x09\x09\x09\x09"),
                                  (1, 20000, 8, b"\x05\x06\x07\x08"))):
    iq = np.random.default_rng(1).normal(0, 0.01, (channels, t, 2)) \
        .astype(np.float32)
    for ch, off, sf, payload in spots:
        p = _pkt(sf, payload)
        iq[ch, off:off + len(p)] += p
    return iq


def _key(pkts):
    return [(p.channel, p.sf, p.position, p.symbols.tobytes(),
             bytes(p.result.payload)) for p in pkts]


def _boom(*args, **kwargs):
    raise AssertionError("called with the recorder off")


@pytest.fixture(scope="module")
def runs():
    """One receiver: a call with the recorder off (record_function and
    CUDA events made to fail), then one with it on."""
    iq = _feed()
    rx = TriggeredReceiver(BASE, sfs=(7, 8), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _boom)
        mp.setattr(torch.autograd.profiler, "record_function", _boom)
        mp.setattr(torch.cuda, "Event", _boom)
        off = rx(iq)
    kept_off = rx.recorder.records()
    events0 = rx.events
    rx.recorder.on = True
    on = rx(iq)
    return dict(rx=rx, off=off, on=on, kept_off=kept_off,
                events=rx.events - events0, records=rx.recorder.records())


def test_recorder_off_keeps_nothing_and_changes_no_packet(runs):
    assert runs["kept_off"] == []
    assert len(runs["off"]) == 3
    assert _key(runs["on"]) == _key(runs["off"])
    assert trace.current().on is False      # no call left running


def test_spans_nest_and_share_the_call_id(runs):
    (rec,) = runs["records"]
    spans = rec["spans"]
    assert [s["parent"] for s in spans].count(-1) == 1
    assert spans[0]["name"] == "lora.rx" and spans[0]["parent"] == -1
    assert {s["call"] for s in spans} == {rec["call"]}
    assert {s["name"] for s in spans} == set(PARENTS) | {"lora.rx"}
    for s in spans[1:]:
        assert spans[s["parent"]]["name"] == PARENTS[s["name"]], s
        assert (s["device_ms"] is not None) == (s["name"] in DEVICE_SPANS)
    for i, s in enumerate(spans):
        kids = [k for k in spans if k["parent"] == i]
        dur = (s["end_ns"] - s["start_ns"]) / 1e6
        inner = sum((k["end_ns"] - k["start_ns"]) / 1e6 for k in kids)
        assert s["self_ms"] == pytest.approx(dur - inner, abs=1e-9)
        assert s["self_ms"] >= 0.0
    # Nine fetches a SF that ran the FSM: three of the scan, six of it.
    assert sum(s["name"] == "lora.rx.fetch" for s in spans) == 2 * 9
    assert rec["wall_ms"] == pytest.approx(
        (spans[0]["end_ns"] - spans[0]["start_ns"]) / 1e6)


def test_counters_agree_with_the_receiver(runs):
    (rec,) = runs["records"]
    rx, spans = runs["rx"], rec["spans"]
    counts = {(c["name"], c["sf"]): c["value"] for c in rec["counters"]}
    assert sum(v for (n, _), v in counts.items() if n == "events") \
        == runs["events"] == 3
    assert counts[("packets", None)] == len(runs["on"])
    for i, s in enumerate(spans):
        if s["name"] != "lora.rx.demod":
            continue
        sf, lanes = s["sf"], counts[("lanes", s["sf"])]
        replays = [k for k in spans if k["parent"] == i
                   and k["name"] == "lora.fsm.replay"]
        assert counts[("replays", sf)] == len(replays) > 0
        cfg = rx.cfgs[sf]
        loop = demod_fn(cfg, min(scan_window(cfg), T), 2,
                        "cpu").loops[lanes]
        assert counts[("replays", sf)] * STEPS == loop.steps
        # No step of a CPU loop runs through the card's kernels.
        assert counts[("fsm_kernel_steps", sf)] == loop.kernel_steps == 0
    assert {sf for (n, sf) in counts if n == "lanes"} == {7, 8}


def test_idle_and_summary(runs):
    (rec,) = runs["records"]
    # On the CPU a device span is its host interval: the idle time is the
    # wall less the device spans, all of it put down to host spans.
    assert 0.0 < rec["busy_ms"] < rec["wall_ms"]
    assert sum(rec["idle_ms"].values()) == pytest.approx(
        rec["wall_ms"] - rec["busy_ms"], rel=1e-6)
    assert "lora.fsm.check" in rec["idle_ms"]
    assert not DEVICE_SPANS & set(rec["idle_ms"])
    tot = trace.summary(runs["records"])
    assert tot["calls"] == 1
    assert tot["spans"]["lora.fsm.replay"]["n"] == sum(
        c["value"] for c in rec["counters"] if c["name"] == "replays")
    assert 0.0 < tot["idle_pct"] < 100.0
    assert tot["gaps_ms"]["lora.fsm.replay>lora.fsm.replay"] >= 0.0


def test_ring_keeps_the_last_calls():
    rec = trace.Recorder(torch.device("cpu"), capacity=3)
    rec.on = True
    for _ in range(5):
        with rec.call("lora.test"):
            with rec.span("lora.test.dev", device=True):
                time.sleep(0.002)
            with rec.span("lora.test.host"):
                time.sleep(0.002)
                rec.count("n", 2)
            with rec.span("lora.test.dev", device=True):
                pass
    got = rec.records()
    assert len(got) == 3 and rec.records() == []
    assert [r["call"] for r in got] == sorted(r["call"] for r in got)
    assert len({r["call"] for r in got}) == 3
    for r in got:
        assert r["counters"] == [{"name": "n", "value": 2, "sf": None}]
        # The only stretch between the two device spans is the host
        # span's: the idle time there is put down to it.
        assert r["idle_ms"]["lora.test.host"] >= 1.5
    rec.on = False
    with rec.call("lora.test"):
        pass
    assert rec.records() == []


def test_keyed_spans_total_on_and_off():
    rec = trace.Recorder(torch.device("cpu"), totals=("a",))
    for on in (False, True):
        rec.on = on
        before = rec.totals["a"]
        with rec.call("lora.test"):
            with rec.span("lora.test.a", key="a"):
                time.sleep(0.002)
        assert rec.totals["a"] - before >= 0.0015
    (r,) = rec.records()
    assert [s["name"] for s in r["spans"]] == ["lora.test", "lora.test.a"]


def _lora_ranges(prof):
    """[(name, enclosing lora. range's name or None)] of the profile's
    ``lora.`` ranges, in start order (raw kineto events)."""
    rows = sorted((e.start_ns(), -e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("lora."))
    out, stack = [], []
    for start, neg, name in rows:
        while stack and stack[-1][0] <= start:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((start - neg, name))
    return out


def test_spans_are_profiler_ranges():
    """A small call (one channel, one SF7 packet) under the CPU profiler:
    its ranges are the record's spans, nested alike."""
    rx = TriggeredReceiver(BASE, sfs=(7,), device="cpu")
    rx.recorder.on = True
    iq = _feed(1, 1 << 14, ((0, 200, 7, b"\x01\x02\x03\x04"),))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pkts = rx(iq)
    assert len(pkts) == 1
    (rec,) = rx.recorder.records()
    spans = rec["spans"]
    want = [(s["name"], spans[s["parent"]]["name"] if s["parent"] >= 0
             else None) for s in spans]
    assert "lora.fsm.replay" in {n for n, _ in want}
    assert _lora_ranges(prof) == want


#: Each gateway's wall keys and the spans whose host seconds they total.
GATEWAY_WALL = {
    "gated": {k: ("lora.gw." + k,) for k in ("ingest", "scan", "lattice",
                                             "tracker", "decode", "sic")},
    "always": {"dispatch": ("lora.gw.ingest", "lora.gw.dispatch"),
               "fetch": ("lora.gw.fetch",), "tracker": ("lora.gw.tracker",),
               "decode": ("lora.gw.decode",)}}


@pytest.mark.parametrize("kind", sorted(GATEWAY_WALL))
def test_gateway_wall_totals_its_spans(kind):
    """Both Pyramid gateways on one SF8 packet: the same packets with the
    recorder on as off; one call a feed and a flush; ``wall`` under its
    keys, each the host total of its spans."""
    iq = _feed(1, T, ((0, 3000, 8, b"\x05\x06\x07\x08"),))
    gws = []
    for on in (False, True):
        if kind == "gated":
            gw = TriggeredPyramidGateway(BASE, 1, sfs=(8,),
                                         max_payload_len=16,
                                         scan_chunk_samples=1 << 15,
                                         device="cpu")
        else:
            gw = PyramidGateway(BASE.replace(sf=8), 1, block_hops=256,
                                device="cpu")
        gw.recorder.on = on
        got = gw.feed(iq) + gw.flush()
        assert [bytes(p.result.payload[3:7]) for p in got] \
            == [b"\x05\x06\x07\x08"]
        gws.append(gw)
    off, on = gws
    assert off.recorder.records() == []
    recs = on.recorder.records()
    assert [r["name"] for r in recs] == ["lora.gw.feed", "lora.gw.flush"]
    host: dict = {}
    for r in recs:
        for s in r["spans"]:
            host[s["name"]] = host.get(s["name"], 0.0) \
                + (s["end_ns"] - s["start_ns"]) / 1e9
    assert set(off.wall) == set(on.wall) == set(GATEWAY_WALL[kind])
    for key, names in GATEWAY_WALL[kind].items():
        assert on.wall[key] == pytest.approx(
            sum(host.get(n, 0.0) for n in names), rel=1e-9, abs=1e-12)
    assert on.wall["decode"] > 0.0 and off.wall["decode"] > 0.0
