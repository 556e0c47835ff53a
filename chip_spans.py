"""The triggered FSM receiver's spans on the card, with no profiler running.

    python3 chip_spans.py --workload fsm64.collide --seed 7 --rounds 12

Sets up one cell of the benchmark (``BENCHMARK.json``, ``lorabench/``)
as its harness does: the seeded pool of feeds in page-locked memory, the
receiver built, then warmed on every feed of the pool (so that no graph
is captured later).  Then hands the receiver ``--rounds`` rounds of
three feeds, one at a time, each round one pool feed three times: with
its recorder (gr_lora_tpu_torch/trace.py) off, on, and on with no CUDA
event (``host``: device spans timed as host intervals), the order
turning each round.  Each feed with the recorder on prints one line to
standard error: the call's wall, the device time of the graph replays
(``replay``), the card's idle time between consecutive replays of one
loop (``sync``, the host's check), the device time of the upload, the
scans and the event slices (``front``), the host's own time in the event
lists, ``decode`` and the dedupe (``host``), the replays, the idle share
of the wall and the events and lanes a SF; then the largest idle
stretches by host span, ``channels_rt`` a mode (channel-samples over the
mode's summed feed seconds, over the sample rate) and the recorder's
cost (the median over rounds of a feed's time on, or host, over off,
less 1).  The last line of standard output is one JSON object: the
card, the rates and costs, the medians of the rows with the recorder on;
``--out`` writes it with every feed's row and spans.  ``--profile`` then
hands the receiver one more feed under ``torch.profiler`` and reads the
trace with the benchmark's reader (``profiled_feed``).  The packets of a
pool feed must be the same in every mode.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from gr_lora_tpu_torch import trace  # noqa: E402
from lorabench import harness  # noqa: E402
from lorabench.stats import channels_realtime  # noqa: E402
from lorabench.traffic import air  # noqa: E402

MODES = ["off", "on", "host"]
HOST = ("lora.rx.events", "lora.rx.decode", "lora.rx.dedupe")
FRONT = ("lora.rx.upload", "lora.rx.scan", "lora.rx.slices")


def feed_row(records: list) -> dict:
    """One feed's numbers from its recorder's records."""
    tot = trace.summary(records)
    spans = tot["spans"]

    def dev(names):
        return sum(spans[n]["device_ms"] for n in names if n in spans)

    counts = tot["counters"]
    return {
        "wall_ms": tot["wall_ms"],
        "replay_ms": dev(("lora.fsm.replay",)),
        "sync_ms": tot["gaps_ms"].get("lora.fsm.replay>lora.fsm.replay",
                                      0.0),
        "front_ms": dev(FRONT),
        "host_ms": sum(spans[n]["self_ms"] for n in HOST if n in spans),
        "replays": spans.get("lora.fsm.replay", {}).get("n", 0),
        "idle_pct": tot["idle_pct"],
        "per_sf": {k: v for k, v in counts.items()
                   if k.startswith(("events.", "lanes.", "replays."))},
        "idle_ms": dict(sorted(tot["idle_ms"].items(),
                               key=lambda kv: -kv[1])),
        "gaps_ms": tot["gaps_ms"],
        "spans": spans,
    }


def _packets(outs) -> list:
    return [(p.channel, p.sf, p.position, bytes(p.result.payload))
            for p in outs]


def run(workload: str, seed: int, rounds: int, device: str = "cuda",
        overrides: dict | None = None, profile: bool = False) -> dict:
    """The run; returns the JSON object.  ``overrides`` (a rehearsal on
    the CPU) update the configuration and the traffic as the harness's
    do."""
    on_card = device != "cpu"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    man = harness.manifest()
    cell = harness.cell_of(man, workload)
    config = json.loads((harness.PKG / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = air.load(cell["traffic"])
    for base, key in ((config, "config"), (traffic, "traffic")):
        base.update((overrides or {}).get(key, {}))
    engine_mod = importlib.import_module(
        f"lorabench.engines.{config['engine']}")
    torch.set_num_threads(2)
    _, pool = harness.make_pool(traffic, config, seed, dev, on_card)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    eng = engine_mod.Engine(config, dev)
    pool_feeds = [pool[i] for i in range(len(pool))]
    for f in pool_feeds:      # every lane count's graph captured here
        eng.warm(f)
    sync()
    rx = eng.rx
    gc.collect()
    gc.freeze()

    rows, seen, card = [], {}, rx.recorder.device
    for r in range(rounds):
        k = r % len(pool_feeds)
        for mode in MODES[r % 3:] + MODES[:r % 3]:
            # "host": on, with no CUDA event (device spans timed as host
            # intervals), which parts the recorder's cost in two.
            rx.recorder.on = mode != "off"
            rx.recorder.device = None if mode == "host" else card
            a = time.perf_counter()
            outs = rx(pool_feeds[k])
            sync()
            feed_s = time.perf_counter() - a
            rx.recorder.on, rx.recorder.device = False, card
            pk = _packets(outs)
            if seen.setdefault(k, pk) != pk:
                raise RuntimeError(f"pool feed {k}: other packets with "
                                   f"the recorder {mode}")
            row = {"round": r, "pool": k, "mode": mode, "feed_s": feed_s}
            kept = rx.recorder.records()
            if mode == "on":
                row.update(feed_row(kept))
                sfs = " ".join(
                    f"sf{sf}:{row['per_sf'].get(f'events.sf{sf}', 0)}/"
                    f"{row['per_sf'].get(f'lanes.sf{sf}', 0)}"
                    for sf in rx.cfgs)
                gaps = " ".join(f"{n}={v:.3f}" for n, v in
                                list(row["idle_ms"].items())[:4])
                print(f"round {r} on feed_s={feed_s:.4f} "
                      f"wall_ms={row['wall_ms']:.3f} "
                      f"replay_ms={row['replay_ms']:.3f} "
                      f"sync_ms={row['sync_ms']:.3f} "
                      f"front_ms={row['front_ms']:.3f} "
                      f"host_ms={row['host_ms']:.3f} "
                      f"replays={row['replays']} "
                      f"idle_pct={row['idle_pct']:.3f} events/lanes {sfs} "
                      f"idle_by_span {gaps}", file=sys.stderr, flush=True)
            else:
                if mode == "host":
                    row["spans"] = trace.summary(kept)["spans"]
                print(f"round {r} {mode} feed_s={feed_s:.4f}",
                      file=sys.stderr, flush=True)
            rows.append(row)
    gc.unfreeze()

    ch, t = config["channels"], traffic["samples_per_feed"]
    rate, by = {}, {}
    for mode in MODES:
        secs = [x["feed_s"] for x in rows if x["mode"] == mode]
        by[mode] = secs
        rate[mode] = {
            "channels_rt": channels_realtime(ch, t, len(secs), sum(secs),
                                             config["sample_rate"]),
            "feed_s_median": statistics.median(secs)}
    for mode in ("on", "host"):
        cost = [x / y - 1.0 for x, y in zip(by[mode], by["off"])]
        rate[mode]["cost_median"] = statistics.median(cost)
        rate[mode]["cost_quartiles"] = statistics.quantiles(cost, n=4) \
            if len(cost) > 1 else cost
    ons = [x for x in rows if x["mode"] == "on"]
    idle: dict = {}
    for x in ons:
        for n, v in x["idle_ms"].items():
            idle[n] = idle.get(n, 0.0) + v / len(ons)
    medians = {k: statistics.median(x[k] for x in ons)
               for k in ("wall_ms", "replay_ms", "sync_ms", "front_ms",
                         "host_ms", "replays", "idle_pct")}
    print("idle a feed by host span (ms): " + " ".join(
        f"{n}={v:.3f}" for n, v in sorted(idle.items(),
                                          key=lambda kv: -kv[1])[:8]),
          file=sys.stderr)
    print(" ".join(f"channels_rt {m}={rate[m]['channels_rt']:.2f}"
                   for m in MODES)
          + " ".join(f" cost {m} {100 * rate[m]['cost_median']:.2f} %"
                     for m in ("on", "host"))
          + " medians " + " ".join(f"{k}={v:.3f}"
                                   for k, v in medians.items()),
          file=sys.stderr)
    out = {"workload": workload, "seed": seed,
           "card": harness._card() if on_card else "cpu", "rate": rate,
           "medians": medians, "idle_ms_a_feed": idle, "rows": rows}
    out["span_us"] = span_costs(dev)
    print("µs a span: " + " ".join(f"{k}={v:.2f}"
                                   for k, v in out["span_us"].items()),
          file=sys.stderr)
    if profile:
        out["profile"] = profiled_feed(rx, pool_feeds[0], on_card)
    return out


def span_costs(dev, n: int = 2000) -> dict:
    """Host µs a span, over ``n`` empty spans in one call on ``dev``: off,
    a host span, a device span (on the card its two CUDA events), and
    each kind's share of the call's end (reading the events)."""
    rec = trace.Recorder(dev)
    out = {}
    for kind, on, device in (("off", False, False), ("host", True, False),
                             ("device", True, True)):
        rec.on = on
        with rec.call("lora.cost"):
            a = time.perf_counter()
            for _ in range(n):
                with rec.span("lora.cost.span", device=device):
                    pass
            b = time.perf_counter()
        c = time.perf_counter()
        out[kind] = (b - a) / n * 1e6
        if on:
            out[kind + "_end"] = (c - b) / n * 1e6
        rec.records()
    return out


def profiled_feed(rx, feed, on_card: bool) -> dict:
    """One more feed with the recorder on, under ``torch.profiler``, read
    by the benchmark's ``lorabench/trace.py``: the ``lora.`` ranges of
    the host's rows against the recorder's spans; their mirrors on the
    device's rows (which that reader counts as device time); and its
    idle stretches by host activity with those mirrors left out."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from lorabench.stats import merge_intervals
    from lorabench.trace import WINDOW, Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    rx.recorder.on = True
    with profile(activities=acts) as prof, record_function(WINDOW):
        rx(feed)
        if on_card:
            torch.cuda.synchronize()
    rx.recorder.on = False
    (rec,) = rx.recorder.records()
    spans: dict = {}
    for s in rec["spans"]:
        spans[s["name"]] = spans.get(s["name"], 0) + 1
    tr = Trace(prof)
    ranges: dict = {}
    for _, _, name in tr.host:
        if name.startswith("lora."):
            ranges[name] = ranges.get(name, 0) + 1
    mirrors = [d for d in tr.device if d[2].startswith("lora.")]
    busy_with = tr.busy_s
    tr.device = [d for d in tr.device if not d[2].startswith("lora.")]
    tr._busy = merge_intervals(
        [(max(s, tr.t0), min(e, tr.t1)) for s, e, *_ in tr.device
         if e > tr.t0 and s < tr.t1])
    tr.busy_s = sum(e - s for s, e in tr._busy) / 1e9
    res = {"spans": spans, "ranges": ranges,
           "mirrors": len(mirrors),
           "mirror_s": sum(e - s for s, e, *_ in mirrors) / 1e9,
           "busy_s_with_mirrors": busy_with, "busy_s": tr.busy_s,
           "window_s": tr.window_s,
           "idle_gaps": tr.breakdown()["idle_gaps"]}
    print(f"profiled feed: ranges equal spans {ranges == spans}, "
          f"{res['mirrors']} device-row mirrors ({res['mirror_s']:.3f} s); "
          f"busy {busy_with:.3f} s with them, {tr.busy_s:.3f} s without, "
          f"of {tr.window_s:.3f} s; idle by host activity "
          + " ".join(f"{n}={v:.4f}" for n, v in res["idle_gaps"][:6]),
          file=sys.stderr)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--profile", action="store_true",
                    help="then one feed under torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans: needs a CUDA device", file=sys.stderr)
        return 3
    res = run(args.workload, args.seed, args.rounds, profile=args.profile)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res))
    print(json.dumps({k: res[k] for k in ("workload", "seed", "card",
                                          "rate", "medians")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
