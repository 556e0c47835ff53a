"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: the cell ``<config>.
<traffic>`` in ``BENCHMARK.json``; ``configs/<config>.json`` (the program's
settings, and the entry module it names, ``engines/<engine>.py``);
``traffic/<traffic>.json`` (read by ``traffic/air.py``); one reader a
metric, ``metrics/<metric>.py``; and the check's limits,
``limits/<cell>.json``.  A new cell is new files and entries.

An entry module holds ``FEED_AS`` (``"numpy"``: a NumPy view of the
page-locked pool; ``"tensor"``: the pinned CPU tensor), ``NEED_COLLISIONS``
(whether colliding packets are owed), ``TRACE_SECONDS`` (the traced run's
window) and ``Engine(config, device)`` with ``warm(feed)``, ``attach(seed,
traced)`` (once set-up is done, just before the window), ``feed(feed)``,
``drain()`` (what a stream still holds after the window), ``pdus(outs,
call, samples_per_feed)``, ``release()`` and ``numbers(run, control)``.
A metric's reader gets the run's ``engine`` beside its times and trace.

Set-up makes the cell's pool of feeds on the card from the seed, copies
it once into page-locked host memory, builds the program and warms it
(the entry module's ``warm``: every shape the traffic uses, one real
feed), then collects and freezes the garbage collector's heap.  The
window hands the program one feed at a time, each when the last has
returned, until the first return at or after ``seconds``.  Then the
program drains what it still holds, its state is dropped, and the
reference judges what it produced.
"""

from __future__ import annotations

import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from .reference import compare
from .traffic import air

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "gr_lora_tpu")


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(man: dict, workload: str, traced: bool) -> list:
    """The metric entries that ``workload`` reports in a run of this kind."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_in(modules) -> list:
    """The FORBIDDEN top-level names among ``modules``, each compared
    whole: ``gr_lora_tpu_torch`` is not ``gr_lora_tpu``."""
    return sorted({name.split(".")[0] for name in modules} & set(FORBIDDEN))


def loaded_forbidden() -> list:
    return forbidden_in(list(sys.modules))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card() -> str:
    """The card's name, clocks, power and power limit (nvidia-smi)."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"


def make_pool(traffic: dict, config: dict, seed: int, device, pinned: bool):
    """(plans, pool): the packets of each of the pool's feeds and the
    feeds themselves, made on ``device`` and copied into one host tensor
    [feeds, channels, T, 2], page-locked when ``pinned``."""
    lora, ch = config["lora"], config["channels"]
    count, t = traffic["pool_feeds"], traffic["samples_per_feed"]
    plans = [air.plan_feed(traffic, lora, ch, config["sfs"], config["bw"],
                           seed, i) for i in range(count)]
    pool = torch.empty((count, ch, t, 2), dtype=torch.float32,
                       pin_memory=pinned)
    for i, plan in enumerate(plans):
        pool[i].copy_(air.make_feed(traffic, lora, plan, ch, config["bw"],
                                    seed, i, device))
    return plans, pool


def run(workload: str, seed: int, seconds: float, traced: bool,
        t0: float | None = None, device: str = "cuda",
        overrides: dict | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object (``correct``, ...,
    ``checks`` last) and raises ``NoChip`` without the cards.
    ``overrides`` (tests only) update the configuration and the traffic
    at small sizes; ``device="cpu"`` runs the program's plain versions.
    ``control`` (``lorabench/control.py``) adds ``control``: the same
    numbers of the reference put in the program's place at the
    configuration's ``control_precision``."""
    t0 = time.monotonic() if t0 is None else t0
    man = manifest()
    cell = cell_of(man, workload)
    on_card = device != "cpu"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell["chips"]):
        raise NoChip(f"{workload} needs {cell['chips']} CUDA device(s); "
                     f"found {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    config = json.loads((PKG / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = air.load(cell["traffic"])
    for base, key in ((config, "config"), (traffic, "traffic")):
        for k, v in (overrides or {}).get(key, {}).items():
            base[k] = {**base.get(k, {}), **v} if isinstance(v, dict) else v
    engine_mod = importlib.import_module(
        f"lorabench.engines.{config['engine']}")
    torch.set_num_threads(2)

    r = SimpleNamespace(config=config, traffic=traffic, dev=dev,
                        on_card=on_card, engine_mod=engine_mod)
    _setup(r, seed, traced, t0)
    limit = min(seconds, engine_mod.TRACE_SECONDS) if traced else seconds
    _window(r, limit, traced)
    numbers, controls, owed = _judge(r, control)
    limits_path = PKG / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() \
        else {}
    correct = all(k in limits and v <= limits[k] for k, v in numbers.items())

    ctx = SimpleNamespace(
        setup_s=r.setup_s, window_s=r.window_s, feed_s=r.feed_s,
        channels=config["channels"],
        samples_per_feed=traffic["samples_per_feed"],
        sample_rate=config["sample_rate"], trace=r.trace, engine=r.engine,
        config=config)
    metrics = {}
    for m in metrics_of(man, workload, traced):
        value = importlib.import_module(
            f"lorabench.metrics.{m['name']}").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": owed,
              "failed": round(numbers["pdu_missing_pct"] * owed / 100.0),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev)
                         if on_card else "cpu",
                         "count": cell["chips"] if on_card else 0,
                         "memory_peak_bytes": r.memory_peak}}
    if r.trace is not None:
        result["device"].update(busy_s=r.trace.busy_s,
                                window_s=r.trace.window_s)
        result["breakdown"] = r.trace.breakdown()
    if controls is not None:
        result["control"] = controls
    result["checks"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in numbers.items()}
    for k, v in result["checks"].items():
        _log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result


def _setup(r, seed: int, traced: bool, t0: float) -> None:
    """The pool on the card and in page-locked memory, the program built
    and warmed, the collector's heap frozen."""
    parts = {"imports": time.monotonic() - t0}
    t = time.monotonic()
    r.plans, r.pool = make_pool(r.traffic, r.config, seed, r.dev, r.on_card)
    if r.on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["traffic"] = time.monotonic() - t
    t = time.monotonic()
    r.engine = r.engine_mod.Engine(r.config, r.dev)
    parts["program"] = time.monotonic() - t
    r.feeds = [r.pool[i].numpy() if r.engine_mod.FEED_AS == "numpy"
               else r.pool[i] for i in range(len(r.pool))]
    t = time.monotonic()
    r.outputs = [(0, r.engine.warm(r.feeds[0]))]
    if r.on_card:
        torch.cuda.synchronize()
    parts["warm"] = time.monotonic() - t
    r.engine.attach(seed, traced)
    gc.collect()
    gc.freeze()
    r.setup_s = time.monotonic() - t0
    _log("setup " + " ".join(f"{k}_s={v:.4f}" for k, v in parts.items())
         + f" setup_s={r.setup_s:.4f}")


def _window(r, limit: float, traced: bool) -> None:
    """Feeds, one when the last has returned, until the first return at
    or after ``limit`` seconds; then the drain, the look at the loaded
    modules and, when traced, the trace."""
    prof = window = None
    if traced:
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if r.on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window = record_function("lorabench.window")
        window.__enter__()
    r.calls, r.feed_s = 1, []
    w0 = time.monotonic()
    while True:
        a = time.monotonic()
        outs = r.engine.feed(r.feeds[r.calls % len(r.feeds)])
        if r.on_card:
            torch.cuda.synchronize()
        b = time.monotonic()
        r.outputs.append((r.calls, outs))
        r.feed_s.append(b - a)
        r.calls += 1
        if b - w0 >= limit:
            break
    r.window_s = b - w0
    _log(f"feeds n={len(r.feed_s)} s=" + ",".join(f"{x:.3f}"
                                                 for x in r.feed_s))
    if traced:
        window.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    r.memory_peak = torch.cuda.max_memory_allocated(r.dev) \
        if r.on_card else 0
    gc.unfreeze()

    r.outputs.append((r.calls - 1, r.engine.drain()))
    forbidden = loaded_forbidden()
    if forbidden:
        raise RuntimeError(f"modules loaded in the run: {forbidden}")
    r.trace = None
    if traced and r.on_card:
        from .trace import Trace

        r.trace = Trace(prof)
        slow = [(n, s) for n, s in r.trace.pageable_htod() if s >= 1e-4]
        _log(f"htod pageable={len(r.trace.pageable_htod())}")
        if slow:
            raise RuntimeError(f"host-to-device copies from pageable "
                               f"memory in the window: {slow[:5]}")


def _judge(r, control: bool):
    """(numbers, control numbers or None, packets owed): the program's
    state dropped first, then the reference's comparisons."""
    r.engine.release()
    r.feeds = None
    if r.on_card:
        torch.cuda.empty_cache()
        _log(f"card {_card()}")
    t = time.monotonic()
    ctx = SimpleNamespace(pool=r.pool, check_device=r.dev)
    t_feed = r.traffic["samples_per_feed"]
    sent = [(call * t_feed + pk.start, pk) for call in range(r.calls)
            for pk in r.plans[call % len(r.plans)]]
    pdus = [d for call, outs in r.outputs
            for d in r.engine.pdus(outs, call, t_feed)]
    need = r.engine_mod.NEED_COLLISIONS
    numbers = compare.pdu_numbers(sent, pdus, need, r.config["lora"]["p"])
    numbers.update(r.engine.numbers(ctx))
    controls = r.engine.numbers(ctx, r.config["control_precision"]) \
        if control else None
    owed = sum(1 for _, pk in sent if need or not pk.collides)
    _log(f"check_s={time.monotonic() - t:.4f} feeds={len(r.feed_s)} "
         f"pdus={len(pdus)} owed={owed}")
    return numbers, controls, owed
