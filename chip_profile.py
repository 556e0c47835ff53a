"""Profile the port's gateways on one NVIDIA GPU: where the time goes.

    python3 chip_profile.py

Three paths, on chip_smoke.py's fixtures:

- north star: TriggeredPyramidGateway, 64 channels x SF7-12, backend
  "fused" (K1, K2), 2^20 samples a channel a feed; then the same with
  ``sic=True`` (models/sic on every window with a tracked packet);
- always-on, once per kernel backend ("rdft": K3, "direct": K4b,
  "fused_direct": K4, "fastp": K5, "pallas": K6): PyramidGateway, 16
  channels, SF8 x ff 8, 2048-hop blocks, four blocks a pass, fed in
  50 000-sample numpy chunks;
- multi-SF: MultiSFPyramidGateway, 16 channels x SF7-12, "fastp".

Each path: one warm pass (feed), three timed ones (host wall each, and the
gateway's wall split summed over the three), then one under torch.profiler:
the device's busy time (the union of its kernel and copy intervals), the
idle share of that pass's wall time, and device time by kernel name.
Then the north star's peak lattices alone: K1 (SF7-9) and K2 (SF10, SF12)
on chip_smoke.py's event windows, ten calls each under torch.profiler,
device time a call by kernel (the product or walk, a pre-pass, the
merge), and for K2 the peaks a band of 256 columns and hop (from its
front end's dense folds).  Prints one line per path and lattice and, as
the last line, a JSON object with every number.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from chip_smoke import (AO_BACKENDS, AO_BLOCK_HOPS, AO_CHANNELS, AO_CHUNK,
                        CHANNELS, SFS, T, _event_windows, always_on_fixture,
                        base_config, fail, north_star_fixture)

TIMED_PASSES = 3
TOP_KERNELS = 10


def _pass(gw, iq, chunk: int | None = None) -> float:
    """One pass of ``iq`` through ``gw`` (in ``chunk``-sample pieces, or
    whole), ending in a synchronize; host seconds."""
    import torch

    step = chunk or iq.shape[1]
    t0 = time.perf_counter()
    for lo in range(0, iq.shape[1], step):
        gw.feed(iq[:, lo:lo + step])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_split(prof) -> tuple[float, dict]:
    """(busy ms, {name: ms}) of the device-side events of ``prof``."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        by_name[e.name] = by_name.get(e.name, 0.0) + (hi - lo) / 1e3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3, by_name


def _profile(label: str, gw, iq, card: str, chunk: int | None) -> dict:
    """Warm pass, TIMED_PASSES timed passes, one profiled pass."""
    from torch.profiler import ProfilerActivity, profile

    _pass(gw, iq, chunk)
    gw.wall_reset()
    secs = [_pass(gw, iq, chunk) for _ in range(TIMED_PASSES)]
    wall = gw.wall_reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_s = _pass(gw, iq, chunk)
    busy_ms, by_name = _device_split(prof)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])
               [:TOP_KERNELS])
    idle = 1.0 - busy_ms / (prof_s * 1e3) if busy_ms else None
    per_ch = iq.shape[1] / 250e3
    kern = ", ".join(f"{k[:40]} {v:.2f}" for k, v in top.items())
    split = " ".join(f"{k}={v:.4f}" for k, v in wall.items())
    idle_txt = f"{idle:.3f}" if idle is not None else "not measured"
    print(f"profile {label} T={iq.shape[1]} on {card}: "
          f"pass_s={[round(s, 4) for s in secs]} "
          f"x_realtime_per_channel={[round(per_ch / s, 2) for s in secs]} "
          f"wall_s[{split}] profiled_pass_s={prof_s:.4f} "
          f"device_busy_ms={busy_ms:.2f} idle={idle_txt} "
          f"device_ms[{kern}]")
    return {"pass_s": secs, "wall_s": wall, "profiled_pass_s": prof_s,
            "device_busy_ms": busy_ms, "idle_share": idle,
            "device_ms_by_kernel": top,
            "x_realtime_per_channel": [per_ch / s for s in secs]}


def _lattices(gw, iq_dev, singles, card: str) -> dict:
    """Device time a call by kernel of the north star's K1 and K2 on
    their event windows (ten calls under torch.profiler), and K2's peaks
    a band of 256 columns and hop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for sf in (7, 8, 9, 10, 12):
        st = gw.sf_states[sf]
        lat = gw.lattice(sf)
        mod = lat.inner if sf >= 10 else lat
        x = _event_windows(iq_dev, gw, singles, sf, gw.event_batch,
                           lat.seg if sf >= 10 else gw._win_samples(st))
        res = {}
        if sf >= 10:
            g = mod.plan.chunk_dft(x, mod.num_hops)
            _, faw, _ = mod.front.kernel(g)
            peak = ((faw > mod.threshold) & (faw > faw.roll(1, -1))
                    & (faw > faw.roll(-1, -1)))
            band = peak.reshape(*peak.shape[:-1], -1, 256).sum(-1).float()
            res["peaks_per_band_hop"] = {"mean": float(band.mean()),
                                         "max": float(band.max())}
            del faw, peak, band

            def call():
                return mod.from_chunks(g)
        else:
            def call():
                return mod(x)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        ms = {e.key: e.device_time_total / 1e3 / 10
              for e in prof.key_averages() if e.device_time_total > 0}
        res["device_ms_per_call"] = ms
        kern = ", ".join(f"{k[:48]} {v:.4f}" for k, v in
                         sorted(ms.items(), key=lambda kv: -kv[1]))
        dens = res.get("peaks_per_band_hop")
        extra = (f" peaks_per_band_hop[mean={dens['mean']:.3f} "
                 f"max={dens['max']:.0f}]" if dens else "")
        print(f"profile lattice SF{sf} {type(mod).__name__} "
              f"[{x.shape[0]}, {x.shape[1]}, 2] on {card}: "
              f"device_ms_per_call[{kern}]{extra}")
        out[f"SF{sf}"] = res
    return out


def main() -> None:
    import torch

    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.pyramid_gateway import (
        MultiSFPyramidGateway, PyramidGateway)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: a CUDA device is needed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip() or "nvidia-smi unavailable"
    print(f"device {torch.cuda.get_device_name(0)} nvidia-smi: {card}")
    dev = torch.device("cuda:0")
    results = {}

    gw = TriggeredPyramidGateway(base_config(), CHANNELS, sfs=SFS,
                                 max_payload_len=16, backend="fused",
                                 device=dev)
    iq, singles = north_star_fixture({sf: st.cfg for sf, st in
                                      gw.sf_states.items()})
    iq_dev = torch.from_numpy(iq).to(dev)
    results["north_star"] = _profile(
        f"north-star {CHANNELS}ch x SF7-12 fused", gw, iq_dev, card, None)
    with torch.no_grad():
        results["north_star_lattices"] = _lattices(gw, iq_dev, singles,
                                                   card)
    gw = TriggeredPyramidGateway(base_config(), CHANNELS, sfs=SFS,
                                 max_payload_len=16, backend="fused",
                                 sic=True, device=dev)
    results["north_star_sic"] = _profile(
        f"north-star sic {CHANNELS}ch x SF7-12 fused", gw, iq_dev, card,
        None)
    results["north_star_sic"]["sic_windows"] = gw.sic_windows
    del gw, iq, iq_dev
    torch.cuda.empty_cache()

    cfg = base_config()
    iq, _ = always_on_fixture(cfg)
    for backend in AO_BACKENDS:
        gw = PyramidGateway(cfg, AO_CHANNELS, block_hops=AO_BLOCK_HOPS,
                            max_peaks=8, backend=backend, device=dev)
        results[f"always_on_{backend}"] = _profile(
            f"always-on backend={backend} {AO_CHANNELS}ch SF8", gw, iq,
            card, AO_CHUNK)
        del gw
        torch.cuda.empty_cache()

    cfgs = {sf: base_config().replace(sf=sf, ldr=(1 << sf) / 125e3 > 16e-3)
            for sf in SFS}
    iq, _ = north_star_fixture(cfgs, AO_CHANNELS, T)
    bh = {sf: max(64, AO_BLOCK_HOPS * 256 // (1 << sf)) for sf in SFS}
    gw = MultiSFPyramidGateway(base_config(), AO_CHANNELS, sfs=SFS,
                               block_hops=bh, max_peaks=8, backend="fastp",
                               device=dev)
    results["multi_sf_fastp"] = _profile(
        f"multi-SF backend=fastp {AO_CHANNELS}ch x SF7-12", gw, iq, card,
        None)
    print(json.dumps({"card": card, "profiles": results}))


if __name__ == "__main__":
    sys.exit(main())
