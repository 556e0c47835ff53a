"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero without the
final ``ok`` line):

1. device  — a CUDA device is required; prints nvidia-smi's name and
   power limit;
2. build   — compiles ``gr_lora_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
3. parity  — each hand-written kernel against its plain PyTorch version
   on the card at main-path shapes (K1 rDFT peaks at SF8/SF9, K2 overlap
   peaks at SF10/SF12, 8 event lanes), with CUDA-event times of both.  K1
   sums bf16 products in another order than its plain version: the same
   peaks up to f32 ties, heights within rtol 1e-3.  K2 rounds as its
   plain version does: equal peaks and heights;
4. main    — the north-star gateway: 64 channels x SF7-12 detection-gated
   Pyramid collision decoding (TriggeredPyramidGateway, backend "fused")
   fed the golden SF8 collision on every channel plus one single per
   channel, twice, then flushed; asserts the decodes and that both kernels
   ran on the main path.

The line before the last is a JSON object with every kernel's route,
source, launches, max |delta| against its plain version and times; the
last line is ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SFS = (7, 8, 9, 10, 11, 12)
CHANNELS = 64
T = 1 << 20                      # air samples per channel per feed
PDU1 = "0630f0010203040506050801"
PDU2 = "0530000707070707e76b01"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def base_config():
    from gr_lora_tpu import LoraConfig

    return LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0)


def north_star_fixture(cfgs: dict):
    """The north-star fixture (the JAX package's bench_north_star):
    noise 0.003 from default_rng(0), the golden SF8 collision on every
    channel, one single at SF SFS[c % 6] per channel.  Returns
    (iq float32 [C, T, 2], {channel: (single payload hex, offset)})."""
    from gr_lora_tpu.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg8 = cfgs[8]
    n8 = cfg8.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg8), cfg8,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg8), cfg8,
                         pad_front=0, pad_back=0)
    singles = {sf: 0.15 * modulate(encode(bytes([sf, 1, 2, sf]), cfgs[sf]),
                                   cfgs[sf], pad_front=0, pad_back=0)
               for sf in SFS}
    rng = np.random.default_rng(0)
    iq = (0.003 * (rng.standard_normal((CHANNELS, T))
                   + 1j * rng.standard_normal((CHANNELS, T)))
          ).astype(np.complex64)
    off2_rel = 16 * n8 + 4 * n8 // 8 + 204
    single = {}
    for c in range(CHANNELS):
        base_off = (4000 + c * 4999) % (T // 2)
        iq[c, base_off:base_off + len(p1)] += p1
        o2 = base_off + off2_rel
        iq[c, o2:o2 + len(p2)] += p2
        sf = SFS[c % len(SFS)]
        s = singles[sf]
        if len(s) + 1 < T - T * 2 // 3:
            so = T * 2 // 3 + (c * 2999) % (T - T * 2 // 3 - len(s) - 1)
            iq[c, so:so + len(s)] += s
            single[c] = (bytes([sf, 1, 2, sf]).hex(), so)
    return to_ri(iq), single


def _compare(kern, plain, faw_plain, rtol, threshold):
    """Kernel vs plain peaks (ops/peak_epilogue.compare_peaks): the same
    bins (up to f32 ties of the plain fold ``faw_plain``, where given),
    heights within rtol.  Returns (max |delta| of the matched heights,
    peaks decided by a tie)."""
    from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks

    try:
        return compare_peaks(plain, kern, rtol, faw=faw_plain,
                             threshold=threshold)
    except AssertionError as e:
        fail(f"kernel differs from its plain version: {e}")


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _event_windows(iq_dev, gw, singles, sf, lanes, length):
    """[lanes, length, 2] windows of the fixture on the card, each
    starting one lead before a channel's golden collision (SF8) or single
    — the shapes and contents the gateway hands the lattice."""
    import torch

    st = gw.sf_states[sf]
    t = iq_dev.shape[1]
    chs = [c for c in singles if SFS[c % len(SFS)] == sf][:lanes]
    if len(chs) < lanes:
        fail(f"fixture has {len(chs)} SF{sf} channels, need {lanes}")
    starts = []
    for c in chs:
        lo = (4000 + c * 4999) % (t // 2) if sf == 8 else singles[c][1]
        starts.append(max(0, min(lo - st.lead, t - length)))
    return torch.stack([iq_dev[c, s:s + length]
                        for c, s in zip(chs, starts)]).contiguous()


def parity(gw, iq_dev, singles, report: dict) -> None:
    """Phase 3: every kernel against its plain version at main-path
    shapes, on the card."""
    import torch

    from gr_lora_tpu_torch.models.pyramid import BlockedLattice
    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    lanes = gw.event_batch
    for sf in (8, 9):
        st = gw.sf_states[sf]
        mod = gw.lattice(sf)
        if not isinstance(mod, RdftPeaks):
            fail(f"SF{sf} lattice is {type(mod).__name__}, not K1")
        x = _event_windows(iq_dev, gw, singles, sf, lanes,
                           gw._win_samples(st))
        kern = mod(x)
        plain = mod.plain(x)
        _, faw, _ = mod.spectra_plain(x)
        torch.cuda.synchronize()
        err, moved = _compare(kern, plain, faw, 1e-3, st.cfg.threshold)
        ms = _time_ms(lambda: mod(x), 5)
        plain_ms = _time_ms(lambda: mod.plain(x), 3)
        shape = f"SF{sf} [{lanes}, {x.shape[1]}, 2] -> [{lanes}, " \
                f"{mod.num_frames}, {mod.max_peaks}]"
        print(f"parity K1 rdft_peaks {shape}: max_abs_err={err:.6g} "
              f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        report["rdft_peaks"].append((err, ms, plain_ms, shape))
    for sf in (10, 12):
        st = gw.sf_states[sf]
        lat = gw.lattice(sf)
        if not (isinstance(lat, BlockedLattice)
                and isinstance(lat.inner, OverlapPeaks)):
            fail(f"SF{sf} lattice is not blocked K2")
        mod = lat.inner
        x = _event_windows(iq_dev, gw, singles, sf, lanes, lat.seg)
        g = mod.plan.chunk_dft(x, mod.num_hops)
        kern = mod.from_chunks(g)
        plain = mod.plain_from_chunks(g)
        torch.cuda.synchronize()
        # K2 rounds every operation as its plain version does: exact.
        err, moved = _compare(kern, plain, None, 0.0, st.cfg.threshold)
        ms = _time_ms(lambda: mod.from_chunks(g), 5)
        plain_ms = _time_ms(lambda: mod.plain_from_chunks(g), 3)
        shape = f"SF{sf} G [{lanes}, {g.shape[1]}, {g.shape[2]}, 2] -> " \
                f"[{lanes}, {mod.num_hops}, {mod.max_peaks}]"
        print(f"parity K2 overlap_peaks {shape}: max_abs_err={err:.6g} "
              f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        report["overlap_peaks"].append((err, ms, plain_ms, shape))


def main_path(gw, iq_dev, singles, card: str) -> dict:
    """Phase 4: feed the fixture twice, flush, check the decodes."""
    import torch

    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    channels, t = iq_dev.shape[0], iq_dev.shape[1]
    mods = {"rdft_peaks": [], "overlap_peaks": []}
    for sf in SFS:
        for m in gw.lattice(sf).modules():
            if isinstance(m, RdftPeaks):
                mods["rdft_peaks"].append(m)
            elif isinstance(m, OverlapPeaks):
                mods["overlap_peaks"].append(m)
    for ms in mods.values():
        for m in ms:
            m.launches = 0
    gw.wall_reset()

    feeds, walls, secs = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        feeds.append(gw.feed(iq_dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        walls.append(gw.wall_reset())
    t0 = time.perf_counter()
    tail = gw.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    launches = {k: sum(m.launches for m in ms) for k, ms in mods.items()}

    def ok_pdus(pkts):
        got = {}
        for p in pkts:
            if p.result is not None and p.result.ok and p.result.crc_ok:
                got.setdefault(p.channel, set()).add(
                    (p.sf, bytes(p.result.payload).hex()))
        return got

    for i, pk in enumerate(feeds):
        got = ok_pdus(pk)
        missing = [c for c in range(channels)
                   if not {(8, PDU1), (8, PDU2)} <= got.get(c, set())]
        if missing:
            fail(f"feed {i + 1}: golden PDUs missing on channels {missing}")
    every = ok_pdus(feeds[0] + feeds[1] + tail)
    lost = [c for c, (hx, _) in singles.items()
            if not any(sf == SFS[c % len(SFS)] and hx in h
                       for sf, h in every.get(c, set()))]
    if lost:
        fail(f"singles not decoded on channels {lost}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")

    w = walls[1]
    sps = channels * t / secs[1]
    npk = sum(len(f) for f in feeds) + len(tail)
    print(f"main north-star {channels}ch x SF7-12 T={t} x2 feeds + flush "
          f"on {card}: packets={npk} (feed1={len(feeds[0])} "
          f"feed2={len(feeds[1])} flush={len(tail)}) "
          f"feed_s=[{secs[0]:.4f}, {secs[1]:.4f}] flush_s={flush_s:.4f} "
          f"feed2_wall[ingest={w['ingest']:.4f} scan={w['scan']:.4f} "
          f"lattice={w['lattice']:.4f} tracker={w['tracker']:.4f} "
          f"decode={w['decode']:.4f}] feed2_samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"launches={launches}")
    return launches


def main() -> None:
    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: a CUDA device is needed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"device {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvidia-smi: {card}")

    # Phase 2: build.
    from gr_lora_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"build {len(_build.sources())} sources -> "
          f"{_build.LIB_PATH.name} in {time.perf_counter() - t0:.2f} s")

    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gw = TriggeredPyramidGateway(base_config(), CHANNELS, sfs=SFS,
                                 max_payload_len=16, backend="fused",
                                 tracker="host", device=dev)
    cfgs = {sf: st.cfg for sf, st in gw.sf_states.items()}
    iq, singles = north_star_fixture(cfgs)
    iq_dev = torch.from_numpy(iq).to(dev)

    # Phase 3: kernel parity on the card.
    report = {"rdft_peaks": [], "overlap_peaks": []}
    with torch.no_grad():
        parity(gw, iq_dev, singles, report)

    # Phase 4: the main path.
    launches = main_path(gw, iq_dev, singles, card)

    if "jax" in sys.modules:
        fail("jax was imported")
    meta = {
        "rdft_peaks": ("cuda", "gr_lora_tpu_torch/csrc/rdft_peaks.cu",
                       "gr_lora_tpu/ops/pallas_rdft.py:352"),
        "overlap_peaks": ("cuda", "gr_lora_tpu_torch/csrc/overlap_peaks.cu",
                          "gr_lora_tpu/ops/pallas_peaks.py:167"),
    }
    kernels = []
    for name, rows in report.items():
        route, source, replaces = meta[name]
        err = max(r[0] for r in rows)
        _, ms, plain_ms, shape = rows[-1]       # the largest main-path shape
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "shape": shape})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
