"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero without
the final ``ok`` line):

1. device  — a CUDA device is required; prints nvidia-smi's name and
   power limit;
2. build   — compiles ``gr_lora_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one nvcc per source, all at once, and prints ptxas's registers, spills
   and static shared memory of every kernel;
3. parity  — each hand-written kernel against its plain PyTorch version
   on the card at main-path shapes, with CUDA-event times of both:
   K1 rDFT peaks at SF7/SF8/SF9 and K2 overlap peaks at SF10/SF12 on 8
   event lanes (the gated gateway's windows; their peak searches fused:
   each call's peak allocation must stay below one [lanes, hops, K] f32
   array); K3 rDFT spectra, K4b direct
   spectra and K6 chunk spectra (each beside cuBLAS's time for its bare
   product, torch.matmul of the same bf16 operands; ``peak_topm`` timed at
   M = 8 and M = 32 on K3's spectra), K4 direct peaks (its
   peak search fused: the call's peak allocation must stay below one
   [lanes, hops, K] f32 array) and K5 overlap spectra on one always-on
   block of 16 channels x 2048 hops at SF8 (K5 also on the SF12 block of
   the multi-SF gateway); then, on 3 lanes of one packet each, K5 and K2
   at SF7 x fft_factor 16 (both timed), every kernel backend's lattice at
   M = 32 (above the fused searches' 16: the dense route), K3,
   K1 and K6 at SF7 p 1 (hop 16 samples) and K3 and K1 on a ragged frame
   count.  Tolerances: K1, K3, K4b, K6 and K4 sum bf16 products in
   another order than their plain versions — the same peaks up to f32
   ties, heights within rtol 1e-3, and the dense K3 / K4b / K6 spectra
   within 1e-4 of the largest value; K2 and K5 round as their plain
   versions do: equal bit for bit;
4. main    — the north-star gateway: 64 channels x SF7-12
   detection-gated Pyramid collision decoding (TriggeredPyramidGateway,
   backend "fused": K1 and K2) fed the golden SF8 collision on every
   channel plus one single per channel, twice, then flushed (K1's
   launches printed per SF);
5. always-on — the always-on gateway (PyramidGateway) at the
   rx_file_collision.grc point, 16 channels, 2048-hop blocks, once per
   kernel backend ("rdft": K3, "direct": K4b, "fused_direct": K4,
   "fastp": K5, "pallas": K6), fed two passes of a stream whose
   collisions straddle block boundaries in chunks, then flushed;
6. multi-SF — MultiSFPyramidGateway, 16 channels x SF7-12, backend
   "fastp" (K5 at every SF), fed the golden collision and one single at
   a round-robin SF per channel;
7. probes — P1, the tensor-core rate probe (wgmma + TMA), and P2, the
   tensor-core / CUDA-core overlap probe, at the main path's dot shape
   (256, 512, 4352): each checked against its plain version first (P1's
   whole scratch, all four slabs, and its value within rtol 1e-3, at the
   main shape and at (128, 256, 1024); P2 over 4 and 6 steps: its chain
   slab equal bit for bit, its product within rtol 1e-3; over the timed 64
   steps, where the chain is NaN everywhere: the slab's NaN mask equal
   and the product), then timed: P1's TFLOP/s beside torch.matmul's
   (cuBLAS) on the same bf16 operands, P2's three kinds, `vpu` over 4
   steps (all finite) beside it, and its overlap efficiency;
8. sic     — successive interference cancellation (models/sic): (a) the
   collision-recovery envelope of bench.py --mode collision (SF8, 66
   offset x ratio points) through pyramid_demodulate at grace 0 and 8
   and sic_demodulate at backend "xla", then SIC at "fused" (K1 in its
   dense passes): SIC must recover both packets at all 66 points at
   either backend; (b) the Python tracker equal to the native one on the
   golden collision; (c) phase 4's north star with ``sic=True``: every
   golden PDU and single, every PDU phase 4 decoded, SIC windows run
   (their wall, count and the K1 / K2 launches of SIC's own dense
   passes printed);
9. fsm     — the FSM receive path, which launches none of the nine
   kernels (models/demodulator, models/weak, dist/multi_sf,
   dist/triggered; the per-lane state machine stepped on the card, 32
   steps a captured CUDA graph): (a) demod_fn batched over 64 channels
   of bench.py --mode gateway's fixture (SF8, implicit header, payload 6,
   p 2, ff 2, 1024 symbols, noise 0.05): every payload byte-exact with
   its CRC; samples/s over 3 replayed passes, steps a pass, ms a step
   replayed and eager (the same steps launch by launch, equal outputs),
   launches a step; (b) MultiSFReceiver and (c) TriggeredReceiver over
   phase 4's fixture on its device copy: every single (for (b) every
   single the whole-buffer FSM can reach: one ending under one symbol
   before the capture's end is printed, not asserted), the collision
   PDUs printed; (d) StreamingDemodulator on (a)'s channel 0 in 50 000-
   sample chunks, pipelined off and on, equal to (a), and a mid-packet
   checkpoint resumed in a fresh streamer; (e) weak_demod_fn over 64
   noisy trials of bench.py --mode per's SF8 weak point plus a clean lane
   (which must decode; PER printed), and the loopback at SF7-12, byte-
   exact.  (a)-(c) each profile one pass under torch.profiler (device
   busy and idle shares, device time by kind of kernel).

Phases 4-8 each assert what they check and that their kernels ran: every
launch count is set to 0 just before a phase and read just after.  The
line before the last is a JSON object with every kernel's route, source,
the TPU kernel it replaces, launches, max |delta| against its plain
version, times, and the least time the card could take (``bound_ms``:
the larger of the bytes the function must move over 3.35 TB/s and its
operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32, from this run's
shapes); the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

SFS = (7, 8, 9, 10, 11, 12)
CHANNELS = 64
T = 1 << 20                      # air samples per channel per feed
PDU1 = "0630f0010203040506050801"
PDU2 = "0530000707070707e76b01"
#: The always-on gateway (bench.py --mode pyramid_gateway at 16 channels).
AO_CHANNELS = 16
AO_BLOCK_HOPS = 2048
AO_BACKENDS = {"rdft": "rdft_spectra", "direct": "direct_spectra",
               "fused_direct": "direct_peaks", "fastp": "overlap_spectra",
               "pallas": "chunk_spectra"}
AO_CHUNK = 50_000                # feed chunk: blocks are 131 072 samples
#: The card's published peaks (H100 SXM, dense, at 700 W): bf16 tensor
#: cores, f32 on the CUDA cores, device memory.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def base_config():
    from gr_lora_tpu_torch import LoraConfig

    return LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0)


def north_star_fixture(cfgs: dict, channels: int = CHANNELS, t: int = T):
    """The north-star fixture (the JAX package's bench_north_star):
    noise 0.003 from default_rng(0), the golden SF8 collision on every
    channel, one single at SF SFS[c % 6] per channel.  Returns
    (iq float32 [C, t, 2], {channel: (single payload hex, offset)})."""
    from gr_lora_tpu_torch.core.codec import encode
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
    iq = (0.003 * (rng.standard_normal((channels, t))
                   + 1j * rng.standard_normal((channels, t)))
          ).astype(np.complex64)
    off2_rel = 16 * n8 + 4 * n8 // 8 + 204
    single = {}
    for c in range(channels):
        base_off = (4000 + c * 4999) % (t // 2)
        iq[c, base_off:base_off + len(p1)] += p1
        o2 = base_off + off2_rel
        iq[c, o2:o2 + len(p2)] += p2
        sf = SFS[c % len(SFS)]
        s = singles[sf]
        if len(s) + 1 < t - t * 2 // 3:
            so = t * 2 // 3 + (c * 2999) % (t - t * 2 // 3 - len(s) - 1)
            iq[c, so:so + len(s)] += s
            single[c] = (bytes([sf, 1, 2, sf]).hex(), so)
    return to_ri(iq), single


def always_on_fixture(cfg, blocks: int = 4):
    """bench.py --mode pyramid_gateway's fixture stretched over ``blocks``
    2048-hop blocks: noise 0.01 from default_rng(0), and per channel the
    golden collision at bench.py's offset in block 0 plus a second one
    straddling the boundary of blocks 1 and 2.  Returns (iq float32
    [16, T, 2], the two collisions' first-packet offsets per channel)."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    n = cfg.num_samples
    hop = n // 8
    block = AO_BLOCK_HOPS * hop + (n - hop)
    t = blocks * AO_BLOCK_HOPS * hop + (n - hop)
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(0)
    iq = (0.01 * (rng.standard_normal((AO_CHANNELS, t))
                  + 1j * rng.standard_normal((AO_CHANNELS, t)))
          ).astype(np.complex64)
    offsets = {}
    for c in range(AO_CHANNELS):
        base = (1000 + c * 997) % max(block - len(p1) - 17 * n, 1)
        straddle = 2 * AO_BLOCK_HOPS * hop - len(p1) // 2 + c * 997
        for b in (base, straddle):
            off2 = b + 16 * n + 4 * n // 8 + 204
            iq[c, b:b + len(p1)] += p1
            iq[c, off2:off2 + len(p2)] += p2
        offsets[c] = (base, straddle)
    return to_ri(iq), offsets


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


def _ok_pdus(pkts) -> dict:
    """{channel: {(sf, payload hex)}} of the packets that decoded with
    a CRC pass."""
    got = {}
    for p in pkts:
        if p.result is not None and p.result.ok and p.result.crc_ok:
            got.setdefault(p.channel, set()).add(
                (p.sf, bytes(p.result.payload).hex()))
    return got


def _kernel_name(mangled: str) -> str:
    """The kernel's identifier in a mangled name, with its template
    arguments (``ILb1ELb0EE``) where it has them."""
    m = re.search(r"[A-Za-z_]+kernel", mangled)
    if not m:
        return mangled
    targs = re.match(r"I\w*?EE", mangled[m.end():])
    return m.group() + (targs.group() if targs else "")


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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the least time the card could take for the
    work — the larger of the bytes it must move (each input read once,
    each output written once) over the memory rate and its operations
    over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(bf16_ops / BF16_FLOPS, f32_ops / F32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _row(err, ms, plain_ms, shape, bound, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "shape": shape}


def _peak_bytes(lanes: int, hops: int, m: int) -> int:
    """Bytes of a peak lattice: bins int32, h and h_single f32, valid."""
    return 13 * lanes * hops * m


def _unfused_floor_ms(f32_ops: float) -> float:
    """Least time for ``f32_ops`` operations that may not fuse into FMAs
    (K2 / K5 round every product and sum on its own): one operation a
    lane a cycle, half the FMA-counted 67 TFLOP/s."""
    return f32_ops / (F32_FLOPS / 2) * 1e3


def _overlap_f32_ops(plan, lanes: int, hops: int) -> int:
    """K2 / K5 f32 operations: per hop and spectral bin, the 8-term
    bin-shifted complex sum (8 complex multiply-adds), its magnitude, the
    window's complex taps and their magnitude; then three folds a bin."""
    f, k, taps = plan.fft_size, plan.bin_size, len(plan.shift_list)
    return lanes * hops * (f * (8 * 8 + 4 + 8 * taps + 4) + 3 * k)


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
    for sf in (7, 8, 9):
        st = gw.sf_states[sf]
        mod = gw.lattice(sf)
        if not isinstance(mod, RdftPeaks):
            fail(f"SF{sf} lattice is {type(mod).__name__}, not K1")
        x = _event_windows(iq_dev, gw, singles, sf, lanes,
                           gw._win_samples(st))
        kern, alloc = _fused_alloc("rdft_peaks", lambda: mod(x), lanes,
                                   mod.num_frames, mod.front.k)
        plain = mod.plain(x)
        _, faw, _ = mod.front.plain(x)
        torch.cuda.synchronize()
        err, moved = _compare(kern, plain, faw, 1e-3, st.cfg.threshold)
        ms = _time_ms(lambda: mod(x), 5)
        plain_ms = _time_ms(lambda: mod.plain(x), 3)
        shape = f"SF{sf} [{lanes}, {x.shape[1]}, 2] -> [{lanes}, " \
                f"{mod.num_frames}, {mod.max_peaks}]"
        fr = mod.front
        # Four [n] x [2 (K + 1)] dots a frame: bins 0..K (the TPU plan's
        # lane pad past K is not the function's work).
        bound = _bound(_nbytes(x, fr.w, fr.consts)
                       + _peak_bytes(lanes, mod.num_frames, mod.max_peaks),
                       lanes * mod.num_frames * 16 * fr.n * (fr.k + 1))
        print(f"parity K1 rdft_peaks {shape}: max_abs_err={err:.6g} "
              f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound[0]:.4f} alloc_bytes={alloc}")
        report["rdft_peaks"].append(_row(err, ms, plain_ms, shape, bound))
    for sf in (10, 12):
        st = gw.sf_states[sf]
        lat = gw.lattice(sf)
        if not (isinstance(lat, BlockedLattice)
                and isinstance(lat.inner, OverlapPeaks)):
            fail(f"SF{sf} lattice is not blocked K2")
        mod = lat.inner
        x = _event_windows(iq_dev, gw, singles, sf, lanes, lat.seg)
        g = mod.plan.chunk_dft(x, mod.num_hops)
        kern, alloc = _fused_alloc("overlap_peaks",
                                   lambda: mod.from_chunks(g), lanes,
                                   mod.num_hops, mod.front.k)
        plain = mod.plain_from_chunks(g)
        torch.cuda.synchronize()
        # K2 rounds every operation as its plain version does: exact.
        err, moved = _compare(kern, plain, None, 0.0, st.cfg.threshold)
        ms = _time_ms(lambda: mod.from_chunks(g), 5)
        plain_ms = _time_ms(lambda: mod.plain_from_chunks(g), 3)
        shape = f"SF{sf} G [{lanes}, {g.shape[1]}, {g.shape[2]}, 2] -> " \
                f"[{lanes}, {mod.num_hops}, {mod.max_peaks}]"
        plan = mod.plan
        ops = _overlap_f32_ops(plan, lanes, mod.num_hops)
        bound = _bound(_nbytes(g, plan.rho_period, plan.win_taps)
                       + _peak_bytes(lanes, mod.num_hops, mod.max_peaks),
                       f32_ops=ops)
        print(f"parity K2 overlap_peaks {shape}: max_abs_err={err:.6g} "
              f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound[0]:.4f} "
              f"unfused_floor_ms={_unfused_floor_ms(ops):.4f} "
              f"alloc_bytes={alloc}")
        report["overlap_peaks"].append(_row(err, ms, plain_ms, shape,
                                            bound))
        report["overlap_peaks"][-1]["unfused_floor_ms"] = \
            _unfused_floor_ms(ops)


def _fused_alloc(name: str, call, lanes: int, hops: int, k: int):
    """(call(), the bytes it allocated at its peak): a fused peak lattice
    writes no [lanes, hops, K] array, so its call stays below one f32 such
    array (its scratch, candidates and peaks)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - base
    if alloc >= 4 * lanes * hops * k:
        fail(f"{name} allocated {alloc} bytes, as much as a dense "
             f"[{lanes}, {hops}, {k}] f32 array")
    return out, alloc


def main_path(gw, iq_dev, singles, card: str):
    """Phase 4: feed the fixture twice, flush, check the decodes.  Returns
    (launches, the decoded {channel: {(sf, payload)}}, packet count)."""
    import torch

    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    channels, t = iq_dev.shape[0], iq_dev.shape[1]
    mods = {"rdft_peaks": [], "overlap_peaks": []}
    k1_by_sf = {}
    for sf in SFS:
        for m in gw.lattice(sf).modules():
            if isinstance(m, RdftPeaks):
                mods["rdft_peaks"].append(m)
                k1_by_sf.setdefault(sf, []).append(m)
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
    k1_launches = {sf: sum(m.launches for m in ms)
                   for sf, ms in k1_by_sf.items()}
    for i, pk in enumerate(feeds):
        got = _ok_pdus(pk)
        missing = [c for c in range(channels)
                   if not {(8, PDU1), (8, PDU2)} <= got.get(c, set())]
        if missing:
            fail(f"feed {i + 1}: golden PDUs missing on channels {missing}")
    every = _ok_pdus(feeds[0] + feeds[1] + tail)
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
          f"launches={launches} k1_launches_by_sf={k1_launches}")
    return launches, every, npk


def _dense_check(name, kern, plain, rtol):
    """Dense (fa, faw, hs) kernel vs plain: max |delta| <= rtol x the
    largest plain value (rtol 0: equal bit for bit).  Returns max |d|."""
    import torch

    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    scale = max(float(b.abs().max()) for b in plain)
    if rtol == 0.0:
        if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
            fail(f"{name} differs from its plain version (max |d| {err})")
    elif not err <= rtol * scale:
        fail(f"{name} differs from its plain version: max |d| {err} > "
             f"{rtol} x {scale}")
    return err


def parity_dense(cfg8, x8, cfg12, x12, report: dict) -> None:
    """Phase 3, dense kernels: K3, K4b, K6, K4 and K5 against their plain
    versions on one always-on block [16, 2048 hops] at SF8 (K5 also on
    the multi-SF gateway's SF12 block of 128 hops).  Each comparison
    frees its tensors before the next (the plain direct product alone is
    [32768, 16384] f32)."""
    import torch

    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
    from gr_lora_tpu_torch.ops.direct import DirectPeaks, DirectSpectra
    from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
    from gr_lora_tpu_torch.ops.peak_epilogue import peaks_plain
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

    dev = x8.device
    hops = AO_BLOCK_HOPS
    thr = float(cfg8.threshold)
    shape8 = (f"SF8 [{x8.shape[0]}, {x8.shape[1]}, 2] -> "
              f"[{x8.shape[0]}, {hops}, {cfg8.bin_size}]")
    lanes, k = x8.shape[0], cfg8.bin_size
    dense_out = 3 * 4 * lanes * hops * k          # fa, faw, hs f32
    # bf16 operations a frame, over what the function needs: K3 four
    # [n] x [2 (K + 1)] dots (bins 0..K; the TPU plan pads them to
    # K + 128), K4b one [2n] x [8K] product, K6 eight [R 2 hop] x [K]
    # products (its chunk rows' pad columns meet zero weights).
    for tag, name, cls, frame_ops in (
            ("K3", "rdft_spectra", RdftSpectra,
             lambda m: 16 * m.n * (m.k + 1)),
            ("K4b", "direct_spectra", DirectSpectra,
             lambda m: 32 * m.n * k),
            ("K6", "chunk_spectra", ChunkSpectra,
             lambda m: 2 * 8 * 8 * 2 * m.hop * k)):
        mod = cls(cfg8, hops).to(dev)
        kern = mod.kernel(x8)
        plain = mod.plain(x8)
        torch.cuda.synchronize()
        err = _dense_check(name, kern, plain, 1e-4)
        _, moved = _compare(peaks_plain(*kern, thr, 8),
                            peaks_plain(*plain, thr, 8), plain[1], 1e-3, thr)
        if tag == "K3":
            _time_topm(kern, thr)
        del kern, plain
        ms = _time_ms(lambda: mod.kernel(x8), 5)
        plain_ms = _time_ms(lambda: mod.plain(x8), 3)
        # The inputs the function needs: iq and the weights of one
        # version (the kernel's re-laid W holds the same values).
        consts = [b for nm, b in mod.named_buffers()
                  if nm not in ("w_tiles", "w_kernel")]
        bound = _bound(_nbytes(x8, *consts) + dense_out,
                       lanes * hops * frame_ops(mod))
        row = _row(err, ms, plain_ms, shape8, bound)
        # cuBLAS on the bare product (not the same function: no dechirp,
        # folds or recombination, a bf16 output) of the kernel's own bf16
        # operands.
        a, w = _product_operands(mod, x8)
        row["cublas_product_ms"] = _time_ms(lambda: torch.matmul(a, w), 5)
        extra = f" cublas_product_ms={row['cublas_product_ms']:.4f}"
        del a, w
        print(f"parity {tag} {name} {shape8}: max_abs_err={err:.6g} "
              f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound[0]:.4f}{extra}")
        report[name].append(row)
        del mod
        torch.cuda.empty_cache()

    mod = DirectPeaks(cfg8, hops, 8).to(dev)
    kern, k4_alloc = _fused_alloc("direct_peaks", lambda: mod(x8), lanes,
                                  hops, k)
    plain = mod.plain(x8)
    _, faw, _ = mod.front.plain(x8)
    torch.cuda.synchronize()
    err, moved = _compare(kern, plain, faw, 1e-3, thr)
    del kern, plain, faw
    ms = _time_ms(lambda: mod(x8), 5)
    plain_ms = _time_ms(lambda: mod.plain(x8), 3)
    shape = (f"SF8 [{x8.shape[0]}, {x8.shape[1]}, 2] -> "
             f"[{x8.shape[0]}, {hops}, 8]")
    bound = _bound(_nbytes(x8, mod.front.w) + _peak_bytes(lanes, hops, 8),
                   lanes * hops * 32 * mod.front.n * k)
    print(f"parity K4 direct_peaks {shape}: max_abs_err={err:.6g} "
          f"tie_peaks={moved} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound[0]:.4f} alloc_bytes={k4_alloc}")
    report["direct_peaks"].append(_row(err, ms, plain_ms, shape, bound))
    del mod
    torch.cuda.empty_cache()

    for cfg, x, nh in ((cfg8, x8, hops), (cfg12, x12, 128)):
        mod = OverlapSpectra(cfg, nh).to(dev)
        g = mod.plan.chunk_dft(x, nh)
        kern = mod.kernel(g)
        plain = mod.plain_from_chunks(g)
        torch.cuda.synchronize()
        # K5 rounds every operation as its plain version does: exact.
        err = _dense_check("overlap_spectra", kern, plain, 0.0)
        del kern, plain
        ms = _time_ms(lambda: mod.kernel(g), 5)
        plain_ms = _time_ms(lambda: mod.plain_from_chunks(g), 3)
        fft_ms = _time_ms(lambda: mod.plan.chunk_dft(x, nh), 5)
        shape = (f"SF{cfg.sf} G [{g.shape[0]}, {g.shape[1]}, {g.shape[2]}, "
                 f"2] -> [{g.shape[0]}, {nh}, {cfg.bin_size}]")
        plan = mod.plan
        ops = _overlap_f32_ops(plan, g.shape[0], nh)
        bound = _bound(_nbytes(g, plan.rho_period, plan.win_taps)
                       + 3 * 4 * g.shape[0] * nh * cfg.bin_size,
                       f32_ops=ops)
        print(f"parity K5 overlap_spectra {shape}: max_abs_err={err:.6g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"chunk_dft_ms={fft_ms:.4f} bound_ms={bound[0]:.4f} "
              f"unfused_floor_ms={_unfused_floor_ms(ops):.4f}")
        report["overlap_spectra"].append(_row(err, ms, plain_ms, shape,
                                              bound))
        report["overlap_spectra"][-1]["unfused_floor_ms"] = \
            _unfused_floor_ms(ops)
        del mod, g
        torch.cuda.empty_cache()


def _time_topm(spectra, threshold: float) -> None:
    """peak_topm's two instances on one block of dense spectra: M = 8 (the
    main path's register list) and M = 32 (the refilling instance)."""
    from gr_lora_tpu_torch.ops.peak_epilogue import launch_topm

    fa, faw, hs = spectra
    k = faw.shape[-1]
    ms = {m: _time_ms(lambda m=m: launch_topm(fa, faw, hs, threshold, m), 5)
          for m in (8, 32)}
    bound = _bound(_nbytes(fa, faw, hs))
    print(f"parity peak_topm [{faw.numel() // k} rows, {k}] (K3's spectra): "
          f"M8_ms={ms[8]:.4f} M32_ms={ms[32]:.4f} bound_ms={bound[0]:.4f}")


def _product_operands(mod, x):
    """(A, W) bf16 of a dense module's tensor-core product as its kernel
    runs it: K3 its A tiles (plain and windowed rows) and re-laid W, K4b
    the frame matrix [Re x | Im x] and W, K6 the frames' chunk rows (the
    pad columns dropped) and its re-laid W."""
    import torch

    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra, live_width
    from gr_lora_tpu_torch.ops.dechirp import frame_signal
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra, frame_tiles

    if isinstance(mod, RdftSpectra):
        a = frame_tiles(x, mod.consts, mod.n, mod.hop, mod.num_frames)
        return a.reshape(-1, a.shape[-1]), mod.w_tiles
    if isinstance(mod, ChunkSpectra):
        lw = live_width(mod.hop)
        fr = mod.chunks(x).unfold(-2, 8, 1).transpose(-1, -2)[..., :lw]
        return (fr.reshape(-1, 8 * lw).to(torch.bfloat16).contiguous(),
                mod.w_kernel)
    fr = frame_signal(x, mod.n, mod.hop, mod.num_frames)
    return (torch.cat([fr[..., 0], fr[..., 1]], dim=-1)
            .to(torch.bfloat16).reshape(-1, 2 * mod.n), mod.w)


def _packet_lanes(cfg, lanes: int, seed: int, dev):
    """[lanes, T, 2] on the card: noise 0.01 from default_rng(seed) and
    one packet a lane at a lane-specific offset; and its hop count."""
    import torch

    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.models.pyramid import num_hops_for
    from gr_lora_tpu_torch.ops.cplx import to_ri

    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    total = len(pkt) + 6 * n
    rng = np.random.default_rng(seed)
    iq = (0.01 * (rng.standard_normal((lanes, total))
                  + 1j * rng.standard_normal((lanes, total)))
          ).astype(np.complex64)
    for i in range(lanes):
        iq[i, n + 37 * i:n + 37 * i + len(pkt)] += pkt
    return torch.from_numpy(to_ri(iq)).to(dev), num_hops_for(cfg, total)


def _plain_spectra(front, x):
    """A dense front end's plain (fa, faw, hs) of iq ``x``."""
    from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra

    if isinstance(front, OverlapSpectra):
        return front.plain_from_chunks(front.plan.chunk_dft(x, front.num_hops))
    return front.plain(x)


def parity_extra(cfg8, dev) -> None:
    """Phase 3, the shapes beyond the main path, on 3 lanes of one packet
    each: K5 and K2 at SF7 x fft_factor 16 (bit for bit), every kernel
    backend's lattice at M = 32 (the plain peaks up to f32 ties), K3, K1
    and K6 at SF7 p 1, K3 and K1 on a ragged frame count."""
    import torch

    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn
    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.peak_epilogue import peaks_plain
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

    def cfg_of(sf, ff, p=2):
        return cfg8.replace(sf=sf, fft_factor=ff, p=p, payload_len=4)

    cfg = cfg_of(7, 16)
    x, nh = _packet_lanes(cfg, 3, 7, dev)
    mod = OverlapPeaks(cfg, nh, 8).to(dev)
    g = mod.plan.chunk_dft(x, nh)
    _dense_check("overlap_spectra SF7 ff16", mod.front.kernel(g),
                 mod.front.plain_from_chunks(g), 0.0)
    kern, plain = mod.from_chunks(g), mod.plain_from_chunks(g)
    if not (bool(plain[3].any())
            and all(torch.equal(a, b) for a, b in zip(kern, plain))):
        fail("overlap_peaks SF7 ff16 differs from its plain version")
    # The 4-column ring instances (ff 16): K5's and K2's fused one.
    k5_ms = _time_ms(lambda: mod.front.kernel(g), 5)
    k2_ms = _time_ms(lambda: mod.from_chunks(g), 5)
    print(f"parity-extra K5, K2 SF7 ff16 G {list(g.shape)}: equal bit for "
          f"bit; K5 ms={k5_ms:.4f} K2 ms={k2_ms:.4f}")
    del g

    thr = float(cfg8.threshold)
    x, nh = _packet_lanes(cfg8, 3, 8, dev)
    for backend in ("rdft", "direct", "fused_direct", "fastp", "pallas",
                    "fused"):
        lat = peak_lattice_fn(cfg8, nh, 32, backend).to(dev)
        kern = lat(x)
        sp = _plain_spectra(lat.front, x)
        plain = peaks_plain(*sp, thr, 32)
        if kern[0].shape != plain[0].shape or not bool(plain[3].any()):
            fail(f"{backend} at M = 32: peaks {tuple(kern[0].shape)}")
        err, ties = _compare(kern, plain, sp[1], 1e-3, thr)
        # M = 32 is above the fused searches' 16: K1, K2 and K4 run their
        # dense front end and peak_topm, counted as the front's launch.
        fused = getattr(lat, "launches", 0)
        print(f"parity-extra {backend} ({type(lat).__name__}) SF8 M=32: "
              f"max_abs_err={err:.6g} tie_peaks={ties} "
              f"fused_launches={fused} front_launches={lat.front.launches}")

    cfg = cfg_of(7, 8, 1)
    x, nh = _packet_lanes(cfg, 3, 9, dev)
    for cls in (RdftSpectra, ChunkSpectra):
        mod = cls(cfg, nh).to(dev)
        err = _dense_check(f"{cls.__name__} SF7 p1", mod.kernel(x),
                           mod.plain(x), 1e-4)
        print(f"parity-extra {cls.__name__} SF7 p1 (hop 16) "
              f"[{x.shape[0]}, {nh}, {cfg.bin_size}]: max_abs_err={err:.6g}")
    mod = RdftPeaks(cfg, nh, 8).to(dev)
    sp = mod.front.plain(x)
    err, ties = _compare(mod(x), mod.plain(x), sp[1], 1e-3, thr)
    print(f"parity-extra RdftPeaks SF7 p1: max_abs_err={err:.6g} "
          f"tie_peaks={ties}")

    x, nh = _packet_lanes(cfg8, 2, 10, dev)
    x = x[:, :x.shape[1] - 37]
    nh += 41
    mod = RdftPeaks(cfg8, nh, 8).to(dev)
    sp = mod.front.plain(x)
    err = _dense_check("rdft_spectra ragged", mod.front.kernel(x), sp, 1e-4)
    _, ties = _compare(mod(x), mod.plain(x), sp[1], 1e-3, thr)
    print(f"parity-extra RdftSpectra, RdftPeaks SF8 ragged [{x.shape[0]}, "
          f"{nh} hops] from T={x.shape[1]}: max_abs_err={err:.6g} "
          f"tie_peaks={ties}")
    torch.cuda.empty_cache()


def _kernel_modules(module, name: str) -> list:
    """The submodules whose ``launches`` count kernel ``name``."""
    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
    from gr_lora_tpu_torch.ops.direct import DirectPeaks, DirectSpectra
    from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

    cls = {"rdft_spectra": RdftSpectra, "direct_spectra": DirectSpectra,
           "direct_peaks": DirectPeaks, "overlap_spectra": OverlapSpectra,
           "chunk_spectra": ChunkSpectra}[name]
    return [m for m in module.modules() if type(m) is cls]


def always_on(cfg, iq, dev, card: str, launches: dict) -> None:
    """Phase 5: the always-on gateway once per kernel backend: two passes
    of the fixture in AO_CHUNK chunks (numpy, as bench.py feeds it), then
    a flush; both golden PDUs must decode on every channel for each of
    the fixture's two collisions in each pass."""
    import torch

    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway

    channels, t = iq.shape[0], iq.shape[1]
    for backend, name in AO_BACKENDS.items():
        gw = PyramidGateway(cfg, channels, block_hops=AO_BLOCK_HOPS,
                            max_peaks=8, backend=backend, device=dev)
        mods = _kernel_modules(gw.lattice, name)
        for m in mods:
            m.launches = 0
        gw.wall_reset()
        pkts, secs, walls = [], [], []
        for _ in range(2):
            t0 = time.perf_counter()
            for lo in range(0, t, AO_CHUNK):
                pkts += gw.feed(iq[:, lo:lo + AO_CHUNK])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            walls.append(gw.wall_reset())
        pkts += gw.flush()
        torch.cuda.synchronize()
        count = sum(m.launches for m in mods)
        launches[name] = launches.get(name, 0) + count
        if count <= 0:
            fail(f"always-on {backend}: kernel {name} was not launched")
        for c in range(channels):
            pdus = [bytes(p.result.payload).hex() for p in pkts
                    if p.channel == c and p.result is not None
                    and p.result.ok and p.result.crc_ok]
            if pdus.count(PDU1) != 4 or pdus.count(PDU2) != 4:
                fail(f"always-on {backend}: channel {c} decoded {pdus}, "
                     "want each golden PDU 4 times")
        w = walls[1]
        sps = channels * t / secs[1]
        print(f"main always-on backend={backend} {channels}ch SF{cfg.sf} "
              f"block_hops={AO_BLOCK_HOPS} T={t} x2 passes + flush on "
              f"{card}: packets={len(pkts)} pass_s=[{secs[0]:.4f}, "
              f"{secs[1]:.4f}] pass2_wall[dispatch={w['dispatch']:.4f} "
              f"fetch={w['fetch']:.4f} tracker={w['tracker']:.4f} "
              f"decode={w['decode']:.4f}] pass2_samples_per_s={sps:.1f} "
              f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
              f"launches={{'{name}': {count}}}")
        del gw
        torch.cuda.empty_cache()


def multi_sf(base, iq, singles, dev, card: str, launches: dict) -> None:
    """Phase 6: MultiSFPyramidGateway, backend "fastp", 16 ch x SF7-12,
    bench.py's per-SF block_hops; the golden PDUs and every single must
    decode."""
    import torch

    from gr_lora_tpu_torch.dist.pyramid_gateway import MultiSFPyramidGateway

    channels, t = iq.shape[0], iq.shape[1]
    bh = {sf: max(64, AO_BLOCK_HOPS * 256 // (1 << sf)) for sf in SFS}
    gw = MultiSFPyramidGateway(base, channels, sfs=SFS, block_hops=bh,
                               max_peaks=8, backend="fastp", device=dev)
    mods = [m for g in gw.gws.values()
            for m in _kernel_modules(g.lattice, "overlap_spectra")]
    for m in mods:
        m.launches = 0
    gw.wall_reset()
    t0 = time.perf_counter()
    pkts = gw.feed(iq)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    w = gw.wall_reset()
    pkts += gw.flush()
    torch.cuda.synchronize()
    count = sum(m.launches for m in mods)
    launches["overlap_spectra"] = launches.get("overlap_spectra", 0) + count
    if count <= 0:
        fail("multi-SF: kernel overlap_spectra was not launched")
    got = _ok_pdus(pkts)
    missing = [c for c in range(channels)
               if not {(8, PDU1), (8, PDU2)} <= got.get(c, set())]
    lost = [c for c, (hx, _) in singles.items()
            if not any(sf == SFS[c % len(SFS)] and hx in h
                       for sf, h in got.get(c, set()))]
    if missing or lost:
        fail(f"multi-SF: golden PDUs missing on channels {missing}, "
             f"singles lost on channels {lost}")
    sps = channels * t / feed_s
    print(f"main multi-SF backend=fastp {channels}ch x SF7-12 T={t} "
          f"block_hops={bh} feed + flush on {card}: packets={len(pkts)} "
          f"feed_s={feed_s:.4f} feed_wall[dispatch={w['dispatch']:.4f} "
          f"fetch={w['fetch']:.4f} tracker={w['tracker']:.4f} "
          f"decode={w['decode']:.4f}] feed_samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"launches={{'overlap_spectra': {count}}}")


def probes(dev, card: str, report: dict, launches: dict) -> None:
    """Phase 7: P1 and P2 at the main path's dot shape.  Each is checked
    against its plain version (those launches are not counted), then the
    probe phase proper runs with the counts set to 0 just before it."""
    import torch

    from gr_lora_tpu_torch.ops.probes import (MAIN_SHAPE, OverlapProbe,
                                              RateProbe, probe_inputs)

    rows, depth, width = MAIN_SHAPE
    x, w, v0 = (t.to(dev) for t in probe_inputs(rows, depth, width))
    shape = f"[{rows}, {depth}] @ [{depth}, {width}] bf16"
    p1 = RateProbe()
    err1 = 0.0
    # The whole last-step scratch (all four slabs) and the value, at the
    # main shape and at one other: another summation order of bf16
    # products, rtol 1e-3.
    for shp in (MAIN_SHAPE, (128, 256, 1024)):
        xs, ws, _ = (t.to(dev) for t in probe_inputs(*shp))
        (got, scratch), (ref, ref_scratch) = p1.kernel(xs, ws), \
            p1.plain(xs, ws)
        torch.cuda.synchronize()
        for name, a, b in (("scratch", scratch, ref_scratch),
                           ("value", got, ref)):
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
                fail(f"rate_probe {shp}: its {name} differs from the plain "
                     f"version's (max |d| {float((a - b).abs().max())})")
        err1 = max(err1, float((scratch - ref_scratch).abs().max()),
                   float((got - ref).abs().max()))
        del xs, ws, scratch, ref_scratch
    kinds = ("mxu", "vpu", "both")
    err2 = 0.0
    for kind in kinds:
        # 4 and 6 steps (136 and 204 units: blocks with one and two units,
        # the rounds paced over their stages): the chain's values stay
        # finite, so the slabs compare bit for bit.  64 steps (the timed
        # probe): it overflows to inf after some 15 rounds and then to NaN,
        # as on the TPU, so only the NaN masks (and the product) compare.
        for steps in (4, 6, 64):
            probe = OverlapProbe(kind, steps=steps)
            out, acc, vs = probe.kernel(x[0], w, v0)
            r_out, r_acc, r_vs = probe.plain(x[0], w, v0)
            torch.cuda.synchronize()
            nan = torch.isnan(vs)
            if not (torch.equal(nan, torch.isnan(r_vs))
                    and torch.equal(vs[~nan], r_vs[~nan])
                    and (steps == 64 or bool(torch.isfinite(vs).all()))):
                fail(f"overlap_probe {kind} x{steps} steps: its chain slab "
                     "differs from the plain version's")
            if acc is not None and not torch.allclose(acc, r_acc, rtol=1e-3,
                                                      atol=1e-3):
                fail(f"overlap_probe {kind}: its product differs from the "
                     "plain version's")
            if not torch.allclose(out, r_out, rtol=1e-3, atol=1e-3,
                                  equal_nan=True):
                fail(f"overlap_probe {kind} x{steps} steps: {float(out)} vs "
                     f"plain {float(r_out)}")
            if steps < 64:
                err2 = max(err2, float((out - r_out).abs().max()),
                           float((acc - r_acc).abs().max())
                           if acc is not None else 0.0)
    p2 = {kind: OverlapProbe(kind) for kind in kinds}
    p1_plain_ms = _time_ms(lambda: p1.plain(x, w), 3)
    p2_plain_ms = _time_ms(lambda: p2["both"].plain(x[0], w, v0), 1)

    p1.launches = 0
    for pr in p2.values():
        pr.launches = 0
    ms1 = _time_ms(lambda: p1(x, w), 20)
    # The yardstick: cuBLAS through torch.matmul on the same bf16
    # operands, for the same products (16 steps of 4).
    lib_ms = _time_ms(lambda: [torch.matmul(x, w) for _ in range(p1.steps)],
                      5)
    walls = {kind: _time_ms(lambda pr=pr: pr(x[0], w, v0), 20)
             for kind, pr in p2.items()}
    # The chain alone over 4 steps, where every value stays finite: its
    # rate a round beside the 64 steps', whose rounds run mostly on inf
    # and NaN.  Not part of the counted run.
    short = OverlapProbe("vpu", steps=4)
    vpu4_ms = _time_ms(lambda: short.kernel(x[0], w, v0), 20)
    launches["rate_probe"] = p1.launches
    launches["overlap_probe"] = sum(pr.launches for pr in p2.values())
    if p1.launches <= 0 or any(pr.launches <= 0 for pr in p2.values()):
        fail("probes: a probe kernel was not launched")

    fl1 = p1.flops(x, w)
    tf, lib_tf = fl1 / ms1 / 1e9, fl1 / lib_ms / 1e9
    bound1 = _bound(_nbytes(x, w) + 4, fl1)
    print(f"probe P1 rate_probe {shape} x4 x{p1.steps} steps on {card}: "
          f"ms={ms1:.4f} tflops={tf:.1f} torch.matmul_ms={lib_ms:.4f} "
          f"torch.matmul_tflops={lib_tf:.1f} plain_ms={p1_plain_ms:.4f} "
          f"bound_ms={bound1[0]:.4f} max_abs_err={err1:.6g} "
          f"launches={p1.launches}")
    report["rate_probe"].append(_row(err1, ms1, p1_plain_ms, shape, bound1,
                                     lib_ms))
    steps = p2["both"].steps
    for kind in kinds:
        print(f"probe P2 overlap_probe {kind}: {walls[kind]:.3f} ms/call "
              f"({walls[kind] / steps * 1e3:.2f} us/step)")
    rounds = p2["vpu"].rounds
    print(f"probe P2 overlap_probe vpu x{short.steps} steps (finite): "
          f"{vpu4_ms:.4f} ms/call ({vpu4_ms / (short.steps * rounds) * 1e3:.3f}"
          f" us/round; x{steps} steps: "
          f"{walls['vpu'] / (steps * rounds) * 1e3:.3f} us/round) on {card}")
    s_ms = walls["mxu"] + walls["vpu"]
    m_ms = max(walls["mxu"], walls["vpu"])
    b_ms = walls["both"]
    eff = (s_ms - b_ms) / max(s_ms - m_ms, 1e-12)
    print(f"probe P2 serial-sum={s_ms:.3f} ms  max={m_ms:.3f} ms  "
          f"both={b_ms:.3f} ms  -> overlap_efficiency={eff:.0%} "
          f"(100%=full dual-issue, 0%=serialized) on {card} "
          f"launches={launches['overlap_probe']}")
    chain_ops = steps * p2["both"].rounds * v0.numel() * 18
    bound2 = _bound(_nbytes(x[0], w, v0) + 4,
                    steps * 2 * rows * depth * width, chain_ops)
    report["overlap_probe"].append(_row(
        err2, b_ms, p2_plain_ms, f"both: {shape} x{steps} steps + f32 chain "
        f"[{rows}, {v0.shape[1]}] x{steps * p2['both'].rounds} rounds",
        bound2))


def envelope_grid(cfg):
    """bench.py --mode collision's grid (:1130-1160): the strong packet
    (amplitude 0.2) at sample 1000, the weak one (0.2 ratio) at 16
    sub-symbol phases of a 16-symbol overlap (+13 samples), 2 hop-aligned
    points and 4 depths (+204), times ratios {0.45, 0.3, 0.2}: 66 points
    in one fixed buffer length.  Returns ([(ratio, weak offset)], strong
    and weak packet IQ, the buffer length)."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate

    n = cfg.num_samples
    p1 = modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                  pad_front=0, pad_back=0)
    p2 = modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                  pad_back=0)
    phases = [16 * n + (i * n) // 16 + 13 for i in range(16)]
    aligned = [16 * n, 16 * n + n // 8]
    depths = [d + 204 for d in (8 * n, 12 * n, 16 * n, 20 * n)]
    offs = phases + aligned + depths
    total = max(offs) + 1000 + len(p2) + 12 * n
    points = [(r, 1000 + o) for r in (0.45, 0.3, 0.2) for o in offs]
    return points, p1, p2, total


def _tier(run, cfg, points, p1, p2, total):
    """(both-packet count, strong-packet count, failed points) of one
    decoder tier over the envelope grid."""
    from gr_lora_tpu_torch.core.codec import decode

    both = strong = 0
    failed = []
    for ratio, off2 in points:
        iq = np.zeros(total, np.complex64)
        iq[1000:1000 + len(p1)] += (0.2 * p1).astype(np.complex64)
        iq[off2:off2 + len(p2)] += (0.2 * ratio * p2).astype(np.complex64)
        pdus = {bytes(r.payload).hex() for r in
                (decode(s, cfg) for s in run(iq)) if r.ok}
        strong += PDU1 in pdus
        both += PDU1 in pdus and PDU2 in pdus
        if not {PDU1, PDU2} <= pdus:
            failed.append((ratio, off2))
    return both, strong, failed


def sic_envelope(cfg, dev, card: str, launches: dict) -> None:
    """Phase 8a: the collision-recovery envelope through the port on the
    card: pyramid_demodulate at grace 0 and 8 and sic_demodulate(grace=8)
    at backend "xla" (bench.py's tiers), then SIC at "fused", whose dense
    passes run K1 (SF8).  SIC must recover both packets, and the strong
    one, at all 66 points at either backend."""
    from gr_lora_tpu_torch.models import sic
    from gr_lora_tpu_torch.models.pyramid import (num_hops_for,
                                                  pyramid_demodulate)
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    points, p1, p2, total = envelope_grid(cfg)
    k1 = [m for m in sic.lattice(cfg, num_hops_for(cfg, total), 16, "fused",
                                 None, dev).modules()
          if isinstance(m, RdftPeaks)]
    tiers = {
        "grace0": lambda iq: pyramid_demodulate(iq, cfg, grace=0,
                                                device=dev),
        "grace8": lambda iq: pyramid_demodulate(iq, cfg, grace=8,
                                                device=dev),
        "sic": lambda iq: sic.sic_symbol_streams(iq, cfg, grace=8,
                                                 device=dev),
        "sic_fused": lambda iq: sic.sic_symbol_streams(
            iq, cfg, grace=8, backend="fused", device=dev),
    }
    counts, k1_count = {}, 0
    for name, run in tiers.items():
        for m in k1:
            m.launches = 0
        t0 = time.perf_counter()
        counts[name] = _tier(run, cfg, points, p1, p2, total)
        secs = time.perf_counter() - t0
        both, strong, failed = counts[name]
        line = (f"sic envelope tier={name} SF{cfg.sf} p={cfg.p} "
                f"ff={cfg.fft_factor} on {card}: both={both}/{len(points)} "
                f"strong={strong}/{len(points)} s={secs:.2f}")
        if name == "sic_fused":
            k1_count = sum(m.launches for m in k1)
            line += f" k1_launches={k1_count}"
        if failed and name.startswith("sic"):
            line += f" failed={failed}"
        print(line)
    for name in ("sic", "sic_fused"):
        both, strong, failed = counts[name]
        if both != len(points) or strong != len(points):
            fail(f"SIC tier {name} recovered both packets at {both} and "
                 f"the strong one at {strong} of {len(points)} points; "
                 f"failed at (ratio, offset) {failed}")
    if k1_count <= 0:
        fail("SIC at backend fused launched no K1 in its dense passes")
    launches["rdft_peaks"] += k1_count


def sic_python_tracker(cfg, dev) -> None:
    """Phase 8b: the README golden collision through pyramid_demodulate
    on the card with the Python tracker and the native one: the same
    symbol streams."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.models.pyramid import pyramid_demodulate

    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg)
    off2 = 1000 + 16 * n + 4 * n // 8 + 204
    iq = np.zeros(off2 + len(p2) + 1000, np.complex64)
    iq[1000:1000 + len(p1)] += p1
    iq[off2:off2 + len(p2)] += p2
    py = pyramid_demodulate(iq, cfg, backend="fused", use_native=False,
                            device=dev)
    nat = pyramid_demodulate(iq, cfg, backend="fused", use_native=True,
                             device=dev)
    if len(py) != len(nat) or len(py) < 2 or not all(
            np.array_equal(a, b) for a, b in zip(py, nat)):
        fail(f"Python tracker gave {len(py)} streams, native {len(nat)}, "
             "or they differ")
    print(f"sic python tracker: {len(py)} symbol streams equal to the "
          "native tracker's (golden collision, fused)")


def sic_north_star(iq, singles, ns_pdus: dict, ns_packets: int, dev,
                   card: str, launches: dict) -> None:
    """Phase 8c: phase 4's north star (64 channels x SF7-12, fused, host
    tracker, 2 feeds + flush) with ``sic=True`` at the default gate:
    every golden PDU and single on every channel, every PDU phase 4
    decoded, SIC windows run.  Prints the SIC wall, windows, ms a window,
    the packets beside phase 4's and the K1 / K2 launches of SIC's own
    dense passes (its lattices, separate from the gateway's)."""
    import torch

    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.models import sic
    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    gw = TriggeredPyramidGateway(base_config(), CHANNELS, sfs=SFS,
                                 max_payload_len=16, backend="fused",
                                 tracker="host", sic=True, device=dev)
    kinds = {"rdft_peaks": RdftPeaks, "overlap_peaks": OverlapPeaks}

    def kernels(modules):
        return {name: [m for mod in modules for m in mod.modules()
                       if isinstance(m, cls)] for name, cls in kinds.items()}

    own = kernels([gw.lattice(sf) for sf in SFS])
    in_sic = kernels([sic.lattice(st.cfg, st.win_hops, gw.max_peaks,
                                  gw.backend, gw._lattice_block_hops(st), dev)
                      for st in gw.sf_states.values()])
    for ms in (*own.values(), *in_sic.values()):
        for m in ms:
            m.launches = 0
    iq_dev = torch.from_numpy(iq).to(dev)
    gw.wall_reset()
    feeds, walls = [], []
    t0 = time.perf_counter()
    for _ in range(2):
        feeds.append(gw.feed(iq_dev))
        walls.append(gw.wall_reset())
    tail = gw.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    walls.append(gw.wall_reset())
    counts = {name: sum(m.launches for m in ms) for name, ms in own.items()}
    sic_counts = {name: sum(m.launches for m in ms)
                  for name, ms in in_sic.items()}
    for name, count in counts.items():
        if count <= 0:
            fail(f"SIC north star: kernel {name} was not launched")
        launches[name] += count + sic_counts[name]
    for i, pk in enumerate(feeds):
        got = _ok_pdus(pk)
        missing = [c for c in range(CHANNELS)
                   if not {(8, PDU1), (8, PDU2)} <= got.get(c, set())]
        if missing:
            fail(f"SIC feed {i + 1}: golden PDUs missing on channels "
                 f"{missing}")
    every = _ok_pdus(feeds[0] + feeds[1] + tail)
    lost = [c for c, (hx, _) in singles.items()
            if not any(sf == SFS[c % len(SFS)] and hx in h
                       for sf, h in every.get(c, set()))]
    if lost:
        fail(f"SIC: singles not decoded on channels {lost}")
    dropped = {c: sorted(p - every.get(c, set()))
               for c, p in ns_pdus.items() if p - every.get(c, set())}
    if dropped:
        fail(f"SIC lost PDUs phase 4 decoded: {dropped}")
    sic_s = sum(w["sic"] for w in walls)
    if gw.sic_windows <= 0 or sic_s <= 0:
        fail(f"SIC ran on {gw.sic_windows} windows in {sic_s} s")
    npk = sum(len(f) for f in feeds) + len(tail)
    print(f"sic north-star {CHANNELS}ch x SF7-12 T={iq.shape[1]} x2 feeds "
          f"+ flush sic=True sic_gate=0.02 on {card}: "
          f"sic_windows={gw.sic_windows} wall_sic={sic_s:.4f} "
          f"ms_per_window={1e3 * sic_s / gw.sic_windows:.3f} "
          f"packets={npk} (phase 4: {ns_packets}) total_s={secs:.4f} "
          f"gateway_launches={counts} sic_dense_launches={sic_counts}")
    del gw, iq_dev
    torch.cuda.empty_cache()


#: Phase 9 (a): bench.py --mode gateway's fixture at BASELINE's 64 channels.
FSM_CHANNELS = 64
FSM_SYMBOLS = 1024
FSM_PAYLOAD = bytes(range(1, 7))
FSM_TIMED = 3
#: Phase 9 (e): bench.py --mode per's weak point at SF8, and the loopback.
WEAK_TRIALS = 64
WEAK_SNR_DB = -4.0
LOOPBACK_PAYLOAD = bytes((3 * i + 1) % 256 for i in range(12))


def fsm_config():
    """bench.py --mode gateway's operating point: SF8, cr 1, CRC, implicit
    header, payload_len 6, p 2, fft_factor 2."""
    from gr_lora_tpu_torch import LoraConfig

    return LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=False,
                      payload_len=6, p=2, fft_factor=2)


def fsm_gateway_fixture(cfg, channels: int = FSM_CHANNELS):
    """bench.py's bench_gateway fixture: noise 0.05 from default_rng(0),
    then one packet a channel at an offset drawn from the same generator.
    Returns (iq float32 [C, 1024 n, 2], offsets, packet length)."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    total = FSM_SYMBOLS * cfg.num_samples
    rng = np.random.default_rng(0)
    pkt = to_ri(modulate(encode(FSM_PAYLOAD, cfg), cfg, pad_front=0,
                         pad_back=0))
    iq = rng.normal(0.0, 0.05, (channels, total, 2)).astype(np.float32)
    offs = []
    for c in range(channels):
        off = int(rng.integers(0, max(total - len(pkt), 1)))
        iq[c, off:off + len(pkt)] += pkt
        offs.append(off)
    return iq, offs, len(pkt)


#: Device-time classes of the FSM step's kernels (by kernel name).
_KINDS = (("cuFFT", ("fft",)), ("gather", ("gather",)),
          ("reduce", ("reduce", "argmax")), ("scan", ("scan",)),
          ("copy", ("memcpy", "memset", "copy")))


def _kind(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in _KINDS
                 if any(k in low for k in keys)), "elementwise")


def _device_time(prof) -> tuple[float, int, dict]:
    """(busy ms: the union of the device-side intervals, the number of
    device-side records, {kind: ms} by _KINDS) of ``prof``, read from its
    raw trace: a replayed pass records millions of kernels, too many to
    parse into profiler events."""
    from torch.autograd import DeviceType

    starts, ends, kinds, by_kind = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        lo, dur, name = e.start_ns(), e.duration_ns(), e.name()
        starts.append(lo)
        ends.append(lo + dur)
        kind = kinds.get(name) or kinds.setdefault(name, _kind(name))
        by_kind[kind] = by_kind.get(kind, 0) + dur
    if not starts:
        return 0.0, 0, {}
    order = np.argsort(starts, kind="stable")
    lo = np.asarray(starts, np.float64)[order]
    hi = np.asarray(ends, np.float64)[order]
    reach = np.concatenate([[-np.inf], np.maximum.accumulate(hi)[:-1]])
    busy = float(np.clip(hi - np.maximum(lo, reach), 0, None).sum())
    split = dict(sorted(((k, v / 1e6) for k, v in by_kind.items()),
                        key=lambda kv: -kv[1]))
    return busy / 1e6, len(starts), split


def _profiled_pass(run) -> tuple[float, float, dict, float]:
    """(wall s, device busy ms, device ms by kind, seconds the profiler
    took to stop and be read) of one ``run()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
    busy, _, split = _device_time(prof)
    return wall, busy, split, time.perf_counter() - t0


def _split_txt(split: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items())


def _lane_packets(outs, lane: int) -> list:
    """[(position, symbols list)] of one lane of demod_fn's outputs."""
    syms, lens, pos, cnt, _, _ = outs
    return [(int(pos[lane, r]), syms[lane, r, :lens[lane, r]].tolist())
            for r in range(int(cnt[lane]))]


def fsm_gateway(cfg, dev, card: str):
    """Phase 9a: demod_fn batched over 64 channels of bench.py --mode
    gateway's fixture.  Every channel's payload must decode byte-exact
    with its CRC.  Prints samples/s over FSM_TIMED replayed passes, the
    steps a pass, ms a step replayed and eager, launches a step, and a
    profiled pass's busy and idle shares.  Returns (iq, offsets, packet
    length, channel 0's packets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gr_lora_tpu_torch.core.codec import decode
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from gr_lora_tpu_torch.models.fsm_loop import STEPS

    iq, offs, plen = fsm_gateway_fixture(cfg)
    channels, total = iq.shape[0], iq.shape[1]
    x = torch.from_numpy(iq).to(dev)
    fn = demod_fn(cfg, total, 4, device=dev)
    t0 = time.perf_counter()
    outs = fn(x)                       # builds and captures the graph
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    host = [o.cpu().numpy() for o in outs]
    bad = []
    for c in range(channels):
        ok = False
        for _, syms in _lane_packets(host, c):
            res = decode(np.asarray(syms, np.uint16), cfg)
            ok |= bool(res.ok and res.crc_ok
                       and bytes(res.payload[:len(FSM_PAYLOAD)])
                       == FSM_PAYLOAD)
        if not ok:
            bad.append(c)
    if bad:
        fail(f"FSM gateway: payload not decoded on channels {bad}")
    secs = []
    for _ in range(FSM_TIMED):
        t0 = time.perf_counter()
        again = fn(x)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if not all(torch.equal(a, b) for a, b in zip(again, outs)):
        fail("FSM gateway: a replayed pass differs from the first")
    steps = fn.loops[channels].steps
    eager = fn.make_loop(channels, graphed=False)
    t0 = time.perf_counter()
    eouts = fn.run(eager, x)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(eouts, outs)):
        fail("FSM gateway: the eager steps differ from the replayed graph")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eager._steps()
        torch.cuda.synchronize()
    _, records, _ = _device_time(prof)
    wall, busy, split, prof_cost = _profiled_pass(lambda: fn(x))
    sps = channels * total * FSM_TIMED / sum(secs)
    best = min(secs)
    print(f"fsm gateway {channels}ch SF8 implicit p2 ff2 T={total} "
          f"({FSM_SYMBOLS} symbols) max_packets=4 on {card}: decoded={channels}/"
          f"{channels} first_pass_s={first_s:.4f} (capture included) "
          f"pass_s={[round(s, 4) for s in secs]} samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"steps_per_pass={steps} steps_per_check={STEPS} "
          f"ms_per_step_replayed={1e3 * best / steps:.4f} "
          f"eager_pass_s={eager_s:.4f} "
          f"ms_per_step_eager={1e3 * eager_s / steps:.4f} "
          f"launches_per_step={records / STEPS:.1f} (device records of "
          f"{STEPS} eager steps) profiled_pass_s={wall:.4f} "
          f"device_busy_ms={busy:.2f} idle={1 - busy / (1e3 * wall):.3f} "
          f"busy_of_timed_pass={busy / (1e3 * best):.3f} "
          f"device_ms[{_split_txt(split)}] profiler_read_s={prof_cost:.1f}")
    return iq, offs, plen, _lane_packets(host, 0)


def fsm_streaming(cfg, iq, offs, plen: int, ref: list, dev,
                  card: str) -> None:
    """Phase 9d: StreamingDemodulator on phase 9a's channel 0 in
    AO_CHUNK-sample chunks, pipelined off and on, must return 9a's
    packets for that lane; a checkpoint taken mid-packet and loaded into
    a fresh streamer must continue to the same packets."""
    from gr_lora_tpu_torch.models.demodulator import StreamingDemodulator

    lane = iq[0]

    def feed(sd, x):
        got = []
        for lo in range(0, x.shape[0], AO_CHUNK):
            got += sd.feed(x[lo:lo + AO_CHUNK])
        return got

    walls = {}
    for pipelined in (False, True):
        sd = StreamingDemodulator(cfg, pipelined=pipelined, device=dev)
        t0 = time.perf_counter()
        got = feed(sd, lane) + sd.flush()
        walls[pipelined] = time.perf_counter() - t0
        got = [(p, s.tolist()) for p, s in got]
        if got != ref:
            fail(f"FSM streaming (pipelined={pipelined}): {got} != {ref}")
    cut = offs[0] + plen // 2
    first = StreamingDemodulator(cfg, device=dev)
    before = feed(first, lane[:cut])
    state = first.state_dict()
    resumed = StreamingDemodulator(cfg, device=dev)
    resumed.load_state_dict(state)
    after = feed(resumed, lane[cut:]) + resumed.flush()
    got = [(p, s.tolist()) for p, s in before + after]
    if got != ref:
        fail(f"FSM checkpoint at sample {cut}: {got} != {ref}")
    print(f"fsm streaming channel 0 T={lane.shape[0]} chunks={AO_CHUNK} "
          f"on {card}: packets={len(ref)} equal to 9a pipelined off/on "
          f"wall_s={walls[False]:.4f}/{walls[True]:.4f}; checkpoint at "
          f"sample {cut} (mid-packet, {len(state)} keys) resumed in a "
          f"fresh streamer: equal")


def _single_slack(singles: dict, t: int) -> dict:
    """{channel: symbols of its single's SF between the single's end and
    the capture's end} of the north-star fixture."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate

    slack = {}
    for c, (_, so) in singles.items():
        sf = SFS[c % len(SFS)]
        cfg = base_config().replace(sf=sf, ldr=(1 << sf) / 125e3 > 16e-3)
        length = len(modulate(encode(bytes([sf, 1, 2, sf]), cfg), cfg,
                              pad_front=0, pad_back=0))
        slack[c] = (t - so - length) / cfg.num_samples
    return slack


def fsm_receivers(iq_dev, singles, dev, card: str) -> None:
    """Phases 9b and 9c: MultiSFReceiver and TriggeredReceiver over phase
    4's north-star fixture (its device copy).  TriggeredReceiver must
    decode every single on every channel.  MultiSFReceiver must decode
    every single that ends at least one symbol of its SF before the
    capture's end: the whole-buffer FSM emits a packet only in the steps
    after its last symbol, so the JAX package's demod_fn finds no packet
    closer to the end either (tests/test_torch_demodulator.py holds both
    packages to that); the singles beyond that reach are printed.  The
    golden collision PDUs they find are printed, not asserted.  Each: a
    first pass (graph captures included), a timed pass that must give the
    same packets, a profiled pass."""
    import torch

    from gr_lora_tpu_torch.dist import MultiSFReceiver, TriggeredReceiver
    from gr_lora_tpu_torch.models.demodulator import demod_fn

    channels, t = iq_dev.shape[0], iq_dev.shape[1]
    slack = _single_slack(singles, t)
    for label, rx in (("9b multi-SF", MultiSFReceiver(base_config(), sfs=SFS,
                                                      device=dev)),
                      ("9c triggered", TriggeredReceiver(base_config(),
                                                         sfs=SFS,
                                                         device=dev))):
        whole = isinstance(rx, MultiSFReceiver)
        held = {c: v for c, v in singles.items()
                if not whole or slack[c] >= 1.0}
        beyond = {c: round(slack[c], 3) for c in singles if c not in held}
        t0 = time.perf_counter()
        pkts = rx(iq_dev)
        first_s = time.perf_counter() - t0
        counters = (f"events={rx.events} dropped_events={rx.dropped_events} "
                    f"dropped_packets={rx.dropped_packets}"
                    if not whole else
                    f"dropped={rx.dropped} steps_per_sf="
                    f"{ {sf: demod_fn(c, t, rx.max_packets, dev).loops[channels].steps for sf, c in rx.cfgs.items()} }")
        got = _ok_pdus(pkts)
        found = {c for c, (hx, _) in singles.items()
                 if any(sf == SFS[c % len(SFS)] and hx in h
                        for sf, h in got.get(c, set()))}
        lost = sorted(set(held) - found)
        if lost:
            fail(f"FSM {label}: singles not decoded on channels {lost}")
        t0 = time.perf_counter()
        again = rx(iq_dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if _ok_pdus(again) != got:
            fail(f"FSM {label}: a second pass decoded other packets")
        prof_s, busy, split, prof_cost = _profiled_pass(lambda: rx(iq_dev))
        both = sum({(8, PDU1), (8, PDU2)} <= got.get(c, set())
                   for c in range(channels))
        pdu1 = sum((8, PDU1) in got.get(c, set()) for c in range(channels))
        pdu2 = sum((8, PDU2) in got.get(c, set()) for c in range(channels))
        print(f"fsm {label} {channels}ch x SF7-12 T={t} on {card}: "
              f"packets={len(pkts)} singles={len(found)}/{len(singles)} "
              f"(asserted {len(held)}; ending under one symbol before the "
              f"capture's end, symbols of slack: {beyond}) "
              f"collision PDU1 on {pdu1}, PDU2 on {pdu2}, both on {both} "
              f"of {channels} channels (not asserted) {counters} (first "
              f"pass) "
              f"first_pass_s={first_s:.4f} wall_s={wall_s:.4f} "
              f"x_realtime_per_channel={t / 250e3 / wall_s:.3f} "
              f"profiled_pass_s={prof_s:.4f} device_busy_ms={busy:.2f} "
              f"idle={1 - busy / (1e3 * prof_s):.3f} "
              f"busy_of_timed_pass={busy / (1e3 * wall_s):.3f} "
              f"device_ms[{_split_txt(split)}] "
              f"profiler_read_s={prof_cost:.1f}")


def fsm_weak_loopback(dev, card: str) -> None:
    """Phase 9e: weak_demod_fn batched over bench.py --mode per's SF8
    weak point (fft_factor 8, "reference" compensation, WEAK_TRIALS
    noisy trials at WEAK_SNR_DB in-band, bench's seed) plus one clean
    lane, which must decode; the PER is printed.  Then the txrx_sim
    loopback (encode -> modulate -> AWGN 10 dB -> demodulate -> decode)
    at SF7-12, byte-exact with CRC."""
    import torch

    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.core.codec import decode, encode
    from gr_lora_tpu_torch.models.transceiver import loopback
    from gr_lora_tpu_torch.models.weak import modulate_weak, weak_demod_fn

    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=False,
                     payload_len=8, p=2, fft_factor=8)
    payload = bytes(range(1, 1 + cfg.payload_len))
    tx = encode(payload, cfg)
    cfg = cfg.replace(weak_sym_num=len(tx))
    clean = modulate_weak(tx, cfg)
    sigma = np.sqrt(cfg.p * 10.0 ** (-WEAK_SNR_DB / 10.0) / 2.0)
    rng = np.random.default_rng(hash((8, WEAK_SNR_DB, True)) % (1 << 31))
    noise = sigma * (rng.standard_normal((WEAK_TRIALS, len(clean)))
                     + 1j * rng.standard_normal((WEAK_TRIALS, len(clean))))
    batch = np.concatenate([clean[None], clean[None] + noise])
    x = torch.from_numpy(np.stack([batch.real, batch.imag], -1)
                         .astype(np.float32)).to(dev)
    fn = weak_demod_fn(cfg, len(clean), 2, device=dev)
    t0 = time.perf_counter()
    syms, lens, cnt, _ = (o.cpu().numpy() for o in fn(x))
    weak_s = time.perf_counter() - t0
    ok = []
    for lane in range(batch.shape[0]):
        hit = False
        for r in range(int(cnt[lane])):
            res = decode(syms[lane, r, :lens[lane, r]].astype(np.uint16),
                         cfg)
            hit |= bool(res.ok and res.crc_ok
                        and bytes(res.payload[:len(payload)]) == payload)
        ok.append(hit)
    if not ok[0]:
        fail("FSM weak: the clean lane did not decode")
    per = 1.0 - sum(ok[1:]) / WEAK_TRIALS
    lb = {}
    for sf in SFS:
        lcfg = LoraConfig(sf=sf, cr=2, crc=True, ldr=sf >= 11,
                          explicit_header=False,
                          payload_len=len(LOOPBACK_PAYLOAD), p=2,
                          fft_factor=2)
        t0 = time.perf_counter()
        r = loopback(LOOPBACK_PAYLOAD, lcfg, snr_db=10.0, device=dev)
        lb[sf] = time.perf_counter() - t0
        d = r.decoded[0] if len(r.decoded) == 1 else None
        if d is None or not (d.ok and d.crc_ok) or \
                bytes(d.payload[:len(LOOPBACK_PAYLOAD)]) != LOOPBACK_PAYLOAD:
            fail(f"FSM loopback at SF{sf}: {len(r.packets)} packets, "
                 f"{[bytes(x.payload).hex() for x in r.decoded]}")
    print(f"fsm weak SF8 ff8 reference compensation {WEAK_TRIALS} trials at "
          f"{WEAK_SNR_DB} dB + 1 clean lane on {card}: clean decoded, "
          f"PER={per:.4f} wall_s={weak_s:.4f} (capture included); loopback "
          f"SF7-12 AWGN 10 dB byte-exact with CRC: "
          f"{ {sf: round(s, 3) for sf, s in lb.items()} } s")


def fsm_phase(iq_dev, singles, dev, card: str) -> None:
    """Phase 9: the FSM receive path (no kernel of the nine runs here)."""
    marks = [time.perf_counter()]
    cfg = fsm_config()
    iq, offs, plen, ref = fsm_gateway(cfg, dev, card)
    marks.append(time.perf_counter())
    fsm_receivers(iq_dev, singles, dev, card)
    marks.append(time.perf_counter())
    fsm_streaming(cfg, iq, offs, plen, ref, dev, card)
    marks.append(time.perf_counter())
    fsm_weak_loopback(dev, card)
    marks.append(time.perf_counter())
    parts = np.diff(marks)
    print(f"fsm phase 9 total_s={marks[-1] - marks[0]:.2f} (9a "
          f"{parts[0]:.1f}, 9b+9c {parts[1]:.1f}, 9d {parts[2]:.1f}, 9e "
          f"{parts[3]:.1f})")


#: Where each peak kernel's top-M runs.
EPILOGUE = {
    "rdft_peaks": "fused: gr_lora_tpu_torch/csrc/rdft_spectra.cu (sweep "
                  "in the product's epilogue, units of 4 pair tiles) and "
                  "the merge of csrc/peak_topm.cu for M <= 16; a larger M "
                  "runs rdft_spectra and peak_topm.cu",
    "overlap_peaks": "fused: gr_lora_tpu_torch/csrc/overlap_spectra.cu "
                     "(search of each band after the window) and the merge "
                     "of csrc/peak_topm.cu for M <= 16; a larger M runs "
                     "overlap_spectra and peak_topm.cu",
    "direct_peaks": "fused: gr_lora_tpu_torch/csrc/direct_spectra.cu "
                    "(row sweep in the product's epilogue) for M <= 16; "
                    "a larger M runs direct_spectra and peak_topm.cu",
}
#: route, source, and the TPU kernel (file:line of its function) of each.
META = {
    "rdft_peaks": ("cuda", "gr_lora_tpu_torch/csrc/rdft_spectra.cu",
                   "gr_lora_tpu/ops/pallas_rdft.py:352"),
    "overlap_peaks": ("cuda", "gr_lora_tpu_torch/csrc/overlap_spectra.cu",
                      "gr_lora_tpu/ops/pallas_peaks.py:167"),
    "rdft_spectra": ("cuda", "gr_lora_tpu_torch/csrc/rdft_spectra.cu",
                     "gr_lora_tpu/ops/pallas_rdft.py:219"),
    "direct_spectra": ("cuda", "gr_lora_tpu_torch/csrc/direct_spectra.cu",
                       "gr_lora_tpu/ops/pallas_direct.py:101"),
    "direct_peaks": ("cuda", "gr_lora_tpu_torch/csrc/direct_spectra.cu",
                     "gr_lora_tpu/ops/pallas_direct.py:244"),
    "overlap_spectra": ("cuda", "gr_lora_tpu_torch/csrc/overlap_spectra.cu",
                        "gr_lora_tpu/ops/pallas_overlap.py:85"),
    "chunk_spectra": ("cuda", "gr_lora_tpu_torch/csrc/direct_spectra.cu",
                      "gr_lora_tpu/ops/pallas_frontend.py:134"),
    "rate_probe": ("cuda", "gr_lora_tpu_torch/csrc/probes.cu",
                   "bench.py:448"),
    "overlap_probe": ("cuda", "gr_lora_tpu_torch/csrc/probes.cu",
                      "tools/overlap_probe.py:59"),
}


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
    for name, usage in _build.resources().items():
        print(f"ptxas {_kernel_name(name)}: {usage}")
    for line in _build.PTXAS_PATH.read_text().splitlines():
        if "Performance Loss" in line:     # e.g. serialised wgmma
            print(f"ptxas {line.strip()}")

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

    ao_cfg = base_config()
    ao_iq, _ = always_on_fixture(ao_cfg)
    n = ao_cfg.num_samples
    block = AO_BLOCK_HOPS * n // 8 + n - n // 8
    msf_cfgs = {sf: base_config().replace(sf=sf, ldr=(1 << sf) / 125e3
                                          > 16e-3) for sf in SFS}
    msf_iq, msf_singles = north_star_fixture(msf_cfgs, AO_CHANNELS, T)
    cfg12 = msf_cfgs[12]
    n12 = cfg12.num_samples
    lo12 = msf_singles[5][1] - 4 * n12          # an SF12 single (channel 5)
    x12 = torch.from_numpy(
        msf_iq[:, lo12:lo12 + 128 * n12 // 8 + n12 - n12 // 8]).to(dev)

    # Phase 3: kernel parity on the card.
    report = {name: [] for name in META}
    with torch.no_grad():
        parity(gw, iq_dev, singles, report)
        parity_dense(ao_cfg, torch.from_numpy(ao_iq[:, :block]).to(dev),
                     cfg12, x12, report)
        parity_extra(ao_cfg, dev)
    del x12
    torch.cuda.empty_cache()

    # Phase 4: the north-star main path (K1, K2).
    launches, ns_pdus, ns_packets = main_path(gw, iq_dev, singles, card)
    del gw
    torch.cuda.empty_cache()

    # Phases 5-6: the always-on paths (K3, K4b, K4, K5, K6).
    always_on(ao_cfg, ao_iq, dev, card, launches)
    multi_sf(base_config(), msf_iq, msf_singles, dev, card, launches)
    torch.cuda.empty_cache()

    # Phase 7: the probes (P1, P2).
    probes(dev, card, report, launches)
    torch.cuda.empty_cache()

    # Phase 8: SIC (K1, K2 in its dense passes and the gateway's lattice).
    sic_envelope(base_config(), dev, card, launches)
    sic_python_tracker(base_config(), dev)
    sic_north_star(iq, singles, ns_pdus, ns_packets, dev, card, launches)

    # Phase 9: the FSM receive path (launches none of the nine kernels).
    with torch.no_grad():
        fsm_phase(iq_dev, singles, dev, card)
    del iq_dev
    torch.cuda.empty_cache()

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "gr_lora_tpu"))
    if foreign:
        fail(f"imported JAX or the JAX package: {foreign}")
    kernels = []
    for name, rows in report.items():
        route, source, replaces = META[name]
        last = rows[-1]                         # the last main-path shape
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": launches[name],
                 **last, "max_abs_err": max(r["max_abs_err"] for r in rows)}
        if name in EPILOGUE:
            entry["epilogue"] = EPILOGUE[name]
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
