"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero without
the final ``ok`` line):

1. device  — a CUDA device is required; prints nvidia-smi's name and
   power limit;
2. build   — compiles ``gr_lora_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
   one nvcc per source, all at once, and prints ptxas's registers, spills
   and static shared memory of every kernel; each of the peak epilogue's
   ten instances (``peak_topm``, the merge) must have no stack frame;
3. parity  — each hand-written kernel against its plain PyTorch version
   on the card at main-path shapes, with CUDA-event times of both:
   K1 rDFT peaks at SF7/SF8/SF9 and K2 overlap peaks at SF10/SF12 on 8
   event lanes (the gated gateway's windows; their peak searches fused:
   each call's peak allocation must stay below one [lanes, hops, K] f32
   array); K3 rDFT spectra, K4b direct
   spectra and K6 chunk spectra (each beside cuBLAS's time for its bare
   product, torch.matmul of the same bf16 operands; ``peak_topm`` at
   M = 8 and M = 32 on K3's spectra, equal to ``peaks_plain`` bit for
   bit, timed beside its byte bound, its plain version and torch.topk on
   the masked fold), K4 direct peaks (its
   peak search fused: the call's peak allocation must stay below one
   [lanes, hops, K] f32 array) and K5 overlap spectra on one always-on
   block of 16 channels x 2048 hops at SF8 (K5 also on the SF12 block of
   the multi-SF gateway); then, on 3 lanes of one packet each, K5 and K2
   at SF7 x fft_factor 16 (both timed), every kernel backend's lattice at
   M = 32 (above the fused searches' 16: the dense route), K3,
   K1 and K6 at SF7 p 1 (hop 16 samples) and K3 and K1 on a ragged frame
   count; K4b and K4 at SF6 x p 2 x fft_factor 8 (hop 16 samples: their
   chunk walk) on 16 lanes x 2048 hops, timed beside their plain versions
   and bounds; (3b) the configuration envelope: each kernel backend
   (rdft K3, direct K4b, fused_direct K4, fastp K5, pallas K6, fused K1 /
   K2 by the JAX dispatch) over SF 6-8 x p {2, 8} x fft_factor {1, 8}, the
   direct pair also at p 1 (hops 8 and 16), on 2 lanes of 64 hops of
   seeded noise and one chirp, each launched once through its wrapper and
   held against its plain version, one line a backend with the shapes it
   served.  Tolerances: K1, K3, K4b, K6 and K4 sum bf16 products in
   another order than their plain versions — the same peaks up to f32
   ties, heights within rtol 1e-3, and the dense K3 / K4b / K6 spectra
   within 1e-4 of the largest value; K2 and K5 round as their plain
   versions do: equal bit for bit; the merge that ends K1 (SF8) and K2
   (SF10), its device time read from torch.profiler, beside its plain
   version and torch.topk on the same candidates (their plain models');
4. main    — the north-star gateway: 64 channels x SF7-12
   detection-gated Pyramid collision decoding (TriggeredPyramidGateway,
   backend "fused": K1 and K2), warmed up (``warmup()``: its wall, which
   must leave the wall split at zero), then fed the golden SF8 collision
   on every channel plus one single per channel, twice, then flushed
   (both feeds' walls and wall splits, K1's launches per SF);
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
   kernels but the demod machine's step kernels (models/demodulator,
   models/weak, dist/multi_sf, dist/triggered; the per-lane state machine
   stepped on the card, 32 steps a captured CUDA graph, the demod
   machine's step as csrc/fsm_step.cu's fsm_win, fsm_sfd and fsm_update
   around two cuFFT calls; the profiled passes of (a)-(c) must run each
   of the three once a step their demod loops took through them, the
   triggered receiver's steps read from its recorder's
   ``fsm_kernel_steps``): (a) demod_fn batched over 64 channels
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
   busy and idle shares, device time by kind of kernel); (f) one step of
   the demod machine at the benchmark cells' shapes (lorabench's fsm64:
   SF8 x 128 lanes, SF12 x 16, the triggered receiver's event window):
   ms a step through the kernels replayed and eager, beside the plain
   body's replayed and eager, each kernel's device ms a step, launches a
   step and the device time by kind; the two loops' final states equal;
   the step's bound from what the function needs and from the current
   design (``python3 chip_smoke.py --fsm-step`` runs (f) alone);
10. wideband — the wideband north star, one SDR stream: 64 x 125 kHz
   channels at 8 Msps, 2^25 samples (4.19 s of air), on every channel an
   SF8 collision pair (0.4 / 0.18; channel 1's the golden pair; a drawn
   pair kept only where the gated gateway decodes both its packets at
   baseband) and one single at SF SFS[c % 6], payloads distinct, noise
   0.01, written once to a temporary file: (a) channelize on one 2^21
   block within 1e-5 of a float64 NumPy evaluation, within 1e-6 of itself
   with both TF32 flags on (fir_filter at rx_file's 3301 taps too), the
   streaming channelizer on irregular blocks equal to one whole call
   (atol 1e-5), its samples/s over 10 blocks; (b) the main path, the hand
   chain RingIngest -> StreamingChannelizer -> TriggeredPyramidGateway
   (fused: K1, K2) -> apps.gateway.decode_stream's power track and dedupe
   -> PduSink -> UDP: every injected PDU exactly once on its channel and
   SF within 10 symbols of its start, K1 and K2 launched; (c)
   apps.gateway.main --collision at its default backend (xla) equal to the
   hand chain at xla (positions within a hop), its differences from (b)
   printed, and the FSM engine: every single exactly once; (d) tx_file ->
   rx_file, tx_file -> rx_file_collision at 1 Msps and rx_stream over a
   250 ksps capture through the ring: the golden PDUs; (e) one pass of
   (b) under torch.profiler (busy, idle, the ten largest device entries);
11. tracker — the on-device Pyramid tracker (models/device_tracker, the
   walk kernel csrc/device_tracker.cu): (a) the kernel against its plain
   version on phase 5's always-on SF8 block (16 channels, 512 hops of
   K3's lattice) and one north-star event batch at SF10 (K2) and SF8
   (K1), each with and without split_repeats, on pools small enough
   that the deviation counters fire (with a synthetic twin lattice whose
   two packets expire on one hop: every counter fires) and on pools
   past a block's shared memory (the kernel's global-memory instance),
   as two consecutive blocks and the flush: every state field equal bit
   for bit, timed beside the plain version, the byte bound and the
   chain bound (from the latencies of the chain's primitives, measured
   on the card by a small nvcc-built probe), each instance's registers,
   stack and spills from ptxas;
   (b) phase 4's north star with ``tracker="device"``: every
   golden PDU and single, no deviation, K1, K2 and the walk launched,
   the PDUs against phase 4's, the wall split beside phase 4's and one
   profiled feed each of the host and device trackers; (c) phase 5's
   always-on gateway at ``fastp`` and ``fused_direct`` and phase 6's
   multi-SF gateway with ``tracker="device"``: the host tracker's PDUs,
   no deviation, the bytes copied to the host against the host
   tracker's; then ``fastp`` again with pools past a block's shared
   memory (the walk's global-memory instance): the same PDUs; (d) dist/soak on the gated gateway with split_repeats,
   the host tracker and then ``tracker="device"`` on the same uncurated
   traffic: check_soak holds the device run to the host tracker's
   packets, the injected packets neither decodes printed; (e) apps.gateway --collision --tracker device on phase
   10's capture equal to the hand chain with the device tracker;
12. mesh — the shard grid (dist/mesh, dist/gateway, dist/multihost), its
   slots all on the card: (a) the FSM gateway on {ch: 2, t: 4} over
   phase 9a's fixture with each channel's packet across a t seam: every
   payload byte-exact once, at demod_fn's position over the whole capture
   (mesh=None), dropped 0; the grid's pass beside mesh=None's in turns,
   the halo bytes a block, one profiled grid pass; (b) phase 5's
   always-on gateway on {ch: 2, t: 4} at fastp (K5) and fused_direct (K4)
   with the host tracker and at fastp with tracker="device" (the walk):
   phase 5's PDUs, no deviation; (c) phase 4's north star on {ch: 4}:
   every golden PDU and single, phase 4's PDUs, K1 and K2 launched; (d)
   two ranks on the card over gloo (NCCL refuses two ranks on one
   device), tests/torch_multihost_worker.py's five scenarios of
   tests/test_multihost.py (the FSM seam packet at 64 channels; the
   always-on gateway row-owned, time-only with its lattice gathered, the
   gated gateway split by channel and the device tracker, at 16): each
   rank's packets equal the single-process run's by ownership, the
   device tracker's copy to the host under 64 KB; which gloo
   collectives take CUDA tensors, printed; then a one-rank NCCL group
   runs (a) with gather_results=True (``--nccl-rank``, a child process):
   its packets equal (a)'s.

Phases 4-8 and 10-12 each assert what they check and that their kernels
ran: every launch count is set to 0 just before a phase and read just
after; phase 9 counts the step kernels' device records in its profiled
passes.  Two lines then give the port's kernels that stand for no TPU
kernel, the dense ``peak_topm`` and the merge: their main-path shapes,
ms, byte bound, plain and library ms, and launches over phases 4-12.
The line before the last is a JSON object with every kernel's
route, source, the TPU kernel it replaces (the tracker walk: the
``lax.scan`` it stands for; the FSM step kernels: the JAX step's
``lax.while_loop`` body, their rows phase 9f's with the step's bounds
beside each kernel's own, their launches 9a-9c's), launches, max |delta| against its plain
version, times, and the least time the card could take (``bound_ms``:
the larger of the bytes the function must move over 3.35 TB/s and its
operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32, from this run's
shapes); the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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


def _merge_ms(call, iters: int = 10, tries: int = 3) -> float:
    """Device ms a call of the merge kernel (csrc/peak_topm.cu
    peak_merge_kernel) that ends a fused peak lattice's ``call``, from
    torch.profiler's trace: a window of ``iters`` calls must show one
    merge a call (a window whose trace lost records is taken again, at
    most ``tries`` times).  With the merge launched as a programmatic
    dependent, its span includes its wait for the producer's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and "peak_merge" in e.name()]
        if len(ns) == iters:
            return sum(ns) / 1e6 / iters
        seen.append(len(ns))
    fail(f"the profiler saw {seen} merge kernels in {tries} windows of "
         f"{iters} calls")


def _merge_row(name: str, call, cands, m: int, shape: str,
               port_only: dict) -> None:
    """The merge's time after one fused lattice ``call``, beside its byte
    bound, its plain version (``merge_peaks``) and torch.topk on the rows'
    candidate values, both on ``cands``: the producer's (lists, pairs) as
    its plain model gives them (``unit_candidates``, ``band_candidates``).
    The bound counts what the merge must read of this data (each list up
    to its first empty slot, each pair's two entries; 16 B an entry) and
    the slots it writes."""
    import torch

    from gr_lora_tpu_torch.ops.peak_epilogue import merge_peaks

    lists, pairs = cands
    rows = lists[0][..., 0, 0].numel()
    nl, per = lists[0].shape[-2:]
    filled = torch.isfinite(lists[0]).sum(-1)
    read = int((filled + 1).clamp(max=per).sum())
    npair = 0 if pairs is None else pairs[0].numel()
    ms = _merge_ms(call)
    bound = _bound(16 * (read + npair) + 13 * rows * m)
    earlier = _bound(16 * (rows * nl * per + npair) + 13 * rows * m)
    vals = lists[0].reshape(rows, -1)
    if pairs is not None:
        pv, pb = pairs[0], pairs[1]
        ok = (pb >= 0) & (pv > pv.flip(-1))
        vals = torch.cat([vals, torch.where(ok, pv, -torch.inf)
                          .reshape(rows, -1)], -1)
    library_ms = _time_ms(lambda: torch.topk(vals, m, dim=-1), 10)
    plain_ms = _time_ms(lambda: merge_peaks(lists, pairs, m), 3)
    print(f"parity merge after {name} {shape}: ms={ms:.4f} "
          f"bound_ms={bound[0]:.6f} (list entries read {read} of "
          f"{rows * nl * per}, edge-pair entries {npair}; every entry: "
          f"{earlier[0]:.6f}) plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (torch.topk of the rows' "
          f"candidates)")
    port_only.setdefault("merge", []).append(
        {"after": name, "shape": shape, "ms": ms, "bound_ms": bound[0],
         "plain_ms": plain_ms, "library_ms": library_ms})


def _cands_on(cands, dev):
    """(lists, pairs) of a plain candidate model moved to ``dev``."""
    lists, pairs = cands
    return (tuple(t.to(dev) for t in lists),
            None if pairs is None else tuple(t.to(dev) for t in pairs))


def parity(gw, iq_dev, singles, report: dict, port_only: dict) -> None:
    """Phase 3: every kernel against its plain version at main-path
    shapes, on the card; the merge's device time after K1 (SF8) and K2
    (SF10)."""
    import torch

    from gr_lora_tpu_torch.models.pyramid import BlockedLattice
    from gr_lora_tpu_torch.ops.overlap_peaks import (OverlapPeaks, _bands,
                                                     band_candidates)
    from gr_lora_tpu_torch.ops.rdft_peaks import (RdftPeaks, num_units,
                                                  unit_candidates)

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
        if sf == 8:
            rows, units = lanes * mod.num_frames, num_units(fr.k)
            cands = unit_candidates(*(t.cpu() for t in fr.plain(x)),
                                    mod.threshold, mod.max_peaks)
            _merge_row("K1", lambda: mod(x), _cands_on(cands, x.device),
                       mod.max_peaks, f"SF8 [{rows}, {units} lists]",
                       port_only)
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
        if sf == 10:
            fr = mod.front
            rows, bands = lanes * mod.num_hops, _bands(fr.f, fr.k)
            cands = band_candidates(
                *(t.cpu() for t in fr.plain_from_chunks(g)), mod.plan,
                mod.threshold, mod.max_peaks)
            _merge_row("K2", lambda: mod.from_chunks(g),
                       _cands_on(cands, g.device), mod.max_peaks,
                       f"SF10 [{rows}, {bands} lists]", port_only)


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


def main_path(gw, iq_dev, singles, card: str, label: str = "main"):
    """Phase 4: warm the gateway up (``warmup()``: every scan and lattice
    bucket built and run on zeros), then feed the fixture twice, flush,
    check the decodes.  Returns (launches, the decoded {channel: {(sf,
    payload)}}, packet count, the second feed's wall split).  Phase 12c
    runs it on a grid."""
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
    t0 = time.perf_counter()
    gw.warmup()
    warmup_s = time.perf_counter() - t0
    if any(gw.wall.values()):
        fail(f"warmup() moved the wall split: {gw.wall}")
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
    print(f"{label} north-star {channels}ch x SF7-12 T={t} x2 feeds + flush "
          f"on {card}: packets={npk} (feed1={len(feeds[0])} "
          f"feed2={len(feeds[1])} flush={len(tail)}) "
          f"warmup_s={warmup_s:.4f} "
          f"feed_s=[{secs[0]:.4f}, {secs[1]:.4f}] flush_s={flush_s:.4f} "
          f"feed1_wall[{_wall_txt(walls[0])}] "
          f"feed2_wall[ingest={w['ingest']:.4f} scan={w['scan']:.4f} "
          f"lattice={w['lattice']:.4f} tracker={w['tracker']:.4f} "
          f"decode={w['decode']:.4f}] feed2_samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"launches={launches} k1_launches_by_sf={k1_launches}")
    return launches, every, npk, w


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


def parity_dense(cfg8, x8, cfg12, x12, report: dict,
                 port_only: dict) -> None:
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
            _time_topm(kern, thr, port_only)
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


def parity_hop16(cfg8, dev, report: dict) -> None:
    """Phase 3, K4b and K4 on their chunk walk: SF6 x p 2 x fft_factor 8
    (hop 16 samples), 16 lanes x 2048 hops of seeded noise and one chirp
    a lane, against their plain versions (K4b's dense spectra within 1e-4
    of the largest value, both the plain peaks up to f32 ties), timed
    beside the plain versions and their tensor-core bound.  The rows go
    before the SF8 ones, which stay each kernel's main-path row."""
    import torch

    from gr_lora_tpu_torch.ops.direct import DirectPeaks, DirectSpectra
    from gr_lora_tpu_torch.ops.peak_epilogue import peaks_plain

    cfg = cfg8.replace(sf=6, explicit_header=False, payload_len=4)
    lanes, hops = AO_CHANNELS, AO_BLOCK_HOPS
    x = _chirp_lanes(cfg, lanes, hops, 6, dev)
    thr = float(cfg.threshold)
    n, k = cfg.num_samples, cfg.bin_size
    tag = f"SF6 p{cfg.p} ff{cfg.fft_factor} (hop {n // 8})"
    ops = lanes * hops * 32 * n * k
    mod = DirectSpectra(cfg, hops).to(dev)
    if mod.plane_walk:
        fail(f"{tag}: K4b took the plane walk")
    kern, plain = mod.kernel(x), mod.plain(x)
    torch.cuda.synchronize()
    err = _dense_check(f"direct_spectra {tag}", kern, plain, 1e-4)
    _, ties = _compare(peaks_plain(*kern, thr, 8), peaks_plain(*plain, thr, 8),
                       plain[1], 1e-3, thr)
    del kern, plain
    ms = _time_ms(lambda: mod.kernel(x), 5)
    plain_ms = _time_ms(lambda: mod.plain(x), 3)
    shape = f"{tag} [{lanes}, {x.shape[1]}, 2] -> [{lanes}, {hops}, {k}]"
    bound = _bound(_nbytes(x, mod.w) + 3 * 4 * lanes * hops * k, ops)
    a, w = _product_operands(mod, x)
    cublas = _time_ms(lambda: torch.matmul(a, w), 5)
    del a, w
    print(f"parity K4b direct_spectra {shape}: max_abs_err={err:.6g} "
          f"tie_peaks={ties} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound[0]:.4f} cublas_product_ms={cublas:.4f}")
    row = _row(err, ms, plain_ms, shape, bound)
    row["cublas_product_ms"] = cublas
    report["direct_spectra"].insert(0, row)

    mod = DirectPeaks(cfg, hops, 8).to(dev)
    kern, alloc = _fused_alloc("direct_peaks", lambda: mod(x), lanes, hops,
                               k)
    plain = mod.plain(x)
    faw = mod.front.plain(x)[1]
    torch.cuda.synchronize()
    if not bool(plain[3].any()):
        fail(f"direct_peaks {tag}: no peak in the plain lattice")
    err, ties = _compare(kern, plain, faw, 1e-3, thr)
    del kern, plain, faw
    ms = _time_ms(lambda: mod(x), 5)
    plain_ms = _time_ms(lambda: mod.plain(x), 3)
    shape = f"{tag} [{lanes}, {x.shape[1]}, 2] -> [{lanes}, {hops}, 8]"
    bound = _bound(_nbytes(x, mod.front.w) + _peak_bytes(lanes, hops, 8),
                   ops)
    print(f"parity K4 direct_peaks {shape}: max_abs_err={err:.6g} "
          f"tie_peaks={ties} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound[0]:.4f} alloc_bytes={alloc}")
    report["direct_peaks"].insert(0, _row(err, ms, plain_ms, shape, bound))
    del mod, x
    torch.cuda.empty_cache()


def _time_topm(spectra, threshold: float, port_only: dict) -> None:
    """peak_topm on one block of dense spectra at M = 8 (the main path's
    list of 8) and M = 32 (the rescanning instance), each equal to
    peaks_plain bit for bit; its byte bound (faw read once, fa and hs at
    the valid peaks as a 32-byte sector each, the slots written), the
    plain version's time and torch.topk's on the masked fold (the
    counterpart of the JAX epilogue's lax.top_k, the fold made before the
    timed window)."""
    import torch

    from gr_lora_tpu_torch.ops.peak_epilogue import launch_topm, peaks_plain

    fa, faw, hs = spectra
    k = faw.shape[-1]
    rows = faw.numel() // k
    found = {}
    for m in (8, 32):
        kern = launch_topm(fa, faw, hs, threshold, m)
        plain = peaks_plain(fa, faw, hs, threshold, m)
        torch.cuda.synchronize()
        for part, a, b in zip(("bins", "h", "h_single", "valid"), kern,
                              plain):
            if not torch.equal(a, b):
                fail(f"peak_topm M {m}: {part} differs from peaks_plain")
        found[m] = int(plain[3].sum())
        del kern, plain
    ms = {m: _time_ms(lambda m=m: launch_topm(fa, faw, hs, threshold, m),
                      20) for m in (8, 32)}
    bound = {m: _bound(_nbytes(faw) + 2 * 32 * found[m] + 13 * rows * m)
             for m in (8, 32)}
    plain_ms = _time_ms(lambda: peaks_plain(fa, faw, hs, threshold, 8), 3)
    left, right = torch.roll(faw, 1, -1), torch.roll(faw, -1, -1)
    vals = torch.where((faw > threshold) & (faw > left) & (faw > right),
                       faw, -torch.inf)
    del left, right
    library_ms = _time_ms(lambda: torch.topk(vals, 8, dim=-1), 20)
    del vals
    print(f"parity peak_topm [{rows} rows, {k}] (K3's spectra): equal to "
          f"peaks_plain bit for bit at M 8 and 32; M8_ms={ms[8]:.4f} "
          f"bound_ms={bound[8][0]:.6f} ({found[8]} valid peaks) "
          f"M32_ms={ms[32]:.4f} bound_ms={bound[32][0]:.6f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"(torch.topk, M 8, on the masked fold)")
    port_only["peak_topm"] = [{
        "shape": f"[{rows}, {k}] M 8", "ms": ms[8], "bound_ms": bound[8][0],
        "ms_m32": ms[32], "bound_ms_m32": bound[32][0],
        "plain_ms": plain_ms, "library_ms": library_ms}]


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


#: Phase 3b: each kernel backend over SF 6-8 x p {2, 8} x fft_factor
#: {1, 8}; the direct pair also at p 1 (hop 8 at SF6, 16 at SF7).
ENVELOPE_BACKENDS = ("rdft", "direct", "fused_direct", "fastp", "pallas",
                     "fused")
ENVELOPE_GRID = [(sf, p, ff) for sf in (6, 7, 8) for p in (2, 8)
                 for ff in (1, 8)]
ENVELOPE_P1 = [(sf, 1, ff) for sf in (6, 7) for ff in (1, 8)]
ENVELOPE_HOPS = 64


def _chirp_lanes(cfg, lanes: int, hops: int, seed: int, dev):
    """[lanes, T, 2] on the card, T the samples of ``hops`` hop frames:
    noise 0.01 from default_rng(seed) and one upchirp (amplitude 0.2) a
    lane at a lane-specific offset."""
    import torch

    from gr_lora_tpu_torch.ops.chirp import chirp_tables
    from gr_lora_tpu_torch.ops.cplx import to_ri

    n = cfg.num_samples
    hop = n // 8
    total = (hops - 1) * hop + n
    rng = np.random.default_rng(seed)
    iq = (0.01 * (rng.standard_normal((lanes, total))
                  + 1j * rng.standard_normal((lanes, total)))
          ).astype(np.complex64)
    up, _ = chirp_tables(cfg.sf, cfg.p)
    for i in range(lanes):
        o = (3 * hop + 5 * i) % (total - n)
        iq[i, o:o + n] += 0.2 * up
    return torch.from_numpy(to_ri(iq)).to(dev)


def _envelope_case(backend: str, cfg, x, nh: int):
    """One backend's kernel against its plain version on ``x``, called
    through the wrapper's counted entry (``forward`` / ``from_chunks``):
    (the kernel that ran, max |delta|), failing unless it launched once.
    K3 / K4b / K6 dense within 1e-4 of the largest value and their peaks
    up to f32 ties; K1 / K4 the plain peaks up to f32 ties (heights rtol
    1e-3); K2 / K5 bit for bit."""
    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn
    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
    from gr_lora_tpu_torch.ops.direct import DirectPeaks, DirectSpectra
    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
    from gr_lora_tpu_torch.ops.peak_epilogue import peaks_plain
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

    thr = float(cfg.threshold)
    what = f"envelope {backend} SF{cfg.sf} p{cfg.p} ff{cfg.fft_factor}"
    dense = {"rdft": ("K3", RdftSpectra), "direct": ("K4b", DirectSpectra),
             "pallas": ("K6", ChunkSpectra), "fastp": ("K5", OverlapSpectra)}
    if backend in dense:
        tag, cls = dense[backend]
        mod = cls(cfg, nh).to(x.device)
        if tag == "K5":
            g = mod.plan.chunk_dft(x, nh)
            kern, plain = mod.from_chunks(g), mod.plain_from_chunks(g)
            err = _dense_check(f"{what} K5", kern, plain, 0.0)
        else:
            kern, plain = mod(x), mod.plain(x)
            err = _dense_check(f"{what} {tag}", kern, plain, 1e-4)
            ref = peaks_plain(*plain, thr, 8)
            if not bool(ref[3].any()):
                fail(f"{what}: no peak in the plain spectra")
            _compare(peaks_plain(*kern, thr, 8), ref, plain[1], 1e-3, thr)
    else:
        mod = DirectPeaks(cfg, nh, 8) if backend == "fused_direct" \
            else peak_lattice_fn(cfg, nh, 8, backend)
        mod = mod.to(x.device)
        if isinstance(mod, OverlapPeaks):
            g = mod.plan.chunk_dft(x, nh)
            kern, plain = mod.from_chunks(g), mod.plain_from_chunks(g)
            tag, faw, rtol = "K2", None, 0.0
        else:
            tag = {RdftPeaks: "K1", DirectPeaks: "K4"}.get(type(mod))
            if tag is None:
                fail(f"{what}: the dispatch chose {type(mod).__name__}")
            kern, plain = mod(x), mod.plain(x)
            faw, rtol = mod.front.plain(x)[1], 1e-3
        if not bool(plain[3].any()):
            fail(f"{what}: no peak in the plain lattice")
        err, _ = _compare(kern, plain, faw, rtol, thr)
    if mod.launches != 1:
        fail(f"{what}: {tag} launched {mod.launches} times, not once")
    return tag, err


def envelope(cfg8, dev, card: str) -> None:
    """Phase 3b: every kernel backend over the configuration envelope (SF
    6-8 x p {2, 8} x fft_factor {1, 8}, the direct pair also at p 1), 2
    lanes of 64 hops of seeded noise and one chirp, each kernel against
    its plain version; one line a backend with the shapes it served."""
    import torch

    t0 = time.perf_counter()
    for backend in ENVELOPE_BACKENDS:
        grid = ENVELOPE_GRID + (ENVELOPE_P1 if backend in (
            "direct", "fused_direct") else [])
        served, worst = [], 0.0
        for i, (sf, p, ff) in enumerate(grid):
            cfg = cfg8.replace(sf=sf, p=p, fft_factor=ff,
                               explicit_header=sf > 6, payload_len=4)
            x = _chirp_lanes(cfg, 2, ENVELOPE_HOPS, 100 + i, dev)
            tag, err = _envelope_case(backend, cfg, x, ENVELOPE_HOPS)
            worst = max(worst, err)
            served.append(f"SF{sf}xp{p}xff{ff}(hop {cfg.num_samples // 8},"
                          f" K {cfg.bin_size}):{tag}")
        torch.cuda.synchronize()
        print(f"envelope {backend} on {card}: {len(served)} shapes, one "
              f"kernel launch each, equal to the plain version, "
              f"max_abs_err={worst:.6g}: " + " ".join(served))
    torch.cuda.empty_cache()
    print(f"envelope phase 3b total_s={time.perf_counter() - t0:.2f}")


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


def _ao_pdus(pkts, channels: int, what: str) -> dict:
    """{channel: sorted PDUs} of an always-on run; each golden PDU must
    decode 4 times on every channel (two collisions, two passes)."""
    out = {}
    for c in range(channels):
        pdus = sorted(bytes(p.result.payload).hex() for p in pkts
                      if p.channel == c and p.result is not None
                      and p.result.ok and p.result.crc_ok)
        if pdus.count(PDU1) != 4 or pdus.count(PDU2) != 4:
            fail(f"{what}: channel {c} decoded {pdus}, want each golden "
                 "PDU 4 times")
        out[c] = pdus
    return out


@contextlib.contextmanager
def gc_pauses():
    """Times the passes of Python's garbage collector while entered:
    yields {generation: [passes, seconds]}, filled in as they happen."""
    got, start = {}, [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            g = got.setdefault(info["generation"], [0, 0.0])
            g[0] += 1
            g[1] += time.perf_counter() - start[0]

    gc.callbacks.append(on_gc)
    try:
        yield got
    finally:
        gc.callbacks.remove(on_gc)


def _gc_txt(got: dict) -> str:
    return " ".join(f"gen{g}={n}x{s:.4f}s" for g, (n, s) in sorted(
        got.items())) or "none"


def always_on(cfg, iq, dev, card: str, launches: dict,
              tracker: str = "host", host: dict | None = None,
              device_pools: dict | None = None, mesh=None,
              label: str | None = None) -> dict:
    """Phase 5: the always-on gateway once per kernel backend: two passes
    of the fixture in AO_CHUNK chunks (numpy, as bench.py feeds it), then
    a flush; both golden PDUs must decode on every channel for each of
    the fixture's two collisions in each pass.  Returns {backend:
    (fetched bytes, {channel: PDUs})}.  Phase 11c runs it again with
    ``tracker="device"`` over the backends of ``host`` (phase 5's
    result): the same PDUs on every channel, no deviation; with
    ``device_pools`` the device tracker's pools.  Phase 12b passes a
    shard grid (``mesh``) and its ``label``."""
    import torch

    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway

    channels, t = iq.shape[0], iq.shape[1]
    out = {}
    for backend, name in AO_BACKENDS.items():
        if host is not None and backend not in host:
            continue
        # Free the earlier phases' garbage before the timed passes: the
        # collector pass that freed it once stalled 12b's pass 2 (PERF.md).
        gc.collect()
        gw = PyramidGateway(cfg, channels, block_hops=AO_BLOCK_HOPS,
                            max_peaks=8, backend=backend, tracker=tracker,
                            device_pools=device_pools, mesh=mesh,
                            device=dev)
        mods = _kernel_modules(gw.lattice, name)
        for m in mods:
            m.launches = 0
        gw.wall_reset()
        pkts, secs, walls = [], [], []
        for _ in range(2):
            t0 = time.perf_counter()
            with gc_pauses() as gcp:
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
        what = f"always-on {backend} tracker={tracker}" + (
            f" pools={device_pools}" if device_pools else "") + (
            f" grid={mesh.shape}" if mesh is not None else "")
        pdus = _ao_pdus(pkts, channels, what)
        out[backend] = (gw.fetched_bytes, pdus)
        extra = ""
        if host is not None:
            if pdus != host[backend][1]:
                fail(f"{what}: PDUs differ from the host tracker's")
            dev_s = gw.stats()
            if tracker == "device" and dev_s["deviations"]:
                fail(f"{what}: deviations {dev_s}")
            cut = host[backend][0] / max(gw.fetched_bytes, 1)
            extra = (" same PDUs as phase 5 on every channel,"
                     + (" deviations=0," if tracker == "device" else "")
                     + f" fetched_bytes={gw.fetched_bytes} (host tracker "
                     f"{host[backend][0]}, {cut:.1f}x)")
        w = walls[1]
        sps = channels * t / secs[1]
        print(f"{label or ('tracker 11c' if host is not None else 'main')} "
              f"{what} "
              f"{channels}ch SF{cfg.sf} "
              f"block_hops={AO_BLOCK_HOPS} T={t} x2 passes + flush on "
              f"{card}: packets={len(pkts)} pass_s=[{secs[0]:.4f}, "
              f"{secs[1]:.4f}] pass2_wall[dispatch={w['dispatch']:.4f} "
              f"fetch={w['fetch']:.4f} tracker={w['tracker']:.4f} "
              f"decode={w['decode']:.4f}] pass2_gc_pauses[{_gc_txt(gcp)}] "
              f"pass2_samples_per_s={sps:.1f} "
              f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
              f"launches={{'{name}': {count}}}{extra}")
        del gw
        torch.cuda.empty_cache()
    return out


def multi_sf(base, iq, singles, dev, card: str, launches: dict,
             tracker: str = "host", host: tuple | None = None) -> tuple:
    """Phase 6: MultiSFPyramidGateway, backend "fastp", 16 ch x SF7-12,
    bench.py's per-SF block_hops; the golden PDUs and every single must
    decode.  Returns (fetched bytes, the decoded {channel: {(sf,
    payload)}}).  Phase 11c runs it again with ``tracker="device"``: the
    PDUs of ``host`` (phase 6's result), no deviation."""
    import torch

    from gr_lora_tpu_torch.dist.pyramid_gateway import MultiSFPyramidGateway

    channels, t = iq.shape[0], iq.shape[1]
    bh = {sf: max(64, AO_BLOCK_HOPS * 256 // (1 << sf)) for sf in SFS}
    gw = MultiSFPyramidGateway(base, channels, sfs=SFS, block_hops=bh,
                               max_peaks=8, backend="fastp", tracker=tracker,
                               device=dev)
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
    extra = ""
    if host is not None:
        if got != host[1]:
            fail(f"multi-SF tracker={tracker}: PDUs differ from the host "
                 f"tracker's: {got} vs {host[1]}")
        if gw.stats()["deviations"]:
            fail(f"multi-SF tracker={tracker}: deviations {gw.stats()}")
        extra = (f" same PDUs as phase 6, deviations=0, fetched_bytes="
                 f"{gw.fetched_bytes} (host tracker {host[0]}, "
                 f"{host[0] / max(gw.fetched_bytes, 1):.1f}x)")
    sps = channels * t / feed_s
    print(f"{'tracker 11c' if host is not None else 'main'} multi-SF "
          f"backend=fastp tracker={tracker} {channels}ch x SF7-12 T={t} "
          f"block_hops={bh} feed + flush on {card}: packets={len(pkts)} "
          f"feed_s={feed_s:.4f} feed_wall[dispatch={w['dispatch']:.4f} "
          f"fetch={w['fetch']:.4f} tracker={w['tracker']:.4f} "
          f"decode={w['decode']:.4f}] feed_samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"launches={{'overlap_spectra': {count}}}{extra}")
    return gw.fetched_bytes, got


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
    from gr_lora_tpu_torch.models.pyramid import (make_peak_lattice,
                                                  num_hops_for,
                                                  pyramid_demodulate)
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    points, p1, p2, total = envelope_grid(cfg)
    k1 = [m for m in make_peak_lattice(cfg, num_hops_for(cfg, total), 16,
                                       "fused", dev).modules()
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
    from gr_lora_tpu_torch.models.pyramid import make_peak_lattice
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
    in_sic = kernels([make_peak_lattice(
        st.cfg, st.win_hops, gw.max_peaks, gw.backend, dev,
        block_hops=gw._lattice_block_hops(st))
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
_KINDS = (("fsm", ("fsm_",)), ("cuFFT", ("fft",)), ("gather", ("gather",)),
          ("reduce", ("reduce", "argmax")), ("scan", ("scan",)),
          ("copy", ("memcpy", "memset", "copy")))


def _kind(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in _KINDS
                 if any(k in low for k in keys)), "elementwise")


#: The demod machine's step kernels (csrc/fsm_step.cu), in launch order.
FSM_KERNELS = ("fsm_win", "fsm_sfd", "fsm_update")


def _fsm_kernel(name: str) -> str | None:
    """The FSM_KERNELS entry a device kernel's (mangled) name is, or None."""
    m = re.search(r"fsm_(win|sfd|update)", name)
    return f"fsm_{m.group(1)}" if m else None


def _device_time(prof, fsm: dict | None = None) -> tuple[float, int, dict]:
    """(busy ms: the union of the device-side intervals, the number of
    device-side records, {kind: ms} by _KINDS) of ``prof``, read from its
    raw trace: a replayed pass records millions of kernels, too many to
    parse into profiler events.  ``fsm``, where given, gets the records of
    each FSM_KERNELS kernel added to it."""
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
        if fsm is not None and kind == "fsm":
            key = _fsm_kernel(name)
            fsm[key] = fsm.get(key, 0) + 1
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


def _profiled_pass(run, fsm: dict | None = None
                   ) -> tuple[float, float, dict, float]:
    """(wall s, device busy ms, device ms by kind, seconds the profiler
    took to stop and be read) of one ``run()`` under torch.profiler;
    ``fsm`` as _device_time's."""
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
    busy, _, split = _device_time(prof, fsm)
    return wall, busy, split, time.perf_counter() - t0


def _fsm_main_path(label: str, fsm: dict, steps: int,
                   launches: dict) -> None:
    """Fail unless a profiled pass ran each FSM_KERNELS kernel once a step
    of the ``steps`` (> 0) its demod loops took through the kernels (read
    from the loops, or the receiver's recorder); add them to
    ``launches``."""
    if steps <= 0 or any(fsm.get(k, 0) != steps for k in FSM_KERNELS):
        fail(f"FSM {label}: {steps} kernel steps, device records {fsm}")
    for k in FSM_KERNELS:
        launches[k] = launches.get(k, 0) + steps


def _split_txt(split: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items())


def _lane_packets(outs, lane: int) -> list:
    """[(position, symbols list)] of one lane of demod_fn's outputs."""
    syms, lens, pos, cnt, _, _ = outs
    return [(int(pos[lane, r]), syms[lane, r, :lens[lane, r]].tolist())
            for r in range(int(cnt[lane]))]


def fsm_gateway(cfg, dev, card: str, launches: dict):
    """Phase 9a: demod_fn batched over 64 channels of bench.py --mode
    gateway's fixture.  Every channel's payload must decode byte-exact
    with its CRC.  Prints samples/s over FSM_TIMED replayed passes, the
    steps a pass, ms a step replayed and eager, launches a step, and a
    profiled pass's busy and idle shares; that pass must run each step
    kernel once a step (``_fsm_main_path``).  Returns (iq, offsets, packet
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
    fsm = {}
    wall, busy, split, prof_cost = _profiled_pass(lambda: fn(x), fsm)
    kernel_steps = fn.loops[channels].kernel_steps
    _fsm_main_path("9a gateway", fsm, kernel_steps, launches)
    sps = channels * total * FSM_TIMED / sum(secs)
    best = min(secs)
    print(f"fsm gateway {channels}ch SF8 implicit p2 ff2 T={total} "
          f"({FSM_SYMBOLS} symbols) max_packets=4 on {card}: decoded={channels}/"
          f"{channels} first_pass_s={first_s:.4f} (capture included) "
          f"pass_s={[round(s, 4) for s in secs]} samples_per_s={sps:.1f} "
          f"x_realtime_per_channel={sps / channels / 250e3:.3f} "
          f"steps_per_pass={steps} kernel_steps={kernel_steps} "
          f"(device records {fsm}) steps_per_check={STEPS} "
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


def fsm_receivers(iq_dev, singles, dev, card: str, launches: dict) -> None:
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
    same packets, a profiled pass, which must run each step kernel once a
    step the demod loops took (``_fsm_main_path``; the triggered
    receiver's steps from its recorder's ``fsm_kernel_steps``, on for
    that pass only, which must equal its replays' steps at every SF)."""
    import torch

    from gr_lora_tpu_torch.dist import MultiSFReceiver, TriggeredReceiver
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from gr_lora_tpu_torch.models.fsm_loop import STEPS
    from gr_lora_tpu_torch.trace import summary

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
        fsm = {}
        if whole:
            prof_s, busy, split, prof_cost = _profiled_pass(
                lambda: rx(iq_dev), fsm)
            kernel_steps = sum(
                demod_fn(c, t, rx.max_packets, dev).loops[channels]
                .kernel_steps for c in rx.cfgs.values())
        else:
            rx.recorder.on = True
            prof_s, busy, split, prof_cost = _profiled_pass(
                lambda: rx(iq_dev), fsm)
            rx.recorder.on = False
            counted = summary(rx.recorder.records())["counters"]
            by_sf = {k: v for k, v in counted.items()
                     if k.startswith("fsm_kernel_steps.")}
            kernel_steps = sum(by_sf.values())
            for key, v in by_sf.items():
                replays = counted.get("replays." + key.split(".")[1], 0)
                if v != replays * STEPS:
                    fail(f"FSM {label}: {key} {v}, {replays} replays")
        _fsm_main_path(label, fsm, kernel_steps, launches)
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
              f"pass) kernel_steps={kernel_steps} (device records {fsm}, "
              f"profiled pass) "
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


#: Phase 9 (f): the benchmark cells' FSM loops, (SF, lanes): fsm64.collide's
#: SF8 loop and fsm64.sparse's SF12 one.
FSM_STEP_SHAPES = ((8, 128), (12, 16))


def _fsm_step_case(sf: int, lanes: int, dev):
    """(config, demod, iq [lanes, window, 2] on ``dev``): fsm64's LoRa
    settings at ``sf`` and one packet a lane at a seeded place in the
    triggered receiver's event window, in noise of sigma 0.003."""
    import torch

    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.dist.triggered import scan_window
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg = LoraConfig(sf=sf, cr=1, crc=True, ldr=sf >= 11,
                     explicit_header=True, p=2, fft_factor=8, threshold=5.0)
    n, win = cfg.num_samples, scan_window(cfg)
    rng = np.random.default_rng(sf)
    iq = (0.003 * (rng.standard_normal((lanes, win))
                   + 1j * rng.standard_normal((lanes, win)))).astype(
                       np.complex64)
    for i in range(lanes):
        pkt = 0.15 * modulate(encode(bytes([sf, i % 256, 1, 2]), cfg), cfg,
                              pad_front=0, pad_back=0)
        o = 2 * n + int(rng.integers(0, n))
        iq[i, o:o + len(pkt)] += pkt
    return cfg, demod_fn(cfg, win, 2, dev), torch.from_numpy(to_ri(iq)).to(
        dev)


#: Per-lane state the FSM step reads and writes whole each step: every
#: field but the symbol and output slots (written one entry at a time).
_FSM_SLOTS = ("syms", "out_syms", "out_len", "out_pos", "out_snr")


def _fsm_bounds(cfg, lanes: int, state) -> dict:
    """The least time a step of ``lanes`` lanes could take on the card
    (``_bound``), for a lane outside S_SFD_SYNC (nearly every lane-step):
    ``step``: what the function needs — the window read once (8 n B, the
    chirp once for all lanes) and the per-lane state read and written
    once; the window's spectrum on the F-point grid as fft_factor zoomed
    n-point FFTs (5 F log2 n f32 operations, 6 F for the zoom's twiddles),
    the dechirp (6 n) and the fold and search of its 2 K bins (10 K).
    ``design``: the current design, three zero-padded F-point FFT rows
    each read and written once (48 F B, 15 F log2 F operations) besides
    the window read and the up row written (16 n) and the fold's two
    bands (16 K).  And each kernel's own bytes: ``fsm_win`` the three
    words that say a lane is idle, ``fsm_sfd`` the window read and the up
    row written, ``fsm_update`` the two bands and the state."""
    n, f, k = cfg.num_samples, cfg.fft_size, cfg.bin_size
    words = sum(getattr(state, name)[0].numel()
                * getattr(state, name).element_size()
                for name in state._fields if name not in _FSM_SLOTS)
    fold = 10 * k
    return {
        "step": _bound(lanes * (8 * n + 2 * words) + 8 * n, f32_ops=lanes * (
            5 * f * math.log2(n) + 6 * f + 6 * n + fold)),
        "design": _bound(lanes * (16 * n + 48 * f + 16 * k + 2 * words),
                         f32_ops=lanes * (15 * f * math.log2(f) + 18 * n
                                          + fold)),
        "fsm_win": _bound(lanes * 12),
        "fsm_sfd": _bound(lanes * (16 * n + 12)),
        "fsm_update": _bound(lanes * (16 * k + 2 * words)),
    }


def fsm_step_timing(dev, card: str, report: dict | None = None) -> None:
    """Phase 9f: the demod machine's step at FSM_STEP_SHAPES, through the
    kernels (csrc/fsm_step.cu around cuFFT) and through the plain body:
    each loop run whole, replayed as CUDA graphs (ms a step: the run's
    CUDA-event time over its steps, the least of 3 runs), and 32 steps
    from the start launch by launch; kernels a step from 32 profiled eager
    steps; one profiled replayed run of the kernel loop gives the device
    ms a step of each fsm kernel and of each kind of the rest.  The kernel
    loop's and the plain loop's final states must be equal (snr within
    1e-6).  Prints the step's bounds (``_fsm_bounds``); with ``report``,
    appends each kernel's row at each shape to it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gr_lora_tpu_torch.models.fsm_loop import STEPS, StepLoop
    from gr_lora_tpu_torch.ops import fsm_step

    def timed(run) -> float:
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def device_ms(run) -> tuple[dict, int]:
        """({fsm kernel, or _KINDS kind: device ms}, device records) of
        run(), profiled."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out, records = {}, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            key = _fsm_kernel(e.name()) or _kind(e.name())
            out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6
            records += 1
        return out, records

    for sf, lanes in FSM_STEP_SHAPES:
        cfg, fn, x = _fsm_step_case(sf, lanes, dev)
        n = cfg.num_samples
        init = fn.init_state(lanes, -fn.pad_front, fn.pad_front, dev)
        kern = fn.make_loop(lanes)
        plain = StepLoop(fn.body, init, fn.buf_len, n, fn.max_iters)
        if kern.kernel is None or plain.kernel is not None:
            fail(f"FSM step SF{sf}: the loops do not step as asked")
        replayed, final = {}, {}
        for name, loop in (("kernel", kern), ("plain", plain)):
            fn.run(loop, x)                       # capture
            ms = min(timed(lambda: fn.run(loop, x)) for _ in range(3))
            replayed[name] = ms / loop.steps
            final[name] = [t.clone() for t in loop.state]
        err = 0.0
        for field, a, b in zip(init._fields, final["plain"],
                               final["kernel"]):
            same = torch.allclose(a, b, rtol=1e-6, atol=0.0) \
                if field in ("snr", "out_snr") else torch.equal(a, b)
            if not same:
                fail(f"FSM step SF{sf} x {lanes}: {field} differs")
            if a.is_floating_point():
                err = max(err, float((a - b).abs().max()))
        packets = int(kern.state.out_cnt.clamp(max=2).sum())
        loops = {"kernel": fn.make_loop(lanes, graphed=False),
                 "plain": StepLoop(fn.body, init, fn.buf_len, n,
                                   fn.max_iters, graphed=False)}
        eager = {}
        for name, loop in loops.items():
            loop.iq.copy_(kern.iq)
            loop._load(init)
            eager[name] = timed(loop._steps) / STEPS
        before = fsm_step.launches
        loops["kernel"]._load(init)
        _, records = device_ms(loops["kernel"]._steps)
        launches = (fsm_step.launches - before) / STEPS
        per, _ = device_ms(lambda: fn.run(kern, x))
        per_step = {k: round(v / kern.steps, 5) for k, v in sorted(
            per.items(), key=lambda kv: -kv[1])}
        bounds = _fsm_bounds(cfg, lanes, kern.state)
        step_ms = replayed["kernel"]
        if report is not None:
            for name in FSM_KERNELS:
                row = _row(err, per[name] / kern.steps, replayed["plain"],
                           f"SF{sf} x {lanes} lanes, {kern.steps} steps",
                           bounds[name], per.get("cuFFT", 0.0) / kern.steps)
                row.update(step_ms=step_ms, step_bound_ms=bounds["step"][0],
                           design_bound_ms=bounds["design"][0])
                report[name].append(row)
        print(f"fsm step SF{sf} x {lanes} lanes (fsm64: p2 ff8 explicit"
              f"{' LDR' if cfg.ldr else ''}, window {fn.num_samples_total}) "
              f"on {card}: steps={kern.steps} packets={packets}/{lanes} "
              f"states equal; ms_per_step kernel replayed="
              f"{replayed['kernel']:.5f} eager={eager['kernel']:.5f} | "
              f"plain replayed={replayed['plain']:.5f} eager="
              f"{eager['plain']:.5f} (x{replayed['plain'] / replayed['kernel']:.1f}"
              f" replayed) kernels_per_step={records / STEPS:.1f} (fsm "
              f"launches {launches:.0f}) "
              "device_ms_per_step[" + ", ".join(
                  f"{k} {v:.5f}" for k, v in per_step.items()) + "] "
              f"max_abs_err={err:.3g} bound_ms_per_step: the function "
              f"{bounds['step'][0]:.6f} ({bounds['step'][1]}, "
              f"x{step_ms / bounds['step'][0]:.1f} measured), the design "
              f"{bounds['design'][0]:.6f} ({bounds['design'][1]}, "
              f"x{step_ms / bounds['design'][0]:.1f})")


def fsm_phase(iq_dev, singles, dev, card: str, report: dict,
              launches: dict) -> None:
    """Phase 9: the FSM receive path (no kernel of the nine runs here; the
    demod machine's step kernels do, counted from 9a-9c into
    ``launches``, 9f's rows into ``report``)."""
    marks = [time.perf_counter()]
    cfg = fsm_config()
    iq, offs, plen, ref = fsm_gateway(cfg, dev, card, launches)
    marks.append(time.perf_counter())
    fsm_receivers(iq_dev, singles, dev, card, launches)
    marks.append(time.perf_counter())
    fsm_streaming(cfg, iq, offs, plen, ref, dev, card)
    marks.append(time.perf_counter())
    fsm_weak_loopback(dev, card)
    marks.append(time.perf_counter())
    fsm_step_timing(dev, card, report)
    marks.append(time.perf_counter())
    parts = np.diff(marks)
    print(f"fsm phase 9 total_s={marks[-1] - marks[0]:.2f} (9a "
          f"{parts[0]:.1f}, 9b+9c {parts[1]:.1f}, 9d {parts[2]:.1f}, 9e "
          f"{parts[3]:.1f}, 9f {parts[4]:.1f})")


#: Phase 10: the wideband north star — one SDR stream of 64 x 125 kHz
#: channels at 8 Msps (the channelizer docstring's own case), p 2, SF7-12.
WB_FS = 8e6
WB_SPACING = 125e3
WB_SAMPLES = 1 << 25             # 4.19 s of air, 2^20 samples a channel
WB_BLOCK = 1 << 21               # apps/gateway.py's --block default
WB_NOISE = 0.01
PAIR_AMPS = (0.4, 0.18)          # tests/test_wideband_e2e.py's pair
SINGLE_AMP = 0.4
CHANNELIZER_TIMED = 10


@dataclasses.dataclass(frozen=True)
class Injected:
    channel: int
    sf: int
    offset: int                  # packet start, channel-rate samples
    pdu: str                     # the decoded PDU's hex
    kind: str                    # "single", or "strong" / "weak" of a pair


GOLDEN_PAIR = (bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5))


def _pair_offset(cfg8) -> int:
    """The pair's second packet after its first (channel-rate samples):
    tests/test_wideband_e2e.py's offset."""
    n8 = cfg8.num_samples
    return 16 * n8 + 4 * n8 // 8 + 204


def wideband_capture(dev):
    """The wideband capture: on every channel one SF8 collision pair
    (channel 1's the golden pair) and one single at SF SFS[c % 6],
    synthesised at the wideband rate (modulate at p = 2 x decimation),
    mixed to channel_frequencies(channels) on ``dev``, plus noise 0.01
    from default_rng(1), so that the capture can be made again off the
    card.  The four fixture rules: payloads differ
    across channels; every payload's symbols hold no two equal adjacent
    symbols (candidates drawn from default_rng(0), kept when ``encode``
    passes); no two packets of the same SF on adjacent channels overlap
    in time and no single overlaps its own channel's pair; payloads are
    4-8 bytes.  The schedule is fixed before any draw (from 8-byte
    packets): adjacent channels' pairs (all SF8) take alternate time
    slots, and the singles follow every pair, one channel after another
    at a fixed stride, so adjacent singles (SFS[c % 6] differs from its
    neighbours' SF, across Nyquist too) may overlap in time.
    Returns (complex64 host capture, [Injected])."""
    import torch

    from gr_lora_tpu_torch.core.codec import decode, encode
    from gr_lora_tpu_torch.models.modulator import modulate

    channels, fs, samples = CHANNELS, WB_FS, WB_SAMPLES
    if abs(fs - channels * WB_SPACING) > 1e-6:
        fail(f"the capture needs fs = channels x spacing, got {fs}")
    up = int(round(fs / (2 * WB_SPACING)))   # wideband samples a p=2 sample
    base = base_config()
    cfgs = {sf: base.replace(sf=sf, ldr=(1 << sf) / WB_SPACING > 16e-3)
            for sf in SFS}

    def longest(sf):                         # an 8-byte packet, p 2
        cfg = cfgs[sf]
        return len(modulate(encode(bytes(8), cfg), cfg, p=2, pad_front=0,
                            pad_back=0))

    n8 = cfgs[8].num_samples
    off2 = _pair_offset(cfgs[8])
    span, gap = off2 + longest(8), 4 * n8
    pair0 = [1000 + (c % 2) * (span + gap) for c in range(channels)]
    slot0 = 1000 + 2 * (span + gap)
    total = samples // up
    stride = (total - slot0 - longest(12) - 4 * cfgs[12].num_samples) \
        // channels
    if stride <= 0:
        fail(f"{samples} samples cannot hold the capture's schedule")
    single0 = [slot0 + c * stride for c in range(channels)]
    sf_of = [SFS[c % len(SFS)] for c in range(channels)]
    if any(sf_of[c] == sf_of[(c + 1) % channels] for c in range(channels)):
        fail("adjacent channels' singles share an SF")

    rng = np.random.default_rng(0)
    used = set(GOLDEN_PAIR)

    def draw(cfg):
        while True:
            pl = bytes(rng.integers(0, 256, int(rng.integers(4, 9)),
                                    dtype=np.uint8))
            syms = encode(pl, cfg)
            if pl not in used and not np.any(syms[1:] == syms[:-1]):
                used.add(pl)
                return pl

    noise = np.random.default_rng(1).standard_normal((samples, 2),
                                                     dtype=np.float32)
    wide = torch.view_as_complex(torch.from_numpy(WB_NOISE * noise).to(dev))
    del noise
    injected = []
    for c in range(channels):
        pair = GOLDEN_PAIR if c == 1 else (draw(cfgs[8]), draw(cfgs[8]))
        single = draw(cfgs[sf_of[c]])
        for sf_k, pl, amp, off, kind in (
                (8, pair[0], PAIR_AMPS[0], pair0[c], "strong"),
                (8, pair[1], PAIR_AMPS[1], pair0[c] + off2, "weak"),
                (sf_of[c], single, SINGLE_AMP, single0[c], "single")):
            cfg = cfgs[sf_k]
            syms = encode(pl, cfg)
            pkt = torch.from_numpy(modulate(syms, cfg, p=2 * up, pad_front=0,
                                            pad_back=0)).to(dev)
            lo = off * up
            idx = torch.arange(lo, lo + len(pkt), device=dev)
            # Channel c's carrier (c - C/2) / C turns a sample: exact in
            # integers.
            k = torch.remainder((c - channels // 2) * idx, channels)
            carrier = torch.polar(torch.ones_like(idx, dtype=torch.float64),
                                  (2 * np.pi / channels) * k.double())
            wide[lo:lo + len(pkt)] += (amp * pkt) * carrier.to(
                torch.complex64)
            injected.append(Injected(c, sf_k, off, bytes(
                decode(syms, cfg).payload).hex(), kind))
    return wide.cpu().numpy(), injected


def _udp_datagrams(port) -> list:
    """Every datagram waiting on a UdpPduPort as (ch, sf, position, hex)."""
    import socket

    got = []
    port.sock.settimeout(0.5)
    try:
        while True:
            data, _ = port.sock.recvfrom(65536)
            got.append((data[0], data[1],
                        int.from_bytes(data[2:6], "little"), data[6:].hex()))
    except socket.timeout:
        pass
    return got


def _check_injected(got, injected, what: str, every: bool = True,
                    strict_pos: bool = True):
    """No injected packet more than once in ``got`` (with ``every``,
    each exactly once) on its channel and SF, and (with ``strict_pos``)
    each 0-10 symbols after its start.  Fails listing every packet that
    is not, with the datagrams of its SF and PDU on any channel.
    Returns (the injected packets decoded, the datagrams that match no
    injected packet)."""
    want = {(p.channel, p.sf, p.pdu) for p in injected}
    problems, decoded = [], []
    for p in injected:
        m = [g for g in got if (g[0], g[1], g[3]) == (p.channel, p.sf, p.pdu)]
        n = (1 << p.sf) * 2
        if len(m) > 1 or (every and not m):
            elsewhere = [g for g in got if (g[1], g[3]) == (p.sf, p.pdu)]
            problems.append(f"{p} arrived {len(m)} times; its PDU at SF"
                            f"{p.sf} on any channel: {elsewhere}")
        elif m and strict_pos and not 0 <= m[0][2] - p.offset <= 10 * n:
            problems.append(f"{p} at {m[0][2]}, not within 10 symbols "
                            f"after {p.offset}")
        if m:
            decoded.append(p)
    if problems:
        for line in problems:
            print(f"{what}: {line}", file=sys.stderr)
        fail(f"{what}: {len(problems)} of {len(injected)} injected packets "
             f"not {'exactly' if every else 'at most'} once")
    return decoded, [g for g in got if (g[0], g[1], g[3]) not in want]


def _yield(decoded, injected) -> str:
    """decoded / injected, by single SF and by the pairs' packets."""
    def count(pred):
        return (sum(1 for p in decoded if pred(p)),
                sum(1 for p in injected if pred(p)))

    parts = [f"single SF{sf} {{}}/{{}}".format(
        *count(lambda p, sf=sf: p.kind == "single" and p.sf == sf))
        for sf in SFS]
    parts += [f"pair {kind} {{}}/{{}}".format(
        *count(lambda p, kind=kind: p.kind == kind))
        for kind in ("strong", "weak")]
    return (f"yield {len(decoded)}/{len(injected)} ("
            f"{', '.join(parts)})")


def _wide_gateway(dev, backend: str, tracker: str = "host"):
    """The gated gateway of phase 10's chains, as ``apps.gateway
    --collision --max-payload-len 16 [--tracker device]`` builds it."""
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway

    return TriggeredPyramidGateway(base_config(), CHANNELS,
                                   sfs=SFS, max_payload_len=16,
                                   backend=backend, tracker=tracker,
                                   device=dev)


def _kernel_mods(gw) -> dict:
    """{"rdft_peaks": [K1 modules], "overlap_peaks": [K2 modules]} of a
    gated gateway's lattices."""
    from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
    from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks

    kinds = {"rdft_peaks": RdftPeaks, "overlap_peaks": OverlapPeaks}
    return {name: [m for sf in SFS for m in gw.lattice(sf).modules()
                   if isinstance(m, cls)] for name, cls in kinds.items()}


def _hand_chain(path: str, gw, dev, udp=None):
    """RingIngest(capture, WB_BLOCK) -> StreamingChannelizer ->
    ``gw`` -> the app's power track and dedupe (apps.gateway.decode_stream)
    -> PduSink (-> UDP).  Returns (sink, wall s)."""
    import torch

    from gr_lora_tpu_torch.apps.gateway import decode_stream
    from gr_lora_tpu_torch.dist.pdu_sink import PduSink
    from gr_lora_tpu_torch.pipeline.channelizer import StreamingChannelizer
    from gr_lora_tpu_torch.pipeline.ingest import RingIngest

    sink = PduSink(udp=udp, crc_filter=True)
    chan = StreamingChannelizer(CHANNELS, WB_FS, WB_SPACING, p=2, device=dev)
    with open(path, "rb") as f:
        t0 = time.perf_counter()
        decode_stream(RingIngest(f, WB_BLOCK).blocks(), chan, gw, sink, SFS,
                      2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sink.close()
    if chan.out_pos < WB_SAMPLES // chan.decim:
        fail(f"the hand chain channelized {chan.out_pos} samples a channel "
             f"of the capture's {WB_SAMPLES // chan.decim}")
    return sink, wall


def wideband_channelizer(wide, dev, card: str) -> None:
    """Phase 10a: channelize on the card against a float64 NumPy
    evaluation, its TF32 pinning (and fir_filter's), the streaming
    channelizer against whole-block calls, and its samples/s."""
    import torch

    from gr_lora_tpu_torch.pipeline.channelizer import (StreamingChannelizer,
                                                        _channelizer_plan,
                                                        channelize)
    from gr_lora_tpu_torch.pipeline.frontend import design_low_pass, fir_filter

    ri = wide.view(np.float32).reshape(-1, 2)
    blk = torch.from_numpy(ri[:WB_BLOCK]).to(dev)
    y = channelize(blk, CHANNELS, WB_FS, device=dev)
    decim = int(round(WB_FS / (2 * WB_SPACING)))
    packed, w, offs = _channelizer_plan(CHANNELS, decim, 16,
                                        WB_SPACING / WB_FS)
    m = y.shape[1]
    frames = np.lib.stride_tricks.sliding_window_view(
        ri[:WB_BLOCK].astype(np.float64), w, axis=0)[::decim][:m]
    ref = frames.reshape(m, 2 * w) @ packed.astype(np.float64)  # [M, 2W]
    ref = ref[:, :CHANNELS] + 1j * ref[:, CHANNELS:]
    turns = (np.arange(m)[:, None] * decim) * offs[None, :]
    ref = (ref * np.exp(-2j * np.pi * (turns - np.floor(turns)))).T
    got = y.cpu().numpy()
    peak = float(np.abs(ref).max())
    err64 = float(np.abs(got[..., 0] + 1j * got[..., 1] - ref).max()) / peak
    if err64 > 1e-5:
        fail(f"channelize differs from its float64 evaluation by {err64} "
             "of its peak")

    taps = design_low_pass(1.0, 1e6, 125e3 / 2 + 10e3, 1e3)   # rx_file's
    x1 = torch.from_numpy(ri[:1 << 20]).to(dev)
    pinned = (y, fir_filter(x1, taps, dev))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        loose = (channelize(blk, CHANNELS, WB_FS, device=dev),
                 fir_filter(x1, taps, dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf32 = [float((a - b).abs().max() / a.abs().max())
            for a, b in zip(pinned, loose)]
    if max(tf32) > 1e-6:
        fail(f"the front end follows the TF32 flags: {tf32} of the peak")

    seg = min(4 * WB_BLOCK, len(ri))
    whole = channelize(torch.from_numpy(ri[:seg]).to(dev), CHANNELS, WB_FS,
                       device=dev)
    sc = StreamingChannelizer(CHANNELS, WB_FS, device=dev)
    outs, lo = [], 0
    for size in (7, 1111, WB_BLOCK // 2 + 3, 13, 3 * WB_BLOCK // 2 - 5, seg):
        outs.append(sc.feed(ri[lo:min(lo + size, seg)]))
        lo += size
        if lo >= seg:
            break
    streamed = torch.cat(outs, dim=1)
    k = min(whole.shape[1], streamed.shape[1])
    stream_err = float((streamed[:, :k] - whole[:, :k]).abs().max())
    if k < whole.shape[1] - 1 or stream_err > 1e-5:
        fail(f"the streaming channelizer differs from the whole call: "
             f"{stream_err} over {k} of {whole.shape[1]} samples")
    del whole, streamed, outs

    blocks = [torch.from_numpy(ri[i * WB_BLOCK:(i + 1) * WB_BLOCK]).to(dev)
              for i in range(CHANNELIZER_TIMED)]
    channelize(blocks[0], CHANNELS, WB_FS, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in blocks:
        channelize(b, CHANNELS, WB_FS, device=dev)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / CHANNELIZER_TIMED
    print(f"wideband 10a channelizer {CHANNELS}ch at {WB_FS:.0f} sps, "
          f"W={w}, block {WB_BLOCK} on {card}: max_err_vs_f64="
          f"{err64:.3e} of peak, tf32_flags_on_delta channelize="
          f"{tf32[0]:.3e} fir_filter(3301 taps)={tf32[1]:.3e}, "
          f"streamed_vs_whole={stream_err:.3e} over {k} samples, "
          f"ms_per_block={ms:.4f} samples_per_s={WB_BLOCK / ms * 1e3:.1f} "
          f"x_realtime={WB_BLOCK / ms * 1e3 / WB_FS:.2f}")


def _chain_datagrams(path: str, gw, dev):
    """The hand chain (``_hand_chain``) into UDP on an ephemeral port:
    (its datagrams, the sink, wall s)."""
    from gr_lora_tpu_torch.apps.common import UdpPduPort

    rx = UdpPduPort(listen_port=0)
    sink, wall = _hand_chain(path, gw, dev,
                             udp=("127.0.0.1", rx.sock.getsockname()[1]))
    got = _udp_datagrams(rx)
    rx.close()
    return got, sink, wall


def _keyed(dgrams) -> dict:
    out = {}
    for ch, sf, pos, hx in dgrams:
        out.setdefault((ch, sf, hx), []).append(pos)
    return out


def _same_datagrams(got, ref, what: str) -> None:
    """The same (channel, sf, payload) datagrams, each position within one
    hop (tests/test_torch_collision_gateway.py's convention)."""
    ours, theirs = _keyed(got), _keyed(ref)
    if set(ours) != set(theirs):
        fail(f"{what}: different datagrams "
             f"{sorted(set(ours) ^ set(theirs))}")
    for key, pos in ours.items():
        hop = (1 << key[1]) * 2 // 8
        if len(pos) != len(theirs[key]) or any(
                abs(a - b) > hop for a, b in zip(sorted(pos),
                                                 sorted(theirs[key]))):
            fail(f"{what}: {key} at {pos} and at {theirs[key]}")


def wideband_chain(path: str, injected, dev, card: str, launches: dict):
    """Phase 10b: the slice's main path, the hand chain at ``fused`` (K1
    at SF7-9, K2 at SF10-12): no injected packet twice, each on its
    channel and SF within 10 symbols of its start, the golden pair
    decoded, and the yield (decoded / injected) printed: the Pyramid
    decoder does not decode every random pair or single (ROADMAP Queue
    3), so all 192 once is not asserted.  Returns the UDP datagrams."""
    gw = _wide_gateway(dev, "fused")
    mods = _kernel_mods(gw)
    for ms in mods.values():
        for m in ms:
            m.launches = 0
    gw.wall_reset()
    got, sink, wall = _chain_datagrams(path, gw, dev)
    counts = {name: sum(m.launches for m in ms) for name, ms in mods.items()}
    for name, count in counts.items():
        if count <= 0:
            fail(f"wideband chain: kernel {name} was not launched")
        launches[name] += count
    decoded, extra = _check_injected(got, injected, "wideband chain",
                                     every=False)
    _check_injected(got, [p for p in injected if p.channel == 1 and
                          p.kind != "single"], "wideband chain, golden pair")
    air = WB_SAMPLES / WB_FS
    w = gw.wall
    print(f"wideband 10b hand chain ring -> channelizer -> gated gateway "
          f"(fused) -> dedupe -> PduSink -> UDP, {CHANNELS}ch x SF7-12, "
          f"{WB_SAMPLES} samples ({air:.2f} s of air) on {card}: "
          f"wall={wall:.4f} s x_realtime={air / wall:.3f} "
          f"gateway_wall[ingest={w['ingest']:.4f} scan={w['scan']:.4f} "
          f"lattice={w['lattice']:.4f} tracker={w['tracker']:.4f} "
          f"decode={w['decode']:.4f}] sink={sink.stats()} "
          f"datagrams={len(got)} {_yield(decoded, injected)}, none twice, "
          f"golden pair decoded, launches={counts}")
    missed = [p for p in injected if p not in decoded]
    for p in missed:
        print(f"wideband 10b not decoded: {p}")
    for g in extra:
        print(f"wideband 10b extra datagram: {g}")
    return got


def _cli(argv, dev):
    """(exit code, UDP datagrams, wall s, stats line) of one
    apps.gateway.main run."""
    import contextlib
    import io

    import torch

    from gr_lora_tpu_torch.apps import gateway
    from gr_lora_tpu_torch.apps.common import UdpPduPort

    rx = UdpPduPort(listen_port=0)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = gateway.main(argv + ["--udp",
                                  f"127.0.0.1:{rx.sock.getsockname()[1]}"],
                          device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _udp_datagrams(rx)
    rx.close()
    return rc, got, wall, err.getvalue().strip()


def wideband_cli(path: str, injected, chain, dev, card: str) -> None:
    """Phase 10c: apps.gateway.main on the same capture.  With
    --collision its engine runs the gateway's default backend, ``xla``:
    the CLI must give the datagrams of the hand chain at that backend, no
    injected packet twice and each within 10 symbols of its start; its
    differences from 10b (``fused``) are printed, since the two backends
    can decode different packets in both packages (ROADMAP Queue 3).
    With the FSM engine: every single exactly once."""
    argv = [path, "--samp-rate", str(WB_FS), "--channels", str(CHANNELS),
            "--sfs", ",".join(map(str, SFS)), "--quiet"]
    air = WB_SAMPLES / WB_FS
    hand_xla, _, hand_wall = _chain_datagrams(path, _wide_gateway(dev, "xla"),
                                              dev)
    rc, got, wall, stats = _cli(argv + ["--collision", "--max-payload-len",
                                        "16"], dev)
    if rc != 0:
        fail(f"gateway --collision exited {rc}: {stats}")
    _same_datagrams(got, hand_xla, "gateway --collision vs the hand chain "
                                   "at xla")
    decoded, _ = _check_injected(got, injected, "gateway --collision",
                                 every=False)
    cli, fused = set(_keyed(got)), set(_keyed(chain))
    print(f"wideband 10c gateway --collision (backend xla) on {card}: "
          f"datagrams={len(got)} equal to the hand chain at xla (its wall "
          f"{hand_wall:.4f} s), {_yield(decoded, injected)}, none twice; "
          f"vs 10b (fused): only fused {sorted(fused - cli)}, only xla "
          f"{sorted(cli - fused)}; wall={wall:.4f} s "
          f"x_realtime={air / wall:.3f} ({stats})")

    rc, got, wall, stats = _cli(argv, dev)
    if rc != 0:
        fail(f"gateway (FSM engine) exited {rc}: {stats}")
    singles = [p for p in injected if p.kind == "single"]
    _, extra = _check_injected(got, singles, "gateway (FSM)",
                               strict_pos=False)
    pairs = {(p.channel, p.sf, p.pdu) for p in injected
             if p.kind != "single"}
    coll = [g for g in extra if (g[0], g[1], g[3]) in pairs]
    offs = [g[2] - p.offset for p in singles for g in got
            if (g[0], g[1], g[3]) == (p.channel, p.sf, p.pdu)]
    print(f"wideband 10c gateway (FSM engine) on {card}: "
          f"datagrams={len(got)} singles={len(singles)}/{len(singles)} "
          f"position offsets [{min(offs)}, {max(offs)}] samples, collision "
          f"PDUs={len(coll)} of {len(pairs)} (not asserted), other="
          f"{len(extra) - len(coll)}, wall={wall:.4f} s "
          f"x_realtime={air / wall:.3f} ({stats})")


def _app_out(main, argv, dev) -> str:
    """stdout of one app's main(argv, device=dev); fails on a non-zero
    exit."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, device=dev)
    if rc != 0:
        fail(f"{main.__module__} {argv} exited {rc}: {out.getvalue()}")
    return out.getvalue()


def reference_flowgraphs(tmp: str, dev, card: str) -> None:
    """Phase 10d: tx_file then rx_file (the golden single) and tx_file
    with two payloads then rx_file_collision (the weak packet) at 1 Msps,
    as tests/test_apps.py runs them, and rx_stream over a 250 ksps capture
    through the ring."""
    import os

    from gr_lora_tpu_torch.apps import (rx_file, rx_file_collision,
                                        rx_stream, tx_file)
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate

    golden = " ".join(PDU1[i:i + 2] for i in range(0, len(PDU1), 2))
    t0 = time.perf_counter()
    single = os.path.join(tmp, "single.cf64")
    _app_out(tx_file.main, [single, "--payload", "010203040506",
                            "--amplitude", "0.3"], dev)
    if golden not in _app_out(rx_file.main, [single], dev):
        fail("rx_file did not print the golden PDU")
    t1 = time.perf_counter()
    coll = os.path.join(tmp, "collision.cf64")
    _app_out(tx_file.main, [coll, "--payload", "010203040506", "--payload",
                            "0707070707", "--offset", "0", "--offset",
                            "19.72265625", "--amplitude", "0.25",
                            "--amplitude", "0.12"], dev)
    if "07 07 07 07 07" not in _app_out(rx_file_collision.main, [coll], dev):
        fail("rx_file_collision did not recover the weak packet")
    t2 = time.perf_counter()
    cfg = base_config()
    stream = os.path.join(tmp, "stream.cf64")
    np.asarray(0.5 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg),
               np.complex64).tofile(stream)
    if golden not in _app_out(rx_stream.main, [stream, "--chunk", "4096"],
                              dev):
        fail("rx_stream did not print the golden PDU")
    t3 = time.perf_counter()
    print(f"wideband 10d reference flowgraphs on {card}: tx_file + rx_file "
          f"golden single {t1 - t0:.2f} s, tx_file + rx_file_collision weak "
          f"packet {t2 - t1:.2f} s, rx_stream through the ring "
          f"{t3 - t2:.2f} s")


def _device_names(prof, top: int = 10) -> list:
    """The ``top`` largest (device ms, records, name) sums of ``prof``'s
    raw trace."""
    from torch.autograd import DeviceType

    ns, count = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns[e.name()] = ns.get(e.name(), 0) + e.duration_ns()
            count[e.name()] = count.get(e.name(), 0) + 1
    return sorted(((v / 1e6, count[k], k) for k, v in ns.items()),
                  reverse=True)[:top]


def _host_copies(prof, tmp: str) -> dict:
    """{"Memcpy HtoD (... -> Device)": [bytes of each record]} of
    ``prof``'s host-to-device copies, from its Chrome trace (the raw
    trace's events carry no byte counts); None where a record has none."""
    import os

    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("Memcpy HtoD"):
            out.setdefault(name, []).append(e.get("args", {}).get("bytes"))
    return out


def wideband_profile(path: str, tmp: str, dev, card: str) -> None:
    """Phase 10e: one pass of the hand chain under torch.profiler: device
    busy and idle shares, the ten largest device-time entries, and every
    host-to-device copy by kind: no block pinned on the host
    (``aten::pin_memory``) or copied from pinned memory more than once,
    and no block-sized copy from pageable memory.  Some full runs'
    traces hold one block-sized pinned copy fewer than the blocks the
    host pinned (15 of 16), so fewer is printed, not failed;
    ``_hand_chain`` checks that every block reached the channelizer.  The fresh
    gateway's other copies are the constants of its scan and lattice
    modules, built on their first use."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gw = _wide_gateway(dev, "fused")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _hand_chain(path, gw, dev)
    busy, records, _ = _device_time(prof)
    top = "; ".join(f"{ms:.2f} ({k}x) {_kernel_name(name)[:60]}"
                    for ms, k, name in _device_names(prof))
    copies = _host_copies(prof, tmp)
    if any(b is None for sizes in copies.values() for b in sizes):
        fail(f"10e: a host-to-device copy carries no byte count: {copies}")
    blocks = -(-WB_SAMPLES // WB_BLOCK)
    ups = {name: sizes.count(8 * WB_BLOCK) for name, sizes in copies.items()}
    pinned = ups.get("Memcpy HtoD (Pinned -> Device)", 0)
    pins = sum(1 for e in prof.profiler.kineto_results.events()
               if e.name() == "aten::pin_memory")
    if pins > blocks or pinned > blocks or sum(ups.values()) != pinned:
        fail(f"10e: {blocks} blocks, {pins} pin_memory calls, block-sized "
             f"copies by kind: {ups}")
    listed = "; ".join(f"{name}: {len(sizes)} records, {sum(sizes)} bytes, "
                       f"largest {sorted(sizes)[-3:]}"
                       for name, sizes in sorted(copies.items()))
    print(f"wideband 10e profiled hand-chain pass on {card}: wall="
          f"{wall:.4f} s device_busy={busy:.2f} ms "
          f"({100 * busy / (1e3 * wall):.1f} %) idle="
          f"{100 - 100 * busy / (1e3 * wall):.1f} % records={records}; "
          f"top device ms: {top}; host-to-device copies: {listed}; "
          f"{pins} blocks pinned on the host, block-sized copies traced: "
          f"{pinned} pinned, none pageable")


def wideband_phase(dev, card: str, launches: dict, tmp: str):
    """Phase 10: the wideband north star, one SDR stream end to end.  The
    capture is written to ``tmp``; returns (its path, the injected
    packets) for phase 11e."""
    import os

    import torch

    marks = [time.perf_counter()]
    wide, injected = wideband_capture(dev)
    print(f"wideband capture {CHANNELS}ch x SF7-12, {WB_SAMPLES} samples at "
          f"{WB_FS:.0f} sps: {len(injected)} packets, payloads drawn from "
          "default_rng(0) under the four fixture rules")
    path = os.path.join(tmp, "wideband.cf64")
    wide.tofile(path)
    marks.append(time.perf_counter())
    with torch.no_grad():
        wideband_channelizer(wide, dev, card)
    del wide
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    chain = wideband_chain(path, injected, dev, card, launches)
    marks.append(time.perf_counter())
    wideband_cli(path, injected, chain, dev, card)
    marks.append(time.perf_counter())
    reference_flowgraphs(tmp, dev, card)
    marks.append(time.perf_counter())
    wideband_profile(path, tmp, dev, card)
    marks.append(time.perf_counter())
    parts = np.diff(marks)
    print(f"wideband phase 10 total_s={marks[-1] - marks[0]:.2f} (capture "
          f"{parts[0]:.1f}, 10a {parts[1]:.1f}, 10b {parts[2]:.1f}, 10c "
          f"{parts[3]:.1f}, 10d {parts[4]:.1f}, 10e {parts[5]:.1f})")
    return path, injected


#: Phase 11d's soak: the traffic of the JAX package's long soak (bench.py
#: --mode soak, :1080-1084: seed 11, 2 % duty, a golden collision every
#: third SF8 injection, noise 0.002) in the product config (split_repeats,
#: uncurated payloads), TRACKER_SOAK_CHANNELS channels at SF7-8 streamed
#: in TRACKER_SOAK_CHUNKS chunks of 96 SF8 symbols (the CPU soak tests'
#: chunking: a ring trim every feed).
TRACKER_SOAK = dict(seed=11, duty_target=0.02, collision_every=3,
                    noise_sigma=0.002)
TRACKER_SOAK_CHANNELS = 16
TRACKER_SOAK_CHUNKS = 384
#: Pools small enough that the deviation counters fire: on the real
#: lattices tracks, packet slots, retirements a hop and symbols a packet
#: (TINY_POOLS), output slots (TINY_OUTPUTS); on the twin lattice, where
#: two packets expire on one hop, expiries a hop (TINY_OUTPUTS).
TINY_POOLS = dict(track_pool=4, packet_pool=1, expire_per_hop=1,
                  max_symbols=8, out_pool=1, finalize_per_hop=1)
TINY_OUTPUTS = dict(out_pool=1, expire_per_hop=1)
#: Pools past a block's shared memory (the walk's global-memory instance):
#: in 11a with split_repeats (291 840 B of rings, t_mid_h and packet
#: entries), on 11c's main path without (packet pool 256: 376 832 B).
LARGE_POOLS = dict(track_pool=256, split_repeats=True)
GLOBAL_POOLS = dict(track_pool=256, packet_pool=256)
#: The walk's chain bound (csrc/device_tracker.cu's head): the critical
#: path of one valid peak (6 dependent integer steps and one warp vote)
#: and of one hop's tail (2 steps and a vote), at the latencies
#: _chain_latencies measures on the card.
CHAIN_PEAK = (6, 1)
CHAIN_TAIL = (2, 1)
#: One warp's dependent chains of each primitive, 16 a loop iteration:
#: the integer step, the vote, redux.sync, the shuffle, the shared load.
LATENCY_CU = r"""
extern "C" __global__ void chains(int iters, int m, int* out,
                                  long long* cyc) {
    __shared__ int s[256];
    const int lane = threadIdx.x;
    for (int i = lane; i < 256; i += 32) s[i] = (i * 7 + 1) & 255;
    __syncwarp();
    int v = lane + m;
    long long t[6];
    t[0] = clock64();
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int u = 0; u < 16; ++u) v = v * 3 + lane;
    t[1] = clock64();
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int u = 0; u < 16; ++u)
            v = (int)__ballot_sync(~0u, v & 1) + lane;
    t[2] = clock64();
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int u = 0; u < 16; ++u) v = __reduce_min_sync(~0u, v) + lane;
    t[3] = clock64();
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int u = 0; u < 16; ++u) v = __shfl_sync(~0u, v, (v + lane) & 31);
    t[4] = clock64();
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int u = 0; u < 16; ++u) v = s[v & 255];
    t[5] = clock64();
    out[lane] = v;
    if (lane == 0)
        for (int i = 0; i < 5; ++i) cyc[i] = t[i + 1] - t[i];
}
extern "C" int run_chains(int iters, void* out, void* cyc) {
    chains<<<1, 32>>>(iters, 77, (int*)out, (long long*)cyc);
    return (int)cudaDeviceSynchronize();
}
"""


def _state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def _same_state(kern: dict, plain: dict, what: str) -> None:
    """Every field of two tracker states equal, the f32 ones bit for
    bit."""
    for name, t in kern.items():
        a, b = t.cpu().numpy(), plain[name].cpu().numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        if not np.array_equal(a, b):
            fail(f"{what}: the tracker kernel's {name} differs from the "
                 f"plain version's at {np.argwhere(a != b)[:4].tolist()}")


def _tracker_lattices(gw, iq_dev, singles, ao_cfg, ao_block):
    """Phase 11a's inputs: (name, config, [C, H, 8] lattice) for phase 5's
    always-on SF8 block (16 channels, 512 hops of K3's lattice, fed as
    two blocks) and one north-star event batch at SF10 (K2) and SF8
    (K1), the windows the gated gateway hands its tracker."""
    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn

    hops = 512
    lat = peak_lattice_fn(ao_cfg, hops, 8, "rdft").to(ao_block.device)
    n = ao_cfg.num_samples
    out = [("always-on SF8 K3", ao_cfg,
            lat(ao_block[:, :hops * n // 8 + n - n // 8]))]
    for sf in (10, 8):
        st = gw.sf_states[sf]
        x = _event_windows(iq_dev, gw, singles, sf, gw.event_batch,
                           gw._win_samples(st))
        out.append((f"north-star SF{sf} {'K1' if sf < 10 else 'K2'}",
                    st.cfg, gw.lattice(sf)(x)))
    return [(name, cfg, tuple(x.contiguous() for x in lat))
            for name, cfg, lat in out]


def _twin_lattice(cfg, channels: int, dev):
    """[C, 200, 8] synthetic lattice: on every channel two packet-shaped
    track runs (a 44-hop preamble, 12 four-hop data symbols) on opposite
    halves of the band with the same timing, so both packets expire on
    one hop (tests/test_torch_device_tracker.py's twin)."""
    import torch

    k = cfg.bin_size
    drift = k // 8
    rng = np.random.default_rng(0)
    bins = np.zeros((channels, 200, 8), np.int32)
    h = np.zeros((channels, 200, 8), np.float32)
    for j in range(2):
        for i in range(44):
            bins[:, 4 + i, j] = (j * (k // 2) + 5 + i * drift) % k
            h[:, 4 + i, j] = 20.0 + 10 * j
        for sym in range(12):
            b = int(rng.integers(0, k // 2)) + j * (k // 2)
            for i in range(4):
                bins[:, 50 + 8 * sym + i, j] = (b + i * drift) % k
                h[:, 50 + 8 * sym + i, j] = 20.0 + 10 * j
    valid = h > 0
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (bins, h, 0.8 * h, valid))


def _max_sm_clock() -> int:
    """The card's top SM clock in MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    try:
        return int(out.stdout.split()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {out.stdout!r} {out.stderr!r}")


def _chain_latencies() -> dict:
    """Cycles of one dependent step of each primitive on the card:
    LATENCY_CU built with nvcc, 1024 x 16 steps a chain; each chain but
    the integer one less the integer step it carries."""
    import ctypes

    import torch

    from gr_lora_tpu_torch.ops import _build

    iters = 1024
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = f"{tmp}/chains.cu", f"{tmp}/chains.so"
        with open(src, "w") as f:
            f.write(LATENCY_CU)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", lib, src],
                       check=True, capture_output=True, timeout=300)
        run = ctypes.CDLL(lib).run_chains
    run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(32, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(5, dtype=torch.int64, device="cuda")
    if run(iters, out.data_ptr(), cyc.data_ptr()):
        fail("the latency chains did not run")
    per = [c / (16 * iters) for c in cyc.tolist()]
    step = per[0]
    return {"int": step, "vote": per[1] - step, "redux": per[2] - step,
            "shfl": per[3] - step, "lds": per[4] - step}


def _chain_cycles(lat: dict) -> tuple[float, float]:
    """(cycles of one peak, of one hop's tail) on the chain bound's
    critical paths at latencies ``lat``."""
    return tuple(n * lat["int"] + v * lat["vote"]
                 for n, v in (CHAIN_PEAK, CHAIN_TAIL))


def _chain_bound_ms(valid, mhz: int, lat: dict) -> tuple[float, int, int]:
    """The walk's chain bound on a [C, H, M] block (csrc/device_tracker.cu's
    head): the busiest channel's valid peaks x one peak's cycles + the
    hops x one tail's cycles at ``mhz``.  Returns (ms, peaks, hops)."""
    peak, tail = _chain_cycles(lat)
    peaks = int(valid.sum(dim=(1, 2)).max())
    hops = valid.shape[1]
    return (peaks * peak + hops * tail) / (mhz * 1e3), peaks, hops


def _tracker_resources() -> list:
    """(instance, ptxas's registers, stack and spills) of each compiled
    instance of the walk kernel, from the build's report."""
    from gr_lora_tpu_torch.ops import _build

    out = []
    for mangled, usage in _build.resources().items():
        m = re.search(r"tracker_kernelILi(\d+)ELb([01])E", mangled)
        if m:
            inst = "shared" if m.group(2) == "1" else "global"
            out.append((f"{inst} N={m.group(1)}", usage))
    if len(out) < 2:
        fail(f"tracker 11a: ptxas reported {len(out)} walk instances")
    return sorted(out)


def tracker_parity(lattices, report: dict) -> None:
    """Phase 11a: the tracker walk kernel against its plain version on the
    card, on each lattice with and without split_repeats, on tiny pools
    and on pools past a block's shared memory (LARGE_POOLS): two
    consecutive blocks (the lattice's halves, the state carried across)
    and the flush, every state field equal bit for bit after each, in the
    instance the wrapper picks (shared memory, or global memory for
    LARGE_POOLS).  Times one kernel call on the first block (CUDA events,
    the state carried on) beside the plain version's, the byte bound and
    the chain bound; at the default pools the global instance too."""
    import torch

    from gr_lora_tpu_torch.models.device_tracker import (_DEVIATION_COUNTERS,
                                                         flush_hops)
    from gr_lora_tpu_torch.ops.device_tracker import TrackerWalk

    mhz = _max_sm_clock()
    steps = _chain_latencies()
    peak_c, tail_c = _chain_cycles(steps)
    print("tracker 11a latencies (cycles a dependent step, measured): "
          + " ".join(f"{k}={v:.2f}" for k, v in steps.items())
          + f"; chain: a peak {peak_c:.1f}, a hop's tail {tail_c:.1f} at "
          f"{mhz} MHz (clocks.max.sm)")
    for inst, usage in _tracker_resources():
        print(f"tracker 11a ptxas {inst}: {usage}")
    fired = set()
    twin = ("twin", lattices[0][1],
            _twin_lattice(lattices[0][1], 16, lattices[0][2][0].device))
    for name, cfg, lat in (*lattices, twin):
        c, hops, m = lat[0].shape
        half = [tuple(x[:, :hops // 2].contiguous() for x in lat),
                tuple(x[:, hops // 2:].contiguous() for x in lat)]
        z = torch.zeros((c, flush_hops(), m), dtype=torch.int32,
                        device=lat[0].device)
        flush = (z, z.float(), z.float(), z.bool())
        runs = (("", {}), (" split_repeats", {"split_repeats": True}),
                (" tiny pools", TINY_POOLS),
                (" large pools", LARGE_POOLS),
                (" tiny outputs", TINY_OUTPUTS))
        for label, pools in (runs[4:] if name == "twin" else runs):
            walk = TrackerWalk(cfg, m, **pools)
            inst = walk.instance(m)
            if inst != ("global" if pools is LARGE_POOLS else "shared"):
                fail(f"tracker 11a {name}{label}: instance {inst}")
            kern, plain = walk.init_state(c, z.device), \
                walk.init_state(c, z.device)
            plain_ms = None
            for blk in (*half, flush):
                walk.kernel(kern, *blk)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                walk.plain(plain, *blk)
                stop.record()
                torch.cuda.synchronize()
                plain_ms = plain_ms or start.elapsed_time(stop)
                _same_state(kern, plain, name + label)
            packets = int(kern["o_count"].sum())
            devs = {k: int(kern[k].sum()) for k in _DEVIATION_COUNTERS
                    if int(kern[k].sum())}
            fired |= set(devs)
            if not pools.get("expire_per_hop") and (devs or not packets):
                fail(f"tracker 11a {name}{label}: packets={packets} "
                     f"deviations={devs}")
            line = (f"tracker 11a {name}{label} [{c}, {hops}, {m}] "
                    f"instance={inst} ({walk.shared_bytes(m, inst)} B "
                    f"shared) x2 blocks + flush: state equal bit for bit, "
                    f"packets={packets} deviations={devs or 0}")
            if label not in ("", " large pools"):
                print(line)
                continue
            st = walk.init_state(c, z.device)
            ms = _time_ms(lambda: walk.kernel(st, *half[0]), 5)
            extra = ""
            if not label:
                st = walk.init_state(c, z.device)
                gms = _time_ms(lambda: walk.kernel(st, *half[0], "global"),
                               5)
                extra = f" global_instance_ms={gms:.4f}"
            nbytes = _nbytes(*half[0]) + 2 * _state_bytes(st)
            bound = _bound(nbytes)
            chain, peaks, nh = _chain_bound_ms(half[0][3], mhz, steps)
            print(f"{line} ms={ms:.4f}{extra} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound[0]:.6f} (lattice + 2 x state "
                  f"{nbytes} B) chain_bound_ms={chain:.6f} (busiest "
                  f"channel {peaks} valid peaks x {peak_c:.1f} + {nh} hops "
                  f"x {tail_c:.1f} cycles at {mhz} MHz; {ms / chain:.1f}x)")
            row = _row(0.0, ms, plain_ms, f"{name} [{c}, {hops // 2}, {m}]",
                       bound)
            row["chain_bound_ms"] = chain
            report["device_tracker_global" if label
                   else "device_tracker"].append(row)
    if fired != set(_DEVIATION_COUNTERS):
        fail(f"tracker 11a: the tiny pools fired {sorted(fired)}, not "
             f"every deviation counter")


def _wall_txt(w: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in w.items())


def tracker_north_star(gw, iq_dev, singles, ns_pdus: dict, ns_packets: int,
                       ns_wall: dict, dev, card: str,
                       launches: dict) -> None:
    """Phase 11b: phase 4's north star with ``tracker="device"``: every
    golden PDU and single on every channel, no deviation, K1, K2 and the
    tracker launched; the packets against phase 4's (the host path's
    bf16-packed heights may cross a gate the f32 ones do not: every
    difference printed, none in a golden PDU or single), the second
    feed's wall split beside phase 4's, and one profiled pass each of a
    host-tracker and this gateway (device busy and idle)."""
    import torch

    from gr_lora_tpu_torch.ops import device_tracker as walk_ops

    mods = _kernel_mods(gw)
    for ms in mods.values():
        for m in ms:
            m.launches = 0
    walk_ops.launches = 0
    gw.wall_reset()
    feeds, walls = [], []
    t0 = time.perf_counter()
    for _ in range(2):
        feeds.append(gw.feed(iq_dev))
        torch.cuda.synchronize()
        walls.append(gw.wall_reset())
    tail = gw.flush()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {name: sum(m.launches for m in ms) for name, ms in mods.items()}
    counts["device_tracker"] = walk_ops.launches
    for name, count in counts.items():
        if count <= 0:
            fail(f"tracker north star: kernel {name} was not launched")
        launches[name] = launches.get(name, 0) + count
    for i, pk in enumerate(feeds):
        got = _ok_pdus(pk)
        missing = [c for c in range(CHANNELS)
                   if not {(8, PDU1), (8, PDU2)} <= got.get(c, set())]
        if missing:
            fail(f"tracker feed {i + 1}: golden PDUs missing on channels "
                 f"{missing}")
    every = _ok_pdus(feeds[0] + feeds[1] + tail)
    lost = [c for c, (hx, _) in singles.items()
            if not any(sf == SFS[c % len(SFS)] and hx in h
                       for sf, h in every.get(c, set()))]
    if lost:
        fail(f"tracker north star: singles not decoded on channels {lost}")
    if gw.stats()["device_deviations"]:
        fail(f"tracker north star: deviations {gw.stats()}")
    diffs = {c: (sorted(ns_pdus.get(c, set()) - every.get(c, set())),
                 sorted(every.get(c, set()) - ns_pdus.get(c, set())))
             for c in range(CHANNELS)
             if ns_pdus.get(c, set()) != every.get(c, set())}
    npk = sum(len(f) for f in feeds) + len(tail)
    host_gw = _wide_gateway(dev, "fused")
    host_gw.feed(iq_dev)                      # builds its modules
    runs = {}
    for name, g in (("host", host_gw), ("device", gw)):
        g.wall_reset()
        wall, busy, split, _ = _profiled_pass(lambda: g.feed(iq_dev))
        runs[name] = (wall, busy, split, g.wall_reset())
    print(f"tracker 11b north-star {CHANNELS}ch x SF7-12 T={iq_dev.shape[1]}"
          f" x2 feeds + flush tracker=device on {card}: packets={npk} "
          f"(phase 4, host tracker: {ns_packets}) total_s={secs:.4f} "
          f"deviations=0 every golden PDU and single decoded; PDU "
          f"differences from phase 4 (only host, only device) by channel: "
          f"{diffs or 'none'}; feed2_wall device[{_wall_txt(walls[1])}] "
          f"host (phase 4)[{_wall_txt(ns_wall)}] launches={counts}")
    for name, (wall, busy, split, w) in runs.items():
        print(f"tracker 11b profiled feed tracker={name} on {card}: "
              f"wall={wall:.4f} s device_busy={busy:.2f} ms "
              f"({100 * busy / (1e3 * wall):.1f} %) idle="
              f"{100 - 100 * busy / (1e3 * wall):.1f} % wall[{_wall_txt(w)}]"
              f" device ms by kind: {_split_txt(split)}")
    del host_gw
    torch.cuda.empty_cache()


def tracker_soak(dev, card: str) -> int:
    """Phase 11d: dist/soak's run_gateway_soak on the gated gateway with
    split_repeats (uncurated traffic, TRACKER_SOAK), once with the host
    tracker and once with ``tracker="device"`` on the same traffic.
    check_soak, its assertions unchanged, holds the device run to the
    host tracker's packets: each decoded once, nothing else, the streaming
    state bounded, no dropped event, no deviation, the ring settled; the
    host run decodes nothing twice and nothing not injected.  The Pyramid
    decoder does not decode every uncurated packet (payloads with both
    adjacent-equal and adjacent-value symbols, in both packages; ROADMAP
    Queue 3): the injected packets neither tracker decodes are printed.
    Returns the device run's tracker launches."""
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.soak import check_soak, run_gateway_soak
    from gr_lora_tpu_torch.ops import device_tracker as walk_ops

    chans, sfs = TRACKER_SOAK_CHANNELS, (7, 8)
    runs = {}
    for tracker in ("host", "device"):
        gw = TriggeredPyramidGateway(base_config(), chans, sfs=sfs,
                                     max_payload_len=8, tracker=tracker,
                                     scan_chunk_samples=1 << 15,
                                     split_repeats=True, device=dev)
        chunk = 96 * gw.sf_states[8].cfg.num_samples
        before = walk_ops.launches
        t0 = time.perf_counter()
        soak = run_gateway_soak(gw, chans, sfs, TRACKER_SOAK_CHUNKS, chunk,
                                **TRACKER_SOAK)
        runs[tracker] = (*soak, gw, time.perf_counter() - t0,
                         walk_ops.launches - before)
    expected, host_got, _, _, host_wall, _ = runs["host"]
    _, got, log, gw, wall, count = runs["device"]
    extra = {k: v for k, v in host_got.items() if v > expected.get(k, 0)}
    if extra:
        fail(f"tracker soak: the host tracker decoded {extra} more often "
             "than injected")
    try:
        check_soak(host_got, got, log, gw,
                   min_packets=chans * TRACKER_SOAK_CHUNKS // 16)
    except AssertionError as e:
        fail(f"tracker soak against the host tracker's packets: {e}")
    streamed = TRACKER_SOAK_CHUNKS * chunk
    if streamed <= 4 * gw._ring.cap:
        fail(f"tracker soak streamed {streamed} samples, ring {gw._ring.cap}")
    lost = sorted((c, p.hex()) for c, p in expected
                  if host_got.get((c, p), 0) < expected[(c, p)])
    air = streamed / 250e3
    print(f"tracker 11d soak split_repeats {chans}ch x SF7-8, "
          f"{TRACKER_SOAK_CHUNKS} chunks of {chunk} samples ({air:.2f} s of "
          f"air a channel, {streamed / gw._ring.cap:.1f} ring lengths) on "
          f"{card}: injected={sum(expected.values())} host tracker "
          f"decoded={sum(host_got.values())} (wall {host_wall:.4f} s), "
          f"tracker=device the same packets, each once, no phantom, "
          f"deviations=0, ring_cap={gw._ring.cap}, wall={wall:.4f} s "
          f"x_realtime={air / wall:.3f}; injected, decoded by neither "
          f"tracker: {len(lost)} {lost}")
    return count


def tracker_cli(path: str, injected, dev, card: str) -> int:
    """Phase 11e: apps.gateway.main --collision --tracker device on phase
    10's capture (its default backend, xla) equal to the hand chain with
    ``tracker="device"`` at xla, none twice.  Returns the tracker
    launches."""
    from gr_lora_tpu_torch.ops import device_tracker as walk_ops

    before = walk_ops.launches
    argv = [path, "--samp-rate", str(WB_FS), "--channels", str(CHANNELS),
            "--sfs", ",".join(map(str, SFS)), "--quiet", "--collision",
            "--max-payload-len", "16", "--tracker", "device"]
    hand, _, hand_wall = _chain_datagrams(
        path, _wide_gateway(dev, "xla", "device"), dev)
    rc, got, wall, stats = _cli(argv, dev)
    if rc != 0:
        fail(f"gateway --collision --tracker device exited {rc}: {stats}")
    _same_datagrams(got, hand, "gateway --tracker device vs the hand chain "
                               "(xla, tracker=device)")
    decoded, _ = _check_injected(got, injected, "gateway --tracker device",
                                 every=False)
    air = WB_SAMPLES / WB_FS
    print(f"tracker 11e gateway --collision --tracker device (backend xla) "
          f"on {card}: datagrams={len(got)} equal to the hand chain with "
          f"tracker=device (its wall {hand_wall:.4f} s), "
          f"{_yield(decoded, injected)}, none twice; wall={wall:.4f} s "
          f"x_realtime={air / wall:.3f} ({stats})")
    return walk_ops.launches - before


def tracker_phase(iq, singles, ns, ao, msf, wide, dev, card: str,
                  report: dict, launches: dict) -> None:
    """Phase 11: the device tracker (models/device_tracker, the walk
    kernel csrc/device_tracker.cu)."""
    import torch

    marks = [time.perf_counter()]
    iq_dev = torch.from_numpy(iq).to(dev)
    gw = _wide_gateway(dev, "fused", "device")
    ao_cfg, ao_iq, ao_host, msf_iq, msf_singles, msf_host = ao + msf
    n = ao_cfg.num_samples
    block = AO_BLOCK_HOPS * n // 8 + n - n // 8
    with torch.no_grad():
        lattices = _tracker_lattices(
            gw, iq_dev, singles, ao_cfg,
            torch.from_numpy(ao_iq[:, :block]).to(dev))
        tracker_parity(lattices, report)
    del lattices
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    tracker_north_star(gw, iq_dev, singles, *ns, dev, card, launches)
    del gw, iq_dev
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    from gr_lora_tpu_torch.ops import device_tracker as walk_ops
    before = walk_ops.launches
    always_on(ao_cfg, ao_iq, dev, card, launches, tracker="device",
              host={b: ao_host[b] for b in ("fastp", "fused_direct")})
    multi_sf(base_config(), msf_iq, msf_singles, dev, card, launches,
             tracker="device", host=msf_host)
    counts = {"11b": launches["device_tracker"],
              "11c": walk_ops.launches - before}
    # The global-memory instance on the main path: fastp with pools past a
    # block's shared memory, the host tracker's PDUs all the same.
    before = walk_ops.global_launches
    always_on(ao_cfg, ao_iq, dev, card, launches, tracker="device",
              host={"fastp": ao_host["fastp"]}, device_pools=GLOBAL_POOLS)
    launches["device_tracker_global"] = walk_ops.global_launches - before
    if launches["device_tracker_global"] <= 0:
        fail("tracker 11c: the global instance was not launched")
    marks.append(time.perf_counter())
    counts["11d"] = tracker_soak(dev, card)
    marks.append(time.perf_counter())
    counts["11e"] = tracker_cli(*wide, dev, card)
    marks.append(time.perf_counter())
    for part, count in counts.items():
        if count <= 0:
            fail(f"tracker {part}: the tracker kernel was not launched")
    launches["device_tracker"] = sum(counts.values())
    parts = np.diff(marks)
    print(f"tracker phase 11 total_s={marks[-1] - marks[0]:.2f} (11a "
          f"{parts[0]:.1f}, 11b {parts[1]:.1f}, 11c {parts[2]:.1f}, 11d "
          f"{parts[3]:.1f}, 11e {parts[4]:.1f}) tracker launches="
          f"{launches['device_tracker']} {counts}, global instance "
          f"{launches['device_tracker_global']} (11c)")


#: Phase 12: the shard grid (dist/mesh) on the one card: {ch, t} slots,
#: all on cuda:0, one rank; then two ranks on it over gloo.
MESH_GRID = (2, 4)
MESH_TIMED = 3
MESH_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_multihost_worker.py")
MESH_SCENARIOS = ("fsm", "pyramid_rows", "pyramid_time", "gated",
                  "device_tracker")
MESH_FSM_CHANNELS = 64           # 12d's FSM case
MESH_PYR_CHANNELS = 16           # 12d's Pyramid cases
MESH_TIMEOUT_S = 300
#: 12a's detections that decode no payload, (channel, global position):
#: on the grid channel 21's at 0, where shard 0's zero left halo meets the
#: noise (ROADMAP Queue 3), as on the JAX package's mesh
#: (tests/test_torch_dist.py holds the two equal on channels 20-23);
#: mesh=None has none.
MESH_FSM_UNDECODABLE = [(21, 0)]


def mesh_fsm_fixture(cfg, block: int, keep=None):
    """Phase 9a's fixture (noise 0.05 from default_rng(0), one packet a
    channel) with each channel's packet across a t seam: starting one to
    three symbols (and a drawn fraction of one) before seam c % 3 + 1 of
    blocks of ``block`` samples, so its preamble straddles the seam and
    the shard after it detects it.  (A packet detected just before a
    seam puts the next shard's window mid-packet, where the FSM may take
    payload chirps for a preamble and report a false packet in its own
    region; the JAX package's mesh does the same.)  The noise is drawn a
    channel at a time (the draws of one [64, 1024 n, 2] call), and only
    the channels in ``keep`` (default: all) are kept.  Returns (iq
    float32 [kept, 1024 n, 2], their offsets)."""
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    n = cfg.num_samples
    total = FSM_SYMBOLS * n
    keep = range(FSM_CHANNELS) if keep is None else keep
    rng = np.random.default_rng(0)
    pkt = to_ri(modulate(encode(FSM_PAYLOAD, cfg), cfg, pad_front=0,
                         pad_back=0))
    rows = {}
    for c in range(FSM_CHANNELS):
        row = rng.normal(0.0, 0.05, (total, 2)).astype(np.float32)
        if c in keep:
            rows[c] = row
    iq = np.stack([rows.pop(c) for c in keep])
    offs = [(c % 3 + 1) * block - int(rng.integers(n, 4 * n))
            for c in range(FSM_CHANNELS)]
    for j, c in enumerate(keep):
        iq[j, offs[c]:offs[c] + len(pkt)] += pkt
    return iq, [offs[c] for c in keep]


def _fsm_packets(cfg, lists) -> list:
    """[[channel, position, symbols, payload hex or None]] of
    gateway_receive's lists, CRC-checked payloads only."""
    from gr_lora_tpu_torch.core.codec import decode

    out = []
    for c, chan in enumerate(lists):
        for pos, syms in chan:
            r = decode(syms, cfg)
            out.append([c, int(pos), syms.tolist(),
                        bytes(r.payload).hex() if r.ok and r.crc_ok
                        else None])
    return out


def _mesh_fsm_plan(cfg, dev, gather: bool):
    """12a's plan: the {2, 4} grid on ``dev``, blocks of a quarter of the
    capture."""
    from gr_lora_tpu_torch.dist.gateway import make_gateway, make_mesh

    block = FSM_SYMBOLS * cfg.num_samples // MESH_GRID[1]
    grid = make_mesh(*MESH_GRID, devices=[dev] * (MESH_GRID[0]
                                                 * MESH_GRID[1]))
    return make_gateway(cfg, grid, FSM_CHANNELS, block, max_packets=4,
                        gather_results=gather), block


def mesh_fsm(dev, card: str) -> list:
    """Phase 12a: dist/gateway's FSM gateway on a {ch: 2, t: 4} grid of
    slots on the card over mesh_fsm_fixture: every payload byte-exact with
    its CRC, once, at the position demod_fn gives over the whole capture
    (mesh=None), dropped 0, the detections that decode no payload
    MESH_FSM_UNDECODABLE's on the grid and none with mesh=None; the wall
    of a grid pass beside mesh=None's on
    the same capture (in turns), the halo bytes a block and one profiled
    grid pass.  Returns the packets (12d's one-rank NCCL run must equal
    them)."""
    import torch

    from gr_lora_tpu_torch.dist.gateway import (gateway_receive,
                                                left_halo_len,
                                                right_halo_len)
    from gr_lora_tpu_torch.models.demodulator import demod_fn

    cfg = fsm_config()
    plan, block = _mesh_fsm_plan(cfg, dev, gather=False)
    iq, offs = mesh_fsm_fixture(cfg, block)
    x = torch.from_numpy(iq).to(dev)
    t0 = time.perf_counter()
    lists, stats = gateway_receive(plan, x, cfg, return_stats=True)
    first_s = time.perf_counter() - t0
    got = _fsm_packets(cfg, lists)
    one = demod_fn(cfg, iq.shape[1], 4, device=dev)
    ref = _fsm_packets(cfg, [[(p, np.asarray(s, np.uint16)) for p, s in ch]
                             for ch in _whole_lists(one(x))])
    bad = [c for c in range(FSM_CHANNELS)
           if [(p[3] or "")[:2 * len(FSM_PAYLOAD)] for p in got
               if p[0] == c and p[3]] != [FSM_PAYLOAD.hex()]]
    if bad:
        fail(f"mesh 12a: channels {bad} did not decode their payload once")
    ok_got = [g[:3] for g in got if g[3]]
    ok_ref = [r[:3] for r in ref if r[3]]
    if ok_got != ok_ref:
        diff = [(g[:2], r[:2]) for g, r in zip(ok_got, ok_ref) if g != r]
        fail(f"mesh 12a: packets differ from mesh=None's: {diff[:8]}")
    if stats["dropped"]:
        fail(f"mesh 12a: dropped {stats['dropped']}")
    undecodable = {"grid": [tuple(g[:2]) for g in got if not g[3]],
                   "none": [tuple(r[:2]) for r in ref if not r[3]]}
    if undecodable != {"grid": MESH_FSM_UNDECODABLE, "none": []}:
        fail(f"mesh 12a: detections that decode no payload {undecodable}, "
             f"expected grid={MESH_FSM_UNDECODABLE} none=[]")
    grid_s, none_s = [], []
    for _ in range(MESH_TIMED):
        for fn, secs in ((lambda: plan.fn(x), grid_s),
                         (lambda: one(x), none_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    mesh = plan.mesh
    cpr = FSM_CHANNELS // mesh.shape["ch"]
    halo = len(mesh.local) * cpr * (left_halo_len(cfg)
                                    + right_halo_len(cfg)) * 8
    wall, busy, split, prof_cost = _profiled_pass(lambda: plan.fn(x))
    ext = left_halo_len(cfg) + block + right_halo_len(cfg)
    steps = {"grid": max(lp.steps for lp in demod_fn(
                 cfg, ext, 4, device=dev).loops.values()),
             "none": max(lp.steps for lp in one.loops.values())}
    print(f"mesh 12a fsm gateway {FSM_CHANNELS}ch SF8 (phase 9a's fixture, "
          f"packets across t seams) grid={mesh.shape} {len(mesh.local)} "
          f"slots on {dev} block={block} on {card}: decoded={FSM_CHANNELS}/"
          f"{FSM_CHANNELS} once, positions equal to mesh=None, dropped=0, "
          f"detections that decode no payload (channel, position) "
          f"grid={undecodable['grid']} none={undecodable['none']} "
          f"first_pass_s={first_s:.4f} grid_pass_s="
          f"{[round(s, 4) for s in grid_s]} mesh_none_pass_s="
          f"{[round(s, 4) for s in none_s]} (in turns) steps_per_pass "
          f"grid={steps['grid']} none={steps['none']} lanes grid="
          f"{len(mesh.local) * cpr} none={FSM_CHANNELS} "
          f"halo_bytes_per_block={halo} (a device copy within the rank) "
          f"profiled_grid_pass_s={wall:.4f} device_busy_ms={busy:.2f} "
          f"idle={1 - busy / (1e3 * wall):.3f} "
          f"device_ms[{_split_txt(split)}] profiler_read_s={prof_cost:.1f}")
    return got


def _whole_lists(outs) -> list:
    """demod_fn outputs as per-channel [(position, symbols list)]."""
    host = [o.cpu().numpy() for o in outs]
    return [_lane_packets(host, c) for c in range(host[0].shape[0])]


def mesh_always_on(cfg, iq, host: dict, dev, card: str,
                   launches: dict) -> None:
    """Phase 12b: phase 5's always-on gateway on a {ch: 2, t: 4} grid of
    slots on the card (2048-hop blocks, 512 hops a t slot): fastp (K5)
    and fused_direct (K4) with the host tracker, fastp with
    tracker="device" (the walk): phase 5's PDUs on every channel (11c's
    are phase 5's), no deviation, each kernel launched."""
    from gr_lora_tpu_torch.dist.gateway import make_mesh
    from gr_lora_tpu_torch.ops import device_tracker as walk_ops

    grid = make_mesh(*MESH_GRID, devices=[dev] * (MESH_GRID[0]
                                                 * MESH_GRID[1]))
    ao = {b: host[b] for b in ("fastp", "fused_direct")}
    always_on(cfg, iq, dev, card, launches, host=ao, mesh=grid,
              label="mesh 12b")
    before = walk_ops.launches
    always_on(cfg, iq, dev, card, launches, tracker="device",
              host={"fastp": host["fastp"]}, mesh=grid, label="mesh 12b")
    walked = walk_ops.launches - before
    if walked <= 0:
        fail("mesh 12b: the tracker walk was not launched")
    launches["device_tracker"] += walked
    print(f"mesh 12b tracker walk launches={walked}")


def mesh_north_star(iq, singles, ns_pdus: dict, dev, card: str,
                    launches: dict) -> None:
    """Phase 12c: phase 4's north star on a {ch: 4} grid of slots on the
    card: every golden PDU and single, the PDUs equal to phase 4's, K1
    and K2 launched."""
    import torch

    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.gateway import make_mesh

    grid = make_mesh(4, 1, devices=[dev] * 4)
    gw = TriggeredPyramidGateway(base_config(), CHANNELS, sfs=SFS,
                                 max_payload_len=16, backend="fused",
                                 tracker="host", mesh=grid)
    iq_dev = torch.from_numpy(iq).to(dev)
    counts, every, _, _ = main_path(gw, iq_dev, singles, card,
                                    label=f"mesh 12c grid={grid.shape}")
    if every != ns_pdus:
        fail("mesh 12c: the PDUs differ from phase 4's")
    for name, count in counts.items():
        launches[name] += count
    print(f"mesh 12c same PDUs as phase 4 on every channel, launches "
          f"{counts}")


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(argvs: list, what: str) -> list:
    """Start one process a rank, wait for every one (MESH_TIMEOUT_S),
    fail if any fails; returns each rank's JSON lines."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen([sys.executable] + argv, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for argv in argvs]
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=MESH_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"{what}: rank {rank} did not finish in "
                     f"{MESH_TIMEOUT_S} s")
            if p.returncode != 0:
                fail(f"{what}: rank {rank} exited {p.returncode}:\n"
                     f"{err[-3000:]}")
            outs.append([json.loads(ln) for ln in out.splitlines()
                         if ln.startswith("{")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _mesh_references(dev) -> dict:
    """12d's single-process results on the same fixtures: the FSM case on
    an in-process {1, 8} grid of the card (the ranks' grid shape), the
    Pyramid cases with mesh=None on the card."""
    import importlib.util

    import torch

    from gr_lora_tpu_torch.core.codec import decode
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.gateway import (gateway_receive,
                                                make_gateway, make_mesh)
    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
    from gr_lora_tpu_torch.ops.cplx import to_ri

    spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                                  MESH_WORKER)
    w = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(w)
    cfg, iq, block, _, _ = w.fsm_fixture(MESH_FSM_CHANNELS)
    plan = make_gateway(cfg, make_mesh(1, 8, devices=[dev] * 8),
                        MESH_FSM_CHANNELS, block, max_packets=2)
    fsm = []
    for c, chan in enumerate(gateway_receive(plan, iq, cfg)):
        for pos, syms in chan:
            r = decode(syms, cfg)
            fsm.append([c, pos, syms.tolist(),
                        bytes(r.payload).hex() if r.ok else None])
    pcfg = w._pyramid_cfg()
    ch = MESH_PYR_CHANNELS

    def pyramid(extra, **kw):
        x = w.collision_rows(pcfg, ch, extra)
        gw = PyramidGateway(pcfg, ch, block_hops=512, device=dev, **kw)
        ri = torch.from_numpy(to_ri(x)).to(dev)
        return w._decoded(gw.feed(ri) + gw.flush())

    x = w.collision_rows(pcfg, ch, 90)
    gated = TriggeredPyramidGateway(pcfg, ch, sfs=(8,), max_payload_len=16,
                                    device=dev)
    ri = torch.from_numpy(to_ri(x)).to(dev)
    return {"fsm": fsm, "pyramid_rows": pyramid(76),
            "pyramid_time": pyramid(74),
            "gated": w._decoded(gated.feed(ri) + gated.flush()),
            "device_tracker": pyramid(76, tracker="device")}


def mesh_two_ranks(dev, card: str, fsm_packets: list) -> None:
    """Phase 12d: the five scenarios of tests/test_multihost.py as two
    ranks on the one card (gloo: NCCL refuses two ranks on one device),
    FSM at 64 channels, Pyramid at 16: each rank's packets equal the
    single-process run's split by ownership; the device tracker's copy
    to the host under 64 KB a rank.  Which gloo collectives take CUDA
    tensors is probed and printed.  Then a one-rank NCCL group runs 12a
    with gather_results=True: its packets equal 12a's."""
    t0 = time.perf_counter()
    port = _free_port()
    argv = [MESH_WORKER, None, "2", str(port), "gloo", str(dev),
            f"CHANNELS={MESH_FSM_CHANNELS}",
            f"PYR_CHANNELS={MESH_PYR_CHANNELS}", *MESH_SCENARIOS,
            "gloo_cuda"]
    ranks = _run_ranks([argv[:1] + [str(r)] + argv[2:] for r in range(2)],
                       "mesh 12d gloo")
    ref = _mesh_references(dev)
    by = [{r.get("scenario"): r for r in lines} for lines in ranks]
    cpr = MESH_PYR_CHANNELS // 2
    for name in MESH_SCENARIOS:
        for rank in range(2):
            r = by[rank][name]
            if name == "fsm":
                want = ref[name]
            elif name == "pyramid_time":
                want = ref[name] if rank == 0 else []
            elif name == "gated":
                want = [p for p in ref[name] if p[0] in set(r["own"])]
            else:
                want = [p for p in ref[name]
                        if rank * cpr <= p[0] < (rank + 1) * cpr]
            if r["packets"] != want:
                fail(f"mesh 12d {name}: rank {rank}'s packets differ from "
                     "the single-process run's")
        if name == "gated" and sorted(by[0][name]["own"]
                                      + by[1][name]["own"]) \
                != list(range(MESH_PYR_CHANNELS)):
            fail("mesh 12d gated: the ranks' channels do not cover every "
                 "channel once")
        if name == "device_tracker":
            for rank in range(2):
                r = by[rank][name]
                if r["fetched_bytes"] >= 64 * 1024 \
                        or r["stats"]["deviations"]:
                    fail(f"mesh 12d device tracker rank {rank}: fetched "
                         f"{r['fetched_bytes']} B, {r['stats']}")
    secs = {name: [round(by[k][name]["wall_s"], 3) for k in range(2)]
            for name in MESH_SCENARIOS}
    print(f"mesh 12d two ranks over gloo on {dev} (NCCL refuses two ranks "
          f"on one device), 4 slots a rank, on {card}: every scenario's "
          f"packets equal the single-process run's by ownership "
          f"(fsm {MESH_FSM_CHANNELS}ch {len(ref['fsm'])} packets, seam "
          f"range {by[0]['fsm']['range']} | {by[1]['fsm']['range']}; "
          f"pyramid {MESH_PYR_CHANNELS}ch); device tracker fetched_bytes="
          f"{[by[k]['device_tracker']['fetched_bytes'] for k in range(2)]} "
          f"(host tracker {[by[k]['pyramid_rows']['fetched_bytes'] for k in range(2)]}) "
          f"wall_s by rank {secs}")
    print(f"mesh 12d gloo with CUDA tensors in torch: "
          f"{by[0]['gloo_cuda']['gloo_cuda']}")
    nccl = _run_ranks([[__file__, "--nccl-rank", str(_free_port())]],
                      "mesh 12d nccl")[0]
    if nccl[-1]["packets"] != fsm_packets:
        fail("mesh 12d: the one-rank NCCL run's packets differ from 12a's")
    print(f"mesh 12d one-rank NCCL group ({nccl[-1]['backend']}), 12a with "
          f"gather_results=True through all_gather_into_tensor on CUDA "
          f"tensors, on {card}: packets equal 12a's ({len(fsm_packets)}) "
          f"pass_s={nccl[-1]['secs']:.4f}; phase 12d "
          f"total_s={time.perf_counter() - t0:.1f}")


def nccl_rank(port: str) -> None:
    """The one-rank NCCL group of phase 12d (``--nccl-rank PORT``): 12a's
    plan with gather_results=True; prints its packets as one JSON line."""
    import torch

    from gr_lora_tpu_torch.dist import multihost
    from gr_lora_tpu_torch.dist.gateway import gateway_receive

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    multihost.initialize(f"localhost:{port}", 1, 0, backend="nccl")
    try:
        cfg = fsm_config()
        plan, block = _mesh_fsm_plan(cfg, dev, gather=True)
        if plan.mesh.backend != "nccl":
            fail(f"the grid's backend is {plan.mesh.backend}")
        iq, _ = mesh_fsm_fixture(cfg, block)
        x = torch.from_numpy(iq).to(dev)
        gateway_receive(plan, x, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lists = gateway_receive(plan, x, cfg)
        secs = time.perf_counter() - t0
        print(json.dumps({"packets": _fsm_packets(cfg, lists),
                          "backend": plan.mesh.backend, "secs": secs}))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def mesh_phase(iq, singles, ns_pdus: dict, ao, dev, card: str,
               launches: dict) -> None:
    """Phase 12 (module docstring): 12a-12d, each timed."""
    marks = [time.perf_counter()]
    fsm_packets = mesh_fsm(dev, card)
    marks.append(time.perf_counter())
    mesh_always_on(*ao, dev, card, launches)
    marks.append(time.perf_counter())
    mesh_north_star(iq, singles, ns_pdus, dev, card, launches)
    marks.append(time.perf_counter())
    mesh_two_ranks(dev, card, fsm_packets)
    marks.append(time.perf_counter())
    parts = np.diff(marks)
    print(f"mesh phase 12 on {card} total_s={marks[-1] - marks[0]:.2f} (12a "
          f"{parts[0]:.1f}, 12b {parts[1]:.1f}, 12c {parts[2]:.1f}, 12d "
          f"{parts[3]:.1f})")


def _peak_resources() -> None:
    """Each instance of the peak epilogue's kernels (peak_topm: float4 or
    f32 rows x lists of 8, 16, 16 with the rescan; the merge: lists of 8
    or 16 x 8-lane groups or warps) with ptxas's registers, stack and
    spills; fails on a stack frame (a per-lane list or row segment left
    its registers)."""
    from gr_lora_tpu_torch.ops import _build

    found = {n: u for n, u in _build.resources().items()
             if "peak_topm_kernel" in n or "peak_merge_kernel" in n}
    if len(found) != 10:
        fail(f"ptxas reported {len(found)} peak kernel instances, not 10")
    for name, usage in sorted(found.items()):
        print(f"ptxas peak instance {_kernel_name(name)}: {usage}")
        frame = re.search(r"(\d+) bytes stack frame", usage)
        if frame is None or int(frame.group(1)) != 0:
            fail(f"{_kernel_name(name)}: a stack frame ({usage})")


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
    # A lax.scan, not a Pallas kernel (models/device_tracker.py:85).
    "device_tracker": ("cuda", "gr_lora_tpu_torch/csrc/device_tracker.cu",
                       "gr_lora_tpu/models/device_tracker.py:85"),
    # Its instance for pools past a block's shared memory.
    "device_tracker_global": ("cuda",
                              "gr_lora_tpu_torch/csrc/device_tracker.cu",
                              "gr_lora_tpu/models/device_tracker.py:85"),
    # The demod FSM step's XLA ops in a lax.while_loop, not a Pallas
    # kernel (the body of models/demodulator.py:176's _machine).
    **{name: ("cuda", "gr_lora_tpu_torch/csrc/fsm_step.cu",
              "gr_lora_tpu/models/demodulator.py:207")
       for name in FSM_KERNELS},
}


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--nccl-rank"]:       # phase 12d's child
        nccl_rank(sys.argv[2])
        return
    if sys.argv[1:2] == ["--fsm-step"]:        # phase 9f alone
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        with torch.no_grad():
            fsm_step_timing(torch.device("cuda:0"), card)
        return
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
    _peak_resources()
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
    port_only = {}
    with torch.no_grad():
        parity(gw, iq_dev, singles, report, port_only)
        parity_dense(ao_cfg, torch.from_numpy(ao_iq[:, :block]).to(dev),
                     cfg12, x12, report, port_only)
        parity_hop16(ao_cfg, dev, report)
        parity_extra(ao_cfg, dev)
        envelope(ao_cfg, dev, card)
    del x12
    torch.cuda.empty_cache()

    # Phases 4-11 count the dense peak_topm's launches.
    from gr_lora_tpu_torch.ops import peak_epilogue
    peak_epilogue.topm_launches = 0

    # Phase 4: the north-star main path (K1, K2).
    launches, ns_pdus, ns_packets, ns_wall = main_path(gw, iq_dev, singles,
                                                       card)
    del gw
    torch.cuda.empty_cache()

    # Phases 5-6: the always-on paths (K3, K4b, K4, K5, K6).
    ao_host = always_on(ao_cfg, ao_iq, dev, card, launches)
    msf_host = multi_sf(base_config(), msf_iq, msf_singles, dev, card,
                        launches)
    torch.cuda.empty_cache()

    # Phase 7: the probes (P1, P2).
    probes(dev, card, report, launches)
    torch.cuda.empty_cache()

    # Phase 8: SIC (K1, K2 in its dense passes and the gateway's lattice).
    sic_envelope(base_config(), dev, card, launches)
    sic_python_tracker(base_config(), dev)
    sic_north_star(iq, singles, ns_pdus, ns_packets, dev, card, launches)

    # Phase 9: the FSM receive path (none of the nine kernels; the demod
    # machine's step kernels, fsm_win, fsm_sfd and fsm_update).
    with torch.no_grad():
        fsm_phase(iq_dev, singles, dev, card, report, launches)
    del iq_dev
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # Phase 10: the wideband north star (K1, K2 in its hand chain).
        wide = wideband_phase(dev, card, launches, tmp)
        torch.cuda.empty_cache()
        # Phase 11: the device tracker (its walk kernel, K1, K2, K4, K5).
        tracker_phase(iq, singles, (ns_pdus, ns_packets, ns_wall),
                      (ao_cfg, ao_iq, ao_host),
                      (msf_iq, msf_singles, msf_host), wide, dev, card,
                      report, launches)
        torch.cuda.empty_cache()

    # Phase 12: the shard grid (dist/mesh) on the card, then two ranks on
    # it (K1, K2, K4, K5 and the walk on the grid).
    mesh_phase(iq, singles, ns_pdus, (ao_cfg, ao_iq, ao_host), dev, card,
               launches)
    torch.cuda.empty_cache()

    # The port's kernels that stand for no TPU kernel: the dense top-M
    # (launched by the dense backends' epilogue, counted as their front's
    # launch above) and the merge that ends every K1 and K2 launch.
    topm, merge = port_only["peak_topm"][0], port_only["merge"]
    print(f"port-only peak_topm dense {topm['shape']}: ms={topm['ms']:.4f} "
          f"bound_ms={topm['bound_ms']:.6f} (M 32 {topm['ms_m32']:.4f}, "
          f"bound {topm['bound_ms_m32']:.6f}) "
          f"plain_ms={topm['plain_ms']:.4f} "
          f"library_ms={topm['library_ms']:.4f} "
          f"launches={peak_epilogue.topm_launches} (phases 4-12)")
    print("port-only merge (csrc/peak_topm.cu peak_merge_kernel): "
          + "; ".join(f"after {r['after']} {r['shape']} ms={r['ms']:.4f} "
                      f"bound_ms={r['bound_ms']:.6f} "
                      f"plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']:.4f}" for r in merge)
          + f"; launches={launches['rdft_peaks'] + launches['overlap_peaks']}"
          " (one a K1 or K2 launch, phases 4-12)")
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
