"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (decided inside the fixture, never at
import) where ``torch.cuda.is_available()`` is false.  On a machine with
an NVIDIA GPU and nvcc, run ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`` (the file imports no JAX; the repo's
conftest.py does, and such a machine need not have it).

Shapes beyond the always-on main path: K5 and K2 at fft_factor 16 (the
wider ring), peak_topm, K1, K2 and K4 at M > 16 (each then runs its
dense front end and peak_topm), K3 / K1 and K6 at p 1 (hop 16 samples),
K4b / K4 at every hop that is no multiple of 32 samples (8, 16, 48; their
chunk walk), and on ragged frame counts.  K1's, K2's and K4's fused searches keep
their peak allocation below one dense [lanes, hops, K] f32 array.  The
demod FSM's step kernels (csrc/fsm_step.cu): after every STEPS steps
the whole state equals the plain body's run on the card on the same
buffers, SF7-12 x ABS / PHASE / B x explicit / implicit header; a step
launches at most ten kernels.  The FSM device loop (models/fsm_loop): its
replayed CUDA graph leaves every lane's state equal to the same steps run
launch by launch, for both machines (the demod machine's through the
kernels, inside the graph too).  The RX front end, which has no
kernel either: channelize and fir_filter run in full f32 whatever the
TF32 flags, channelize's phase holds float64 precision at a large sample
offset, and the streaming channelizer equals one whole call on the card.
The Pyramid tracker's walk (csrc/device_tracker.cu): its whole state
after two consecutive blocks, on real lattices of several channels and
on synthetic ones, with and without split_repeats and on pools small
enough that every deviation counter fires, equals the plain version's
bit for bit; the always-on gateway with ``tracker="device"`` on the card
decodes what it decodes on the CPU.

Tolerances: K1, K3, K4b, K4 and K6's plain versions are the same
bf16-operand / f32-accumulate class in another summation order (heights
rtol 1e-3; a peak may differ only where an f32 tie decides it, see
peak_epilogue.compare_peaks; the dense K3 / K4b / K6 spectra within 1e-4
of their largest value; P1's value rtol 1e-3).  K2, K5, the epilogue and
P2's chain round as their plain versions do and must equal them exactly;
so does the tracker walk, every f32 field bit for bit.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import (make_peak_lattice, num_hops_for,
                                              pyramid_demodulate)
from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.direct import DirectPeaks, DirectSpectra
from gr_lora_tpu_torch.ops.overlap_dft import spectra_from_chunks
from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
from gr_lora_tpu_torch.ops.peak_epilogue import (compare_peaks, launch_topm,
                                                 peaks_plain)
from gr_lora_tpu_torch.ops.probes import (OverlapProbe, RateProbe,
                                          probe_inputs)
from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks
from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

pytestmark = pytest.mark.cuda

PDU1 = "0630f0010203040506050801"
PDU2 = "0530000707070707e76b01"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda:0")


def _cfg(sf, ff=8, p=2):
    return LoraConfig(sf=sf, cr=1, crc=True, ldr=(1 << sf) / 125e3 > 16e-3,
                      explicit_header=sf > 6, payload_len=4, p=p,
                      fft_factor=ff, threshold=5.0)


def _lanes(cfg, lanes, seed):
    """[lanes, T, 2]: one packet per lane at a lane-specific offset."""
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    total = len(pkt) + 6 * n
    rng = np.random.default_rng(seed)
    out = []
    for i in range(lanes):
        iq = (0.01 * (rng.standard_normal(total)
                      + 1j * rng.standard_normal(total))).astype(np.complex64)
        o = n + i * 37
        iq[o:o + len(pkt)] += pkt
        out.append(to_ri(iq))
    return np.stack(out), total


def _dense_bytes(lanes, hops, k):
    return 4 * lanes * hops * k


def _peak_alloc(dev, fn):
    """(fn's result, the bytes it allocated at its peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev) - base


@pytest.mark.parametrize("m", [8, 16, 17])
@pytest.mark.parametrize("sf,ff", [(7, 8), (8, 8), (9, 8), (7, 2)])
def test_rdft_kernel_matches_plain(dev, sf, ff, m):
    """K1: the fused search (M <= 16; at ff 8 its peak allocation stays
    below one dense [lanes, hops, K] f32 array) or, above 16, K3 and
    peak_topm (counted as K3's launch)."""
    cfg = _cfg(sf, ff)
    iq, total = _lanes(cfg, 3, sf)
    nh = num_hops_for(cfg, total)
    mod = RdftPeaks(cfg, nh, m).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern, alloc = _peak_alloc(dev, lambda: mod(x))
    fused = m <= 16
    assert (mod.launches, mod.front.launches) == ((1, 0) if fused else (0, 1))
    if fused and ff == 8:
        assert alloc < _dense_bytes(3, nh, cfg.bin_size), alloc
    plain = mod.plain(x)
    _, faw, _ = mod.front.plain(x)
    assert plain[3].any() and kern[0].shape[-1] == m
    compare_peaks(plain, kern, 1e-3, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("m", [8, 16, 17])
@pytest.mark.parametrize("sf,ff,p", [(10, 8, 2), (12, 8, 2), (10, 1, 4),
                                     (7, 16, 2)])
def test_overlap_kernel_matches_plain(dev, sf, ff, p, m):
    """The kernel rounds every operation as the plain version does, in its
    order: folds and peaks are equal bit for bit.  Includes p = 4, where
    the fold's hi side c + F - K is not c + K (the JAX kernel's tile
    arithmetic assumes F = 2K) and bins 0 and K - 1 are the merge's.  M <=
    16 runs the fused search (at p = 2 its peak allocation stays below one
    dense [lanes, hops, K] f32 array), 17 K5 and peak_topm (counted as
    K5's launch)."""
    cfg = _cfg(sf, ff, p)
    iq, total = _lanes(cfg, 2, sf)
    nh = min(num_hops_for(cfg, total), 128)
    mod = OverlapPeaks(cfg, nh, m).to(dev)
    g = mod.plan.chunk_dft(torch.from_numpy(iq).to(dev), nh)
    for a, b in zip(mod.front.kernel(g),
                    spectra_from_chunks(g, mod.plan, nh)):
        assert torch.equal(a, b), float(torch.max(torch.abs(a - b)))
    kern, alloc = _peak_alloc(dev, lambda: mod.from_chunks(g))
    fused = m <= 16
    assert (mod.launches, mod.front.launches) == ((1, 0) if fused else (0, 1))
    if fused and p == 2:
        assert alloc < _dense_bytes(2, nh, cfg.bin_size), alloc
    plain = mod.plain_from_chunks(g)
    assert plain[3].any() and kern[0].shape[-1] == m
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 64])
def test_topm_kernel_equals_plain(dev, m):
    """Random folds with many peaks, exact ties and peaks on the cyclic
    edges, rows with no peak and with plateaus, at K 1024, a ragged 1100
    (float4 rows, a masked tail) and 1021 (no multiple of 4: one f32 a
    lane): the kernel epilogue is the plain one, bit for bit."""
    for k in (1024, 1100, 1021):
        rng = np.random.default_rng(m + k)
        faw = rng.random((37, k)).astype(np.float32) * 10
        faw[:, ::97] = 9.5                   # equal values, distinct bins
        faw[:, 0] = 12.0                     # wrap-around neighbours
        faw[:, -1] = 11.0
        faw[5] = rng.random(k) * 4.9         # no peak above the threshold
        faw[6] = 7.0                         # flat: no strict maximum
        faw[7, 100:102] = faw[7, 300:303] = 20.0      # plateaus
        faw[7, [-1, 0]] = 30.0               # a plateau across the wrap
        fa = rng.random((37, k)).astype(np.float32)
        hs = rng.random((37, k)).astype(np.float32)
        t = [torch.from_numpy(a).to(dev) for a in (fa, faw, hs)]
        kern = launch_topm(*t, 5.0, m)
        plain = peaks_plain(*t, 5.0, m)
        assert not plain[3][5:7].any()
        for a, b in zip(kern, plain):
            assert torch.equal(a.cpu(), b.cpu()), k


def test_kernel_wrappers_reject_bad_input(dev):
    cfg = _cfg(7)
    bad = torch.zeros((4096, 2), dtype=torch.float64, device=dev)
    for mod in (RdftPeaks(cfg, 16, 8), DirectSpectra(cfg, 16),
                ChunkSpectra(cfg, 16)):
        with pytest.raises(ValueError):
            mod.to(dev)(bad)
    with pytest.raises(ValueError):
        OverlapSpectra(cfg, 16).to(dev).from_chunks(
            torch.zeros((8, 2048, 2), device=dev))
    with pytest.raises(ValueError):          # M above K
        launch_topm(*(torch.zeros(4, 64, device=dev) for _ in range(3)),
                    5.0, 65)
    # The direct kernel's limit: max_peaks of the fused search at most 16
    # (it takes every hop: test_direct_kernels_any_hop_match_plain).
    x = torch.zeros((2, 4096, 2), device=dev)
    with pytest.raises(ValueError, match="max_peaks"):
        DirectPeaks(cfg, 16, 17).to(dev).kernel(x)
    # K1's and K2's fused searches take M <= 16 too.
    with pytest.raises(ValueError, match="max_peaks"):
        RdftPeaks(cfg, 16, 17).to(dev).kernel(x)
    with pytest.raises(ValueError, match="max_peaks"):
        OverlapPeaks(cfg, 16, 17).to(dev).kernel(
            torch.zeros((23, cfg.fft_size, 2), device=dev))


def _dense_close(kern, plain, rtol):
    scale = max(float(b.abs().max()) for b in plain)
    for a, b in zip(kern, plain):
        assert float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("cls", [RdftSpectra, DirectSpectra, ChunkSpectra])
@pytest.mark.parametrize("sf,ff", [(7, 8), (8, 8), (9, 8), (7, 2)])
def test_dense_bf16_kernels_match_plain(dev, cls, sf, ff):
    """K3, K4b and K6: the dense folds within 1e-4 of their largest value,
    and the same peaks up to f32 ties."""
    cfg = _cfg(sf, ff)
    iq, total = _lanes(cfg, 3, sf + 1)
    mod = cls(cfg, num_hops_for(cfg, total)).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    assert mod.launches == 1
    plain = mod.plain(x)
    _dense_close(kern, plain, 1e-4)
    ref = peaks_plain(*plain, cfg.threshold, 8)
    assert ref[3].any()
    compare_peaks(ref, peaks_plain(*kern, cfg.threshold, 8), 1e-3,
                  faw=plain[1], threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff", [(7, 8), (8, 8), (9, 8), (7, 2)])
def test_direct_peaks_kernel_matches_plain(dev, sf, ff):
    cfg = _cfg(sf, ff)
    iq, total = _lanes(cfg, 3, sf + 2)
    mod = DirectPeaks(cfg, num_hops_for(cfg, total), 8).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    assert mod.launches == 1 and mod.front.launches == 0
    plain = mod.plain(x)
    assert plain[3].any()
    _, faw, _ = mod.front.plain(x)
    compare_peaks(plain, kern, 1e-3, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff,p", [(6, 8, 2), (6, 1, 2), (6, 8, 1),
                                     (7, 8, 1), (7, 1, 1), (7, 8, 3)])
def test_direct_kernels_any_hop_match_plain(dev, sf, ff, p):
    """K4b and K4 where hop = n / 8 is no multiple of 32 samples (SF6 p 2
    and SF7 p 1: 16, SF6 p 1: 8, SF7 p 3: 48; K 64 at SF6 ff 1, two column
    tiles): the chunk walk, each launched once, K4b within 1e-4 of its
    plain version's largest value, both the plain peaks up to f32 ties."""
    cfg = _cfg(sf, ff, p)
    assert (cfg.num_samples // 8) % 32
    iq, total = _lanes(cfg, 2, 60 + sf + ff + p)
    nh = num_hops_for(cfg, total)
    x = torch.from_numpy(iq).to(dev)
    spec = DirectSpectra(cfg, nh).to(dev)
    kern = spec(x)
    assert spec.launches == 1 and not spec.plane_walk
    plain = spec.plain(x)
    _dense_close(kern, plain, 1e-4)
    mod = DirectPeaks(cfg, nh, 8).to(dev)
    got = mod(x)
    assert mod.launches == 1 and mod.front.launches == 0
    ref = mod.plain(x)
    assert ref[3].any()
    compare_peaks(ref, got, 1e-3, faw=plain[1], threshold=cfg.threshold)


@pytest.mark.parametrize("m", [17, 32, 64])
def test_direct_peaks_large_m_match_plain(dev, m):
    """K4 beyond its fused search's 16: K4b then peak_topm, counted as a
    K4b launch; the plain peaks up to f32 ties."""
    cfg = _cfg(8, 8)
    iq, total = _lanes(cfg, 3, m)
    mod = DirectPeaks(cfg, num_hops_for(cfg, total), m).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    assert mod.launches == 0 and mod.front.launches == 1
    assert kern[0].shape[-1] == m
    plain = mod.plain(x)
    assert plain[3].any()
    _, faw, _ = mod.front.plain(x)
    compare_peaks(plain, kern, 1e-3, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("cls", [RdftSpectra, ChunkSpectra])
@pytest.mark.parametrize("ff", [8, 1])
def test_dense_kernels_p1_match_plain(dev, cls, ff):
    """K3 and K6 at SF7 p 1: n 128, hop 16 samples (K4b and K4 there:
    test_direct_kernels_any_hop_match_plain)."""
    cfg = _cfg(7, ff, 1)
    iq, total = _lanes(cfg, 3, 30 + ff)
    mod = cls(cfg, num_hops_for(cfg, total)).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    assert mod.launches == 1
    plain = mod.plain(x)
    _dense_close(kern, plain, 1e-4)
    ref = peaks_plain(*plain, cfg.threshold, 8)
    assert ref[3].any()
    compare_peaks(ref, peaks_plain(*kern, cfg.threshold, 8), 1e-3,
                  faw=plain[1], threshold=cfg.threshold)


def test_rdft_peaks_kernel_p1_matches_plain(dev):
    """K1 at SF7 p 1 (its front end K3 at n 128)."""
    cfg = _cfg(7, 8, 1)
    iq, total = _lanes(cfg, 3, 41)
    mod = RdftPeaks(cfg, num_hops_for(cfg, total), 8).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    plain = mod.plain(x)
    _, faw, _ = mod.front.plain(x)
    assert plain[3].any()
    compare_peaks(plain, kern, 1e-3, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff", [(7, 2), (8, 8)])
def test_rdft_kernels_ragged_frames(dev, sf, ff):
    """K3 and K1 on a frame count that is no multiple of the 64-frame
    tile, from a stream shorter than the frames need: K3 within 1e-4 of
    its plain version with zero spectra on the padded tail, K1 the plain
    peaks."""
    cfg = _cfg(sf, ff)
    iq, total = _lanes(cfg, 2, sf + 50)
    hop = cfg.num_samples // 8
    x = torch.from_numpy(iq[:, :total - hop // 2 - 3]).to(dev)
    nh = num_hops_for(cfg, total) + 40
    assert nh % 64
    spec = RdftSpectra(cfg, nh).to(dev)
    kern = spec(x)
    plain = spec.plain(x)
    _dense_close(kern, plain, 1e-4)
    assert float(kern[0][:, -30:].abs().max()) == 0.0
    mod = RdftPeaks(cfg, nh, 8).to(dev)
    ref = mod.plain(x)
    assert ref[3].any()
    compare_peaks(ref, mod(x), 1e-3, faw=plain[1], threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff", [(7, 2), (8, 8), (6, 8)])
def test_direct_kernels_ragged_frames(dev, sf, ff):
    """K4b and K4 on a frame count that is no multiple of the 128-frame
    tile, from a stream whose length is no multiple of hop and shorter
    than the frames need (zero-padded): K4b within 1e-4 of its plain
    version with zero spectra on the padded tail, K4 the plain peaks (SF6:
    hop 16, the chunk walk)."""
    cfg = _cfg(sf, ff)
    iq, total = _lanes(cfg, 2, sf + 20)
    hop = cfg.num_samples // 8
    x = torch.from_numpy(iq[:, :total - hop // 2 - 3]).to(dev)
    assert x.shape[1] % hop
    nh = num_hops_for(cfg, total) + 40
    assert nh % 128
    spec = DirectSpectra(cfg, nh).to(dev)
    kern = spec(x)
    plain = spec.plain(x)
    _dense_close(kern, plain, 1e-4)
    assert float(kern[0][:, -30:].abs().max()) == 0.0
    mod = DirectPeaks(cfg, nh, 8).to(dev)
    ref = mod.plain(x)
    assert ref[3].any()
    compare_peaks(ref, mod(x), 1e-3, faw=plain[1], threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff,p", [(8, 8, 2), (10, 8, 2), (12, 8, 2),
                                     (10, 1, 4), (7, 16, 2), (8, 16, 2)])
def test_overlap_spectra_kernel_equals_plain(dev, sf, ff, p):
    """K5 (K2's front end as its own op) equals its plain version bit for
    bit, at SF8, at the SF10-12 points the JAX kernel's tile cap refuses
    and at fft_factor 16 (window halo 112 bins: the wider ring)."""
    cfg = _cfg(sf, ff, p)
    iq, total = _lanes(cfg, 2, sf + 3)
    nh = min(num_hops_for(cfg, total), 128)
    mod = OverlapSpectra(cfg, nh).to(dev)
    g = mod.plan.chunk_dft(torch.from_numpy(iq).to(dev), nh)
    kern = mod.from_chunks(g)
    assert mod.launches == 1
    for a, b in zip(kern, mod.plain_from_chunks(g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend,cls", [("rdft", RdftSpectra),
                                         ("direct", DirectSpectra),
                                         ("fused_direct", DirectPeaks),
                                         ("fastp", OverlapSpectra),
                                         ("pallas", ChunkSpectra)])
def test_always_on_gateway_on_card_decodes_golden(dev, backend, cls):
    """The always-on gateway on the card, fed numpy chunks: both golden
    PDUs on both channels, through the backend's kernel."""
    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     payload_len=8, p=2, fft_factor=8, threshold=5.0)
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg,
                         pad_front=0, pad_back=0)
    iq = np.zeros((2, 1000 + 84 * n), np.complex64)
    for c in range(2):
        base = 1000 + c * 4 * n
        off2 = base + 16 * n + 4 * n // 8 + 204
        iq[c, base:base + len(p1)] += p1
        iq[c, off2:off2 + len(p2)] += p2
    gw = PyramidGateway(cfg, 2, block_hops=256, max_peaks=8, backend=backend,
                        device=dev)
    ri = to_ri(iq)
    pkts = []
    for lo in range(0, ri.shape[1], 5000):
        pkts += gw.feed(ri[:, lo:lo + 5000])
    pkts += gw.flush()
    got = {(p.channel, bytes(p.result.payload).hex()) for p in pkts
           if p.result is not None and p.result.ok}
    for c in range(2):
        assert (c, PDU1) in got and (c, PDU2) in got, got
    assert sum(m.launches for m in gw.lattice.modules()
               if isinstance(m, cls)) > 0


def test_gateway_on_card_decodes_golden(dev):
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    base = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0)
    gw = TriggeredPyramidGateway(base, 2, sfs=(8,), backend="fused",
                                 max_payload_len=16,
                                 scan_chunk_samples=1 << 16, device=dev)
    cfg = gw.sf_states[8].cfg
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg,
                         pad_front=0, pad_back=0)
    off2 = 16 * n + 4 * n // 8 + 204
    coll = np.zeros(off2 + len(p2) + 1, np.complex64)
    coll[:len(p1)] += p1
    coll[off2:off2 + len(p2)] += p2
    iq = np.zeros((2, 150_000), np.complex64)
    iq[:, 5000:5000 + len(coll)] += coll
    pkts = gw.feed(torch.from_numpy(to_ri(iq)).to(dev)) + gw.flush()
    got = {(p.channel, bytes(p.result.payload).hex()) for p in pkts
           if p.result is not None and p.result.ok}
    for c in range(2):
        assert (c, PDU1) in got and (c, PDU2) in got, got
    assert gw.lattice(8).launches > 0


def test_fused_sf9_ff16_runs_k2(dev):
    """backend "fused" at SF9 x ff 16, p 2 is K2 (as the JAX dispatch
    sends it) and returns its plain peaks on the card."""
    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn
    cfg = _cfg(9, 16)
    iq, total = _lanes(cfg, 2, 9)
    nh = min(num_hops_for(cfg, total), 96)
    lat = peak_lattice_fn(cfg, nh, 8, "fused").to(dev)
    assert isinstance(lat, OverlapPeaks)
    g = lat.plan.chunk_dft(torch.from_numpy(iq).to(dev), nh)
    kern = lat.from_chunks(g)
    plain = lat.plain_from_chunks(g)
    assert plain[3].any() and lat.launches == 1
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


def test_chunk_spectra_kernel_ragged_frames(dev):
    """K6 on a frame count that is no multiple of its 128-frame tile, on
    a stream shorter than its chunk rows (zero-padded), with three lanes:
    within 1e-4 of the plain version; the padded tail gives zero spectra."""
    cfg = _cfg(7, 2)
    iq, total = _lanes(cfg, 3, 11)
    nh = num_hops_for(cfg, total) + 40
    mod = ChunkSpectra(cfg, nh).to(dev)
    x = torch.from_numpy(iq).to(dev)
    kern = mod(x)
    _dense_close(kern, mod.plain(x), 1e-4)
    assert float(kern[0][:, -30:].abs().max()) == 0.0


def test_rate_probe_matches_plain(dev):
    """P1 at the main path's dot shape and one other: all four slabs of
    the last step's scratch and the value within rtol 1e-3 of the plain
    version (another summation order), launches counted."""
    for shape in ((256, 512, 4352), (128, 256, 1024)):
        x, w, _ = (t.to(dev) for t in probe_inputs(*shape))
        probe = RateProbe()
        out, scratch = probe.kernel(x, w)
        ref_out, ref_scratch = probe.plain(x, w)
        torch.testing.assert_close(scratch, ref_scratch, rtol=1e-3,
                                   atol=1e-3)
        torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3)
        out = probe(x, w)
        assert probe.launches == 1 and out.shape == (1, 1)


@pytest.mark.parametrize("kind", ["mxu", "vpu", "both"])
def test_overlap_probe_matches_plain(dev, kind):
    """P2 over 4 steps (the chain stays finite): its slab equal to the
    plain version bit for bit, its product within rtol 1e-3."""
    x, w, v0 = (t.to(dev) for t in probe_inputs(256, 512, 4352, batch=1))
    probe = OverlapProbe(kind, steps=4)
    out, acc, vs = probe.kernel(x[0], w, v0)
    ref_out, ref_acc, ref_vs = probe.plain(x[0], w, v0)
    assert torch.equal(vs, ref_vs) and bool(torch.isfinite(vs).all())
    if acc is not None:
        torch.testing.assert_close(acc, ref_acc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3)
    probe(x[0], w, v0)
    assert probe.launches == 1


def _slabs_agree(vs, ref_vs):
    """NaN masks equal, every other entry (inf included) bit for bit."""
    nan = torch.isnan(vs)
    assert torch.equal(nan, torch.isnan(ref_vs))
    assert torch.equal(vs[~nan], ref_vs[~nan])


@pytest.mark.parametrize("kind", ["mxu", "vpu", "both"])
def test_overlap_probe_full_steps_matches_plain(dev, kind):
    """P2 as chip_smoke.py times it, 64 steps x 2 rounds: the chain leaves
    the f32 range (inf, then NaN) everywhere, as the plain one does, so
    this checks the NaN mask and the product; the pacing is checked bit
    for bit at finite round counts (test_overlap_probe_paced_rounds)."""
    x, w, v0 = (t.to(dev) for t in probe_inputs(256, 512, 4352, batch=1))
    probe = OverlapProbe(kind)
    out, acc, vs = probe.kernel(x[0], w, v0)
    ref_out, ref_acc, ref_vs = probe.plain(x[0], w, v0)
    _slabs_agree(vs, ref_vs)
    if kind != "mxu":
        assert not bool(torch.isfinite(vs).any())
    if acc is not None:
        torch.testing.assert_close(acc, ref_acc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3,
                               equal_nan=True)


@pytest.mark.parametrize("kind", ["mxu", "vpu", "both"])
def test_overlap_probe_chain_only_blocks(dev, kind):
    """(128, 256, 1024) x 4 steps: 16 units, but the 163 840-element slab
    needs 64 blocks, 48 of which run the chain only."""
    x, w, v0 = (t.to(dev) for t in probe_inputs(128, 256, 1024, batch=1))
    probe = OverlapProbe(kind, steps=4)
    out, acc, vs = probe.kernel(x[0], w, v0)
    ref_out, ref_acc, ref_vs = probe.plain(x[0], w, v0)
    assert torch.equal(vs, ref_vs) and bool(torch.isfinite(vs).all())
    if acc is not None:
        torch.testing.assert_close(acc, ref_acc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["vpu", "both"])
@pytest.mark.parametrize("steps,rounds", [(6, 2), (13, 1)])
def test_overlap_probe_paced_rounds(dev, kind, steps, rounds):
    """The main shape at round counts that stay finite, so the slab
    compares bit for bit: 204 and 442 units on the card's SMs (132 on an
    H100), where blocks take unequal unit counts, pace fewer rounds than
    stages and run the rest after their last stage."""
    x, w, v0 = (t.to(dev) for t in probe_inputs(256, 512, 4352, batch=1))
    probe = OverlapProbe(kind, steps=steps, rounds=rounds)
    out, acc, vs = probe.kernel(x[0], w, v0)
    ref_out, ref_acc, ref_vs = probe.plain(x[0], w, v0)
    assert torch.equal(vs, ref_vs) and bool(torch.isfinite(vs).all())
    if acc is not None:
        torch.testing.assert_close(acc, ref_acc, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3)


def test_overlap_probe_rejects_off_tile_shapes(dev):
    for shape in ((192, 512, 4352), (256, 480, 4352), (256, 512, 4224)):
        x, w, v0 = (t.to(dev) for t in probe_inputs(*shape, batch=1))
        with pytest.raises(ValueError, match="multiples"):
            OverlapProbe("both").kernel(x[0], w, v0)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_pyramid_demodulate_defaults_to_card(dev, backend):
    """With no device argument the collision decoder runs on the card."""
    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     payload_len=8, p=2, fft_factor=8, threshold=5.0)
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg)
    off2 = 1000 + 16 * n + 4 * n // 8 + 204
    iq = np.zeros(off2 + len(p2) + 1000, np.complex64)
    iq[1000:1000 + len(p1)] += p1
    iq[off2:off2 + len(p2)] += p2
    syms = pyramid_demodulate(iq, cfg, backend=backend)
    pdus = {bytes(r.payload).hex() for r in (decode(s, cfg) for s in syms)
            if r.ok}
    assert {PDU1, PDU2} <= pdus


def _sic_cfg():
    return LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0)


def test_sic_fused_recovers_masked_packet_on_card(dev):
    """tests/test_sic.py's masked weak packet (ratio 0.2): SIC with the
    fused lattice on the card decodes both PDUs, its dense passes through
    K1."""
    from gr_lora_tpu_torch.models import sic

    cfg = _sic_cfg()
    n = cfg.num_samples
    p1 = modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                  pad_front=0, pad_back=0)
    p2 = modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                  pad_back=0)
    off2 = 1000 + 16 * n + 13
    iq = np.zeros(off2 + len(p2) + 12 * n, np.complex64)
    iq[1000:1000 + len(p1)] += (0.2 * p1).astype(np.complex64)
    iq[off2:off2 + len(p2)] += (0.04 * p2).astype(np.complex64)
    lat = make_peak_lattice(cfg, num_hops_for(cfg, len(iq)), 16, "fused",
                            dev)
    k1 = [m for m in lat.modules() if isinstance(m, RdftPeaks)]
    assert k1
    for m in k1:
        m.launches = 0
    pkts = sic.sic_demodulate(iq, cfg, grace=8, backend="fused")
    pdus = {bytes(r.payload).hex()
            for r in (decode(q.symbols, cfg) for q in pkts) if r.ok}
    assert {PDU1, PDU2} <= pdus
    assert sum(m.launches for m in k1) > 0


def test_gateway_sic_envelope_point_on_card(dev):
    """TriggeredPyramidGateway(sic=True) at one envelope point of
    tests/test_collision_gateway.py (16 symbols + 13 samples, ratio 0.2)
    on the card: both PDUs, at least one SIC window."""
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway

    cfg = _sic_cfg()
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.04 * modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                         pad_back=0)
    off2 = 16 * n + 13
    iq = np.zeros((1, 5000 + off2 + len(p2) + 60 * n), np.complex64)
    iq[0, 5000:5000 + len(p1)] += p1
    iq[0, 5000 + off2:5000 + off2 + len(p2)] += p2
    gw = TriggeredPyramidGateway(cfg, 1, sfs=(8,), max_payload_len=16,
                                 scan_chunk_samples=1 << 16, sic=True,
                                 backend="fused")
    pkts = gw.feed(to_ri(iq)) + gw.flush()
    pdus = {bytes(p.result.payload).hex() for p in pkts
            if p.result is not None and p.result.ok}
    assert {PDU1, PDU2} <= pdus
    assert gw.sic_windows >= 1 and gw.wall["sic"] > 0


# ---------------------------------------------------------------------------
# The FSM device loop (models/fsm_loop) and the demod machine's step
# kernels (csrc/fsm_step.cu): the kernels equal the plain body on the card,
# and the replayed CUDA graph equals the same steps run launch by launch.
# ---------------------------------------------------------------------------

def _fsm_fixture(machine):
    """(whole-buffer fn constructor, config, iq [L, T, 2]): lanes of different
    packets at different offsets and one silent lane, so lanes finish at
    different steps."""
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from gr_lora_tpu_torch.models.weak import modulate_weak, weak_demod_fn

    rng = np.random.default_rng(11)
    if machine == "demod":
        cfg = LoraConfig(sf=7, cr=1, crc=True, explicit_header=True, p=2,
                         fft_factor=2)
        waves = [modulate(encode(bytes(range(k)), cfg), cfg,
                          pad_front=(2 + 7 * i) * cfg.num_samples + 19 * i,
                          pad_back=0)
                 for i, k in enumerate((1, 20, 5))]
        build = demod_fn
    else:
        cfg = LoraConfig(sf=8, p=2, fft_factor=8, weak_sym_num=6)
        waves = [np.concatenate([np.zeros(o, np.complex64), modulate_weak(
            rng.integers(0, 256, 6), cfg)]) for o in (0, 3 * 512 + 77)]
        build = weak_demod_fn
    t = max(len(w) for w in waves) + 3 * cfg.num_samples
    iq = np.zeros((len(waves) + 1, t), np.complex64)
    for i, w in enumerate(waves):
        iq[i, :len(w)] = w
    iq += (0.01 * (rng.standard_normal(iq.shape)
                   + 1j * rng.standard_normal(iq.shape))).astype(np.complex64)
    return build, cfg, to_ri(iq)


@pytest.mark.parametrize("machine", ["demod", "weak"])
def test_fsm_graph_equals_eager_steps(dev, machine):
    """Both machines: the captured STEPS-step graph, replayed, leaves every
    lane's whole state equal to the eager steps' on the card, lanes that
    finish at different steps included; a second replay from the same
    start equals the first; the packets equal the CPU run's."""
    build, cfg, iq = _fsm_fixture(machine)
    lanes, t = iq.shape[0], iq.shape[1]
    fn = build(cfg, t, 4, device=dev)
    x = torch.from_numpy(iq).to(dev)
    graphed, eager = fn.make_loop(lanes), fn.make_loop(lanes, graphed=False)
    assert graphed.graphed and not eager.graphed
    # The demod machine steps through its kernels, in the graph too.
    assert (graphed.kernel is not None) == (eager.kernel is not None) \
        == (machine == "demod")
    outs = fn.run(graphed, x)
    final = [s.clone() for s in graphed.state]
    assert fn.run(eager, x) is not None
    for a, b in zip(final, eager.state):
        assert torch.equal(a, b)
    assert len(set(graphed.state.it.tolist())) > 1
    again = fn.run(graphed, x)
    assert all(torch.equal(a, b) for a, b in zip(outs, again))
    ref = [o.numpy() for o in build(cfg, t, 4, device="cpu")(
        torch.from_numpy(iq))]
    got = [o.cpu().numpy() for o in outs]
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-4)
        else:
            assert np.array_equal(a, b), i
    cnt = got[3] if machine == "demod" else got[2]
    assert cnt.tolist()[:-1] == [1] * (lanes - 1) and cnt[-1] == 0


def test_streaming_demod_on_card_equals_cpu(dev):
    """StreamingDemodulator, pipelined, on the card: the CPU streamer's
    packets and SNR ratios (rtol 1e-4), and a checkpoint from the card
    resumes on the CPU to the same packets."""
    from gr_lora_tpu_torch.models.demodulator import StreamingDemodulator

    cfg = LoraConfig(sf=7, cr=2, crc=True, explicit_header=False,
                     payload_len=4, p=2, fft_factor=2)
    n = cfg.num_samples
    loops = StreamingDemodulator(cfg, block_len=8 * n,
                                 device=dev)._step.__self__.loops
    pkt = to_ri(modulate(encode(bytes([0xCA, 0xFE, 0x12, 0x34]), cfg), cfg))
    iq = np.concatenate([pkt, np.zeros((37 * n + 11, 2), np.float32), pkt])
    runs = []
    for device in (dev, "cpu"):
        sd = StreamingDemodulator(cfg, block_len=8 * n, pipelined=True,
                                  device=device)
        got, ratios = [], []
        for lo in range(0, len(iq), 1536):
            got += sd.feed(iq[lo:lo + 1536])
            ratios += sd.snr_ratios
        got += sd.flush()
        runs.append(([(p, s.tolist()) for p, s in got],
                     ratios + sd.snr_ratios))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 2
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-4)
    assert loops and all(loop.kernel is not None for loop in loops.values())
    card = StreamingDemodulator(cfg, block_len=8 * n, device=dev)
    cut = len(pkt) + 37 * n + len(pkt) // 2
    before = card.feed(iq[:cut])
    cpu = StreamingDemodulator(cfg, block_len=8 * n, device="cpu")
    cpu.load_state_dict(card.state_dict())
    after = cpu.feed(iq[cut:]) + cpu.flush()
    assert [(p, s.tolist()) for p, s in before + after] == runs[1][0]


_MODES = {"abs": 0, "phase": 1, "b": 2}


def _fsm_kernel_case(dev, sf, mode, explicit):
    """(config, plain loop, kernel loop) of the demod machine on the card:
    test_torch_fsm_kernel_source's lanes (two packets, a preamble alone,
    silence), both loops loaded with the initial state."""
    from gr_lora_tpu_torch.config import PeakSearch
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from test_torch_fsm_kernel_source import _lanes

    cfg = LoraConfig(sf=sf, cr=1, crc=True, ldr=sf >= 11,
                     explicit_header=explicit, payload_len=3, p=2,
                     fft_factor=8, peak_search=PeakSearch(_MODES[mode]))
    x, total = _lanes(cfg, bytes([sf, 0x5A, 0xC3]))
    fn = demod_fn(cfg, total, 2, device=dev)
    lanes, pad = x.shape[0], fn.pad_front
    plain = fn.make_loop(lanes, graphed=False)
    kern = fn.make_loop(lanes, graphed=False)
    assert kern.kernel is not None
    for loop in (plain, kern):
        loop.iq[:, pad:pad + total].copy_(x.to(dev))
        loop._load(fn.init_state(lanes, -pad, pad, dev))
    return cfg, plain, kern


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_fsm_kernel_step_equals_plain_body(dev, sf, mode, explicit):
    """The demod machine's step through csrc/fsm_step.cu against its plain
    body run directly on the card, from the same state on the same
    buffers, LDR on at SF11-12: the first step's dechirped windows equal
    ATen's product bit for bit; after every STEPS steps every integer
    field, syms and cfo equal the plain steps', snr and out_snr within
    1e-6; the packets are emitted."""
    from gr_lora_tpu_torch.models.fsm_loop import STEPS, windows
    from gr_lora_tpu_torch.ops.cplx import as_complex
    from gr_lora_tpu_torch.ops.dechirp import device_plan

    cfg, plain, kern = _fsm_kernel_case(dev, sf, mode, explicit)
    n = cfg.num_samples
    win = as_complex(windows(plain.iq, plain.state.ptr[:, None], n)[:, 0])
    up = device_plan("up", sf, cfg.p, cfg.fft_factor, dev).mod
    kern.kernel()
    assert torch.equal(kern.kernel.up_in[:, 0, :n],
                       win * as_complex(up)[0])
    kern._load(plain.state)
    body = plain.body
    while bool(plain.active(plain.state).any()):
        s = plain.state
        for _ in range(STEPS):
            s = body(plain.iq, s, plain.active(s))
        plain._load(s)
        for _ in range(STEPS):
            kern.kernel()
        for name, a in plain.state._asdict().items():
            b = getattr(kern.state, name)
            if name in ("snr", "out_snr"):
                torch.testing.assert_close(b, a, rtol=1e-6, atol=0.0,
                                           msg=name)
            else:
                assert torch.equal(a, b), name
    cnt = plain.state.out_cnt.tolist()
    assert cnt[:2] == [1, 1] and cnt[3] == 0


def test_parse_header_on_card_equals_cpu(dev):
    """The explicit-header parse of every length, code rate and CRC flag at
    SF7-12, LDR on and off, on the card equals the CPU's: the symbol count
    ceil((2 len - sf + 7 + 4 crc) / (sf - 2 ldr)) is exact on both."""
    from gr_lora_tpu_torch.core.header import calc_sym_num
    from gr_lora_tpu_torch.models.demodulator import _parse_header

    rows = [(ln, cr, crc) for ln in range(256) for cr in range(1, 5)
            for crc in (0, 1)]
    for sf in range(7, 13):
        cfg = LoraConfig(sf=sf, cr=1, explicit_header=True)
        comp8 = torch.from_numpy(np.stack([np.asarray(encode(
            bytes(ln), cfg.replace(cr=cr, crc=bool(crc)))[:8], np.int32)
            for ln, cr, crc in rows]))
        for ldr in (False, True):
            c = cfg.replace(ldr=ldr)
            cpu = _parse_header(comp8, c)
            card = _parse_header(comp8.to(dev), c)
            for a, b in zip(cpu, card):
                assert torch.equal(a, b.cpu())
            assert bool(cpu[0].all())
            assert cpu[4].tolist() == [calc_sym_num(
                ln, sf=sf, cr=cr, crc=bool(crc), ldr=ldr,
                explicit_header=True) for ln, cr, crc in rows]


def test_fsm_kernel_counts_launches_and_steps(dev):
    """One eager step through the kernels counts three launches and runs
    at most ten kernels on the card (torch.profiler): the three and
    cuFFT's; the
    triggered receiver's recorder counts fsm_kernel_steps equal to its
    replays' steps at every SF."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gr_lora_tpu_torch.dist import TriggeredReceiver
    from gr_lora_tpu_torch.models.fsm_loop import STEPS
    from gr_lora_tpu_torch.ops import fsm_step
    from test_torch_trace import BASE, _feed

    _, _, kern = _fsm_kernel_case(dev, 8, "abs", True)
    kern.kernel()                       # cuFFT's plans made
    before = fsm_step.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern.kernel()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "memcpy" not in e.name().lower()
               and "memset" not in e.name().lower()]
    assert fsm_step.launches - before == 3
    assert 5 <= len(kernels) <= 10, [e.name() for e in kernels]
    assert sum("fsm_" in e.name() for e in kernels) == 3
    rx = TriggeredReceiver(BASE, sfs=(7, 8), device=dev)
    rx.recorder.on = True
    rx(torch.from_numpy(_feed()).pin_memory())
    (rec,) = rx.recorder.records()
    counts = {(c["name"], c["sf"]): c["value"] for c in rec["counters"]}
    for sf in (7, 8):
        assert counts[("fsm_kernel_steps", sf)] \
            == counts[("replays", sf)] * STEPS > 0


def test_fsm_kernel_launches_count_no_capture_or_replay(dev):
    """A graphed loop's first run counts its warm-up's eager steps, three
    launches a step, and nothing for the capture; its replays count
    none."""
    from gr_lora_tpu_torch.models.fsm_loop import STEPS
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from gr_lora_tpu_torch.ops import fsm_step
    from test_torch_fsm_kernel_source import _lanes

    cfg = LoraConfig(sf=7, cr=1, crc=True, explicit_header=True,
                     payload_len=3, p=2, fft_factor=8)
    x, total = _lanes(cfg, bytes([7, 0x5A, 0xC3]))
    fn = demod_fn(cfg, total, 2, device=dev)
    loop = fn.make_loop(x.shape[0])
    before = fsm_step.launches
    fn.run(loop, x.to(dev))
    assert loop.graph is not None
    assert fsm_step.launches - before == 3 * STEPS
    before = fsm_step.launches
    fn.run(loop, x.to(dev))
    assert fsm_step.launches == before and loop.kernel_steps > 0


def test_fsm_kernels_on_a_card_that_is_not_current(dev):
    """A demod loop on the second card while the first is current: the
    kernel step launches on its own card, graphed and eager, and gives
    what the same loop gives on the first card, and the CPU's packets."""
    from gr_lora_tpu_torch.models.demodulator import demod_fn
    from test_torch_fsm_kernel_source import _lanes

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg = LoraConfig(sf=7, cr=1, crc=True, explicit_header=True,
                     payload_len=3, p=2, fft_factor=8)
    x, total = _lanes(cfg, bytes([7, 0x5A, 0xC3]))
    cpu = demod_fn(cfg, total, 2, device="cpu")(x)
    first = demod_fn(cfg, total, 2, device=dev)(x.to(dev))
    other = torch.device("cuda:1")
    with torch.cuda.device(dev):
        fn = demod_fn(cfg, total, 2, device=other)
        for graphed in (True, False):
            loop = fn.make_loop(x.shape[0], graphed=graphed)
            assert loop.kernel is not None and loop.graphed == graphed
            got = fn.run(loop, x.to(other))
            assert loop.kernel_steps > 0
            for a, b, c in zip(first, got, cpu):
                assert b.device == other and torch.equal(a.cpu(), b.cpu())
                if c.is_floating_point():
                    np.testing.assert_allclose(b.cpu(), c, rtol=1e-4)
                else:
                    assert torch.equal(b.cpu(), c)
        assert torch.cuda.current_device() == dev.index


def test_recorder_on_card(dev):
    """The triggered receiver's recorder on the card (gr_lora_tpu_torch/
    trace.py): the packets of a call with it on equal those with it off
    and the CPU's; the device spans lie in order on the call's device
    timeline, inside its wall; a replay span per counted replay; a second
    call takes its CUDA events from the pool, making none."""
    from gr_lora_tpu_torch.dist import TriggeredReceiver
    from test_torch_trace import BASE, DEVICE_SPANS, _feed, _key

    iq = _feed()
    ref = TriggeredReceiver(BASE, sfs=(7, 8), device="cpu")(iq)
    rx = TriggeredReceiver(BASE, sfs=(7, 8), device=dev)
    x = torch.from_numpy(iq).pin_memory()
    off = rx(x)
    rx.recorder.on = True
    on = rx(x)
    pool = len(rx.recorder._pool)
    again = rx(x)
    assert len(rx.recorder._pool) == pool > 0
    assert _key(off) == _key(on) == _key(again)
    assert [k[:4] for k in _key(on)] == [k[:4] for k in _key(ref)]
    for rec in rx.recorder.records():
        devs = [s for s in rec["spans"] if s["device_ms"] is not None]
        assert {s["name"] for s in devs} == DEVICE_SPANS
        end = 0.0
        for s in devs:
            d0, d1 = s["device_ms"]
            assert end - 1e-3 <= d0 <= d1 <= rec["wall_ms"] + 0.5, s
            end = d1
        assert sum(s["name"] == "lora.fsm.replay" for s in devs) == sum(
            c["value"] for c in rec["counters"] if c["name"] == "replays")
        assert 0.0 < rec["busy_ms"] < rec["wall_ms"]


def _channelize_f64(x, num_channels, fs_in, sample_offset, p=2,
                    spacing=125e3):
    """float64 NumPy evaluation of channelize's packed product and residual
    phase, from the same f32 weights."""
    from gr_lora_tpu_torch.pipeline.channelizer import _channelizer_plan

    decim = int(round(fs_in / (p * spacing)))
    packed, w, offs = _channelizer_plan(num_channels, decim, 16,
                                        spacing / fs_in)
    m = (len(x) - w) // decim + 1
    idx = np.arange(m)[:, None] * decim + np.arange(w)[None, :]
    xp = np.concatenate([x[idx, 0], x[idx, 1]], axis=1).astype(np.float64)
    y = xp @ packed.astype(np.float64)
    y = y[:, :num_channels] + 1j * y[:, num_channels:]
    turns = (np.arange(m)[:, None] * decim + sample_offset) * offs[None, :]
    y = y * np.exp(-2j * np.pi * (turns - np.floor(turns)))
    return np.stack([y.real, y.imag], -1).transpose(1, 0, 2)


@pytest.mark.parametrize("stage", ["channelize", "fir_filter"])
def test_front_end_pins_f32_on_card(dev, stage):
    """The front end runs in full f32 whatever the caller's TF32 flags:
    the same call with both flags on equals the call with both off within
    1e-6 of its peak (TF32 misses by 1e-4 to 1e-3), the caller's flags
    come back unchanged, and the result is the CPU's within 1e-5."""
    from gr_lora_tpu_torch.pipeline.channelizer import channelize
    from gr_lora_tpu_torch.pipeline.frontend import design_low_pass, fir_filter

    x = np.random.default_rng(11).standard_normal((1 << 16, 2)) \
        .astype(np.float32)
    if stage == "channelize":
        def run(device):
            return channelize(x, 64, 8e6, device=device).cpu().numpy()
    else:
        taps = design_low_pass(1.0, 1e6, 72.5e3, 1e3)

        def run(device):
            return fir_filter(x, taps, device=device).cpu().numpy()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        pinned = run(dev)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        loose = run(dev)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    peak = np.abs(pinned).max()
    assert np.abs(loose - pinned).max() <= 1e-6 * peak
    assert np.abs(pinned - run("cpu")).max() <= 1e-5 * peak


def test_channelize_f64_phase_on_card(dev):
    """At an absolute offset past 2^33 (about 18 minutes at 8 Msps) the
    card's channelize equals a float64 NumPy evaluation within 1e-5 of its
    peak: the residual phase is taken in float64."""
    from gr_lora_tpu_torch.pipeline.channelizer import channelize

    x = np.random.default_rng(12).standard_normal((1 << 15, 2)) \
        .astype(np.float32)
    offset = (1 << 33) + 32 * 12_345
    got = channelize(x, 64, 8e6, sample_offset=offset,
                     device=dev).cpu().numpy()
    ref = _channelize_f64(x, 64, 8e6, offset)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_streaming_channelizer_on_card_equals_whole(dev):
    """StreamingChannelizer on the card, fed irregular host and device
    blocks, equals one whole-capture channelize within atol 1e-5, its
    output on the card."""
    from gr_lora_tpu_torch.pipeline.channelizer import (StreamingChannelizer,
                                                        channelize)

    total = 200_000
    x = np.random.default_rng(13).standard_normal((total, 2)) \
        .astype(np.float32)
    whole = channelize(x, 16, 2e6, device=dev).cpu().numpy()
    sc = StreamingChannelizer(16, 2e6, device=dev)
    outs, lo = [], 0
    for i, size in enumerate((7, 1111, 50_000, 13, 9000, total)):
        blk = x[lo:lo + size]
        out = sc.feed(torch.from_numpy(blk).to(dev) if i % 2 else blk)
        assert out.device.type == "cuda"
        outs.append(out.cpu().numpy())
        lo += size
        if lo >= total:
            break
    streamed = np.concatenate(outs, axis=1)
    m = min(whole.shape[1], streamed.shape[1])
    assert m >= whole.shape[1] - 1
    np.testing.assert_allclose(streamed[:, :m], whole[:, :m], rtol=0,
                               atol=1e-5)


def _tracker_lattice(dev, channels=4):
    """[C, H, 8] peak lattices on the card: per channel the golden SF8
    collision (ff 8, p 2) at a channel-specific offset in noise, one
    channel's replaced by a synthetic lattice of packet-shaped runs and
    clutter (the tracker tests' fuzz shape)."""
    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn

    cfg = _cfg(8).replace(payload_len=8)
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                         pad_back=0)
    total = 1000 + 3 * 777 + 22 * n + 2 * (13 * n + 18 * n) + 8 * n
    rng = np.random.default_rng(5)
    iq = (0.01 * (rng.standard_normal((channels, total))
                  + 1j * rng.standard_normal((channels, total)))
          ).astype(np.complex64)
    for c in range(channels):
        off = 1000 + c * 777
        iq[c, off:off + len(p1)] += p1
        o2 = off + 16 * n + 4 * n // 8 + 204
        iq[c, o2:o2 + len(p2)] += p2
    nh = num_hops_for(cfg, total)
    lat = peak_lattice_fn(cfg, nh, 8).to(dev)
    with torch.no_grad():
        bins, h, hs, valid = lat(torch.from_numpy(to_ri(iq)).to(dev))
    k = cfg.bin_size
    b = torch.zeros(nh, 8, dtype=torch.int32)
    hv = torch.zeros(nh, 8)
    v = torch.zeros(nh, 8, dtype=torch.bool)
    for t0 in (5, 120):
        b0 = int(rng.integers(0, k))
        for i in range(44):
            b[t0 + i, 0], hv[t0 + i, 0], v[t0 + i, 0] = \
                (b0 + i * k // 8) % k, 30.0 + t0, True
        for s_ in range(12):
            bs = int(rng.integers(0, k))
            for i in range(int(rng.integers(2, 9))):
                t = t0 + 50 + 8 * s_ + i
                b[t, 1], hv[t, 1], v[t, 1] = (bs + i * k // 8) % k, \
                    30.0 + t0, True
    clutter = rng.random((nh, 8)) < 0.1
    b[:, 2:] = torch.from_numpy(rng.integers(0, k, (nh, 6)).astype(np.int32))
    hv[:, 2:] = torch.from_numpy(rng.uniform(5.5, 12, (nh, 6))
                                 .astype(np.float32))
    v[:, 2:] = torch.from_numpy(clutter[:, 2:])
    bins[-1], h[-1], hs[-1], valid[-1] = (b.to(dev), hv.to(dev),
                                          (0.8 * hv).to(dev), v.to(dev))
    return cfg, tuple(x.contiguous() for x in (bins, h, hs, valid))


_TINY = dict(track_pool=4, packet_pool=1, expire_per_hop=1, max_symbols=8,
             out_pool=1, finalize_per_hop=1)


def _same_state(a, b):
    from gr_lora_tpu_torch.ops.device_tracker import STATE_FIELDS

    for name, _ in STATE_FIELDS:
        x, y = a[name].cpu().numpy(), b[name].cpu().numpy()
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), (name, np.argwhere(x != y)[:4])


@pytest.mark.parametrize("pools", [{}, _TINY], ids=["pools", "tiny"])
@pytest.mark.parametrize("split", [False, True])
def test_device_tracker_kernel_equals_plain(dev, split, pools):
    """The walk over two consecutive blocks and a flush: every state field
    bit for bit, the packets out, and (tiny pools) the counters fired."""
    from gr_lora_tpu_torch.models.device_tracker import flush_hops
    from gr_lora_tpu_torch.ops.device_tracker import TrackerWalk

    cfg, lat = _tracker_lattice(dev)
    walk = TrackerWalk(cfg, 8, split_repeats=split, **pools)
    c, nh = lat[0].shape[:2]
    kern, plain = walk.init_state(c, dev), walk.init_state(c, dev)
    z = torch.zeros((c, flush_hops(), 8), dtype=torch.int32, device=dev)
    flush = (z, z.float(), z.float(), z.bool())
    for blk in ([x[:, :nh // 2].contiguous() for x in lat],
                [x[:, nh // 2:].contiguous() for x in lat], flush):
        walk.kernel(kern, *blk)
        walk.plain(plain, *blk)
        torch.cuda.synchronize()
        _same_state(kern, plain)
    assert int(kern["o_count"][:3].min()) >= 1
    dev_total = sum(int(kern[k].sum()) for k in (
        "tracks_dropped", "packets_dropped", "finalize_deferred",
        "packet_peak_overflow", "out_overflow"))
    assert (dev_total > 0) == bool(pools), dev_total


@pytest.mark.parametrize("pools", [{}, dict(track_pool=256,
                                            split_repeats=True)],
                         ids=["named", "large"])
def test_device_tracker_global_instance_equals_plain(dev, pools):
    """The walk's global-memory instance (named on the default pools, or
    picked by the footprint rule on pools past a block's shared memory)
    over two blocks and a flush: every state field bit for bit."""
    from gr_lora_tpu_torch.models.device_tracker import flush_hops
    from gr_lora_tpu_torch.ops.device_tracker import TrackerWalk

    cfg, lat = _tracker_lattice(dev)
    walk = TrackerWalk(cfg, 8, **pools)
    assert walk.instance() == ("global" if pools else "shared")
    c, nh = lat[0].shape[:2]
    kern, plain = walk.init_state(c, dev), walk.init_state(c, dev)
    z = torch.zeros((c, flush_hops(), 8), dtype=torch.int32, device=dev)
    flush = (z, z.float(), z.float(), z.bool())
    for blk in ([x[:, :nh // 2].contiguous() for x in lat],
                [x[:, nh // 2:].contiguous() for x in lat], flush):
        walk.kernel(kern, *blk, "global")
        walk.plain(plain, *blk)
        torch.cuda.synchronize()
        _same_state(kern, plain)
    assert int(kern["o_count"][:3].min()) >= 1


def test_device_tracker_process_counts_launches(dev):
    """process launches the kernel on CUDA tensors (one count a call) and
    raises on what the kernel does not take."""
    from gr_lora_tpu_torch.ops import device_tracker as ops

    cfg, lat = _tracker_lattice(dev, channels=2)
    walk = ops.TrackerWalk(cfg, 8)
    st = walk.init_state(2, dev)
    before = ops.launches
    walk.process(st, *lat)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    with pytest.raises(ValueError):
        walk.process(st, lat[0].long(), *lat[1:])
    with pytest.raises(ValueError):
        ops.TrackerWalk(cfg, 8, track_pool=512).process(
            ops.TrackerWalk(cfg, 8, track_pool=512).init_state(2, dev), *lat)
    # Pools past a block's shared memory: the global instance, its count.
    big = ops.TrackerWalk(cfg, 8, track_pool=256, split_repeats=True)
    before = (ops.launches, ops.global_launches)
    big.process(big.init_state(2, dev), *lat)
    torch.cuda.synchronize()
    assert (ops.launches, ops.global_launches) == (before[0], before[1] + 1)
    with pytest.raises(RuntimeError):
        big.kernel(big.init_state(2, dev), *lat, "shared")


def test_gateway_device_tracker_on_card_equals_cpu(dev):
    """PyramidGateway(tracker="device") on the card (the lattice and the
    walk kernels) and on the CPU (their plain versions): the same
    packets, both golden PDUs on every channel."""
    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway

    cfg = _cfg(8).replace(payload_len=8)
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                         pad_back=0)
    total = 1000 + 22 * n + 2 * (13 * n + 18 * n) + 8 * n + 2 * 777
    iq = np.zeros((3, total), np.complex64)
    for c in range(3):
        off = 1000 + c * 777
        iq[c, off:off + len(p1)] += p1
        o2 = off + 16 * n + 4 * n // 8 + 204
        iq[c, o2:o2 + len(p2)] += p2
    runs = []
    for device in (dev, "cpu"):
        gw = PyramidGateway(cfg, 3, block_hops=512, max_peaks=8,
                            backend="fused", tracker="device",
                            device=device)
        pkts = gw.feed(to_ri(iq)) + gw.flush()
        runs.append(sorted((p.channel, p.position, p.symbols.tolist())
                           for p in pkts))
        assert gw.stats()["deviations"] == 0
        pdus = {(p.channel, bytes(p.result.payload).hex()) for p in pkts
                if p.result.ok and p.result.crc_ok}
        assert {(c, x) for c in range(3) for x in (PDU1, PDU2)} <= pdus
    assert runs[0] == runs[1]


def test_fsm_gateway_grid_on_card_equals_mesh_none(dev):
    """The FSM gateway (dist/gateway) on a {ch: 2, t: 4} grid of slots on
    the card equals demod_fn over the whole stream (mesh=None): every
    packet once, at the same global position (blocks of whole symbols,
    one packet a channel, so the FSM's symbol grid is the stream's when
    it meets it), three channels' across a t seam."""
    from gr_lora_tpu_torch.dist.gateway import (gateway_receive,
                                                make_gateway, make_mesh,
                                                right_halo_len)
    from gr_lora_tpu_torch.models.demodulator import demod_fn

    cfg = LoraConfig(sf=7, cr=2, crc=True, ldr=False, explicit_header=False,
                     payload_len=4, p=2, fft_factor=2)
    n = cfg.num_samples
    pkt = to_ri(modulate(encode(bytes([0xDE, 0xAD, 0xBE, 0xEF]), cfg), cfg,
                         pad_front=0, pad_back=0))
    block = -(-right_halo_len(cfg) // n) * n
    iq = np.zeros((4, 4 * block, 2), np.float32)
    for c in range(4):
        off = (c + 1) * block - len(pkt) // 2 + 37 * c if c < 3 \
            else 2 * block + block // 3
        iq[c, off:off + len(pkt)] = pkt
    grid = make_mesh(2, 4, devices=[dev] * 8)
    got = gateway_receive(make_gateway(cfg, grid, 4, block, max_packets=4),
                          iq, cfg)
    syms, lens, pos, cnt, _, _ = (a.cpu().numpy() for a in demod_fn(
        cfg, iq.shape[1], 8, device=dev)(torch.from_numpy(iq).to(dev)))
    ref = [[(int(pos[c, r]), syms[c, r, :lens[c, r]].tolist())
            for r in range(int(cnt[c]))] for c in range(4)]
    assert [[(p, s.tolist()) for p, s in ch] for ch in got] == ref
    assert all(len(ch) == 1 for ch in ref)


def test_always_on_grid_on_card_equals_mesh_none(dev):
    """PyramidGateway at fastp (K5) on a {ch: 2, t: 4} grid on the card
    equals mesh=None on the card: the same packets, both golden PDUs on
    every channel, K5 launched once a slot batch."""
    from gr_lora_tpu_torch.dist.gateway import make_mesh
    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway

    cfg = _cfg(8).replace(payload_len=8)
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg, pad_front=0,
                         pad_back=0)
    total = 1000 + 4 * 4 * n + 76 * n
    iq = np.zeros((4, total), np.complex64)
    for c in range(4):
        base = 1000 + c * 4 * n
        o2 = base + 16 * n + 4 * n // 8 + 204
        iq[c, base:base + len(p1)] += p1
        iq[c, o2:o2 + len(p2)] += p2
    runs = []
    for mesh in (None, make_mesh(2, 4, devices=[dev] * 8)):
        gw = PyramidGateway(cfg, 4, block_hops=512, max_peaks=8,
                            backend="fastp", mesh=mesh, device=dev)
        mods = [m for m in gw.lattice.modules()
                if type(m) is OverlapSpectra]
        pkts = gw.feed(to_ri(iq)) + gw.flush()
        assert mods and sum(m.launches for m in mods) > 0
        runs.append(sorted((p.channel, p.position, p.symbols.tolist())
                           for p in pkts))
        pdus = {(p.channel, bytes(p.result.payload).hex()) for p in pkts
                if p.result.ok and p.result.crc_ok}
        assert {(c, x) for c in range(4) for x in (PDU1, PDU2)} <= pdus
    assert runs[0] == runs[1]
