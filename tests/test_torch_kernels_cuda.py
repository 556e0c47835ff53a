"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (decided inside the fixture, never at
import) where ``torch.cuda.is_available()`` is false.  On a machine with
an NVIDIA GPU and nvcc, run ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`` (the file imports no JAX; the repo's
conftest.py does, and such a machine need not have it).

Shapes beyond the always-on main path: K5 and K2 at fft_factor 16 (the
wider ring), peak_topm, K1, K2 and K4 at M > 16 (each then runs its
dense front end and peak_topm), K3 / K1 and K6 at p 1 (hop 16 samples)
and on ragged frame counts.  K1's, K2's and K4's fused searches keep
their peak allocation below one dense [lanes, hops, K] f32 array.  The
FSM device loop (models/fsm_loop), which has no kernel of its own: its
replayed CUDA graph leaves every lane's state equal to the same steps run
launch by launch, for both machines.

Tolerances: K1, K3, K4b, K4 and K6's plain versions are the same
bf16-operand / f32-accumulate class in another summation order (heights
rtol 1e-3; a peak may differ only where an f32 tie decides it, see
peak_epilogue.compare_peaks; the dense K3 / K4b / K6 spectra within 1e-4
of their largest value; P1's value rtol 1e-3).  K2, K5, the epilogue and
P2's chain round as their plain versions do and must equal them exactly.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for, pyramid_demodulate
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
                      explicit_header=True, payload_len=4, p=p,
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
    edges: the kernel epilogue is the plain one, bit for bit."""
    rng = np.random.default_rng(m)
    faw = rng.random((37, 1024)).astype(np.float32) * 10
    faw[:, ::97] = 9.5                       # equal values, distinct bins
    faw[:, 0] = 12.0                         # wrap-around neighbours
    faw[:, -1] = 11.0
    fa = rng.random((37, 1024)).astype(np.float32)
    hs = rng.random((37, 1024)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (fa, faw, hs)]
    kern = launch_topm(*t, 5.0, m)
    plain = peaks_plain(*t, 5.0, m)
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu(), b.cpu())


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
    # The direct kernel's limits: hop = n / 8 a multiple of 32 samples (p 1
    # at SF7 gives 16), max_peaks of the fused search at most 16.
    x = torch.zeros((2, 4096, 2), device=dev)
    for mod in (DirectSpectra(_cfg(7, 8, 1), 16),
                DirectPeaks(_cfg(7, 8, 1), 16)):
        with pytest.raises(RuntimeError, match="multiple of 32"):
            mod.to(dev)(x)
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
    """K3 and K6 at SF7 p 1: n 128, hop 16 samples (K4b refuses it)."""
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


@pytest.mark.parametrize("sf,ff", [(7, 2), (8, 8)])
def test_direct_kernels_ragged_frames(dev, sf, ff):
    """K4b and K4 on a frame count that is no multiple of the 128-frame
    tile, from a stream whose length is no multiple of hop and shorter
    than the frames need (zero-padded): K4b within 1e-4 of its plain
    version with zero spectra on the padded tail, K4 the plain peaks."""
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
    lat = sic.lattice(cfg, num_hops_for(cfg, len(iq)), 16, "fused", None,
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
# The FSM device loop (models/fsm_loop): no kernel of its own, but the
# replayed CUDA graph must equal the same steps run launch by launch.
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
    card = StreamingDemodulator(cfg, block_len=8 * n, device=dev)
    cut = len(pkt) + 37 * n + len(pkt) // 2
    before = card.feed(iq[:cut])
    cpu = StreamingDemodulator(cfg, block_len=8 * n, device="cpu")
    cpu.load_state_dict(card.state_dict())
    after = cpu.feed(iq[cut:]) + cpu.flush()
    assert [(p, s.tolist()) for p, s in before + after] == runs[1][0]
