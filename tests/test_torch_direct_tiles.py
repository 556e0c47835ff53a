"""K4b / K4's walk (ops/direct: chunk_planes, tile_frames, tile_spectra,
sweep_peaks — the plain-torch model of csrc/direct_spectra.cu) against the
plain versions.

- The frame tiles the kernel's TMA boxes read from the bf16 chunk planes
  equal ``frame_signal``'s frames rounded to bf16, bit for bit, with
  ``t_len`` no multiple of hop, shorter and longer than the frames need,
  and a frame count no multiple of the 128-frame tile.
- The spectra folded through wgmma's accumulator-to-bin mapping match
  ``DirectSpectra.plain`` within 1e-4 of the largest value (the model sums
  the same exact bf16 products in another order).
- The row sweep (quad neighbours, the carried and deferred tile edges,
  the wrap at bins 0 and K-1, the top-M lists) equals ``peaks_plain`` on
  the same folds, bit for bit: both compare and select the same f32
  values.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.dechirp import frame_signal
from gr_lora_tpu_torch.ops.direct import (DirectSpectra, chunk_planes,
                                          sweep_peaks, tile_frames,
                                          tile_spectra)
from gr_lora_tpu_torch.ops.peak_epilogue import peaks_plain

CASES = [(7, 2), (7, 8), (8, 8)]
HOPS = 150                      # two frame tiles, the second ragged


def _cfg(sf, ff):
    return LoraConfig(sf=sf, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=4, p=2, fft_factor=ff, threshold=5.0)


def _iq(cfg, t_len, seed):
    """[2, t_len, 2]: noise and one packet a lane."""
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    out = []
    for lane in range(2):
        iq = (0.01 * (rng.standard_normal(t_len)
                      + 1j * rng.standard_normal(t_len))).astype(np.complex64)
        o = n // 3 + 101 * lane
        seg = pkt[:t_len - o]
        iq[o:o + len(seg)] += seg
        out.append(to_ri(iq))
    return torch.from_numpy(np.stack(out))


def _need(cfg, nh):
    n = cfg.num_samples
    return (nh - 1) * (n // 8) + n


@pytest.mark.parametrize("extra", [-37, 45])
@pytest.mark.parametrize("sf,ff", CASES)
def test_tile_frames_equal_frame_signal(sf, ff, extra):
    cfg = _cfg(sf, ff)
    n = cfg.num_samples
    hop = n // 8
    t_len = _need(cfg, HOPS) + extra
    assert t_len % hop
    iq = _iq(cfg, t_len, seed=sf + ff)
    planes = chunk_planes(iq, hop, HOPS + 7)
    assert planes.dtype == torch.bfloat16
    assert planes.shape == (2, 2, HOPS + 7, hop)
    a = tile_frames(planes, n, HOPS)
    assert a.shape == (2, 256, 2 * n)
    fr = frame_signal(iq, n, hop, HOPS)
    ref = torch.cat([fr[..., 0], fr[..., 1]], dim=-1).to(torch.bfloat16)
    assert torch.equal(a[:, :HOPS].view(torch.int16), ref.view(torch.int16))
    # Frames past the planes' last row read zeros (the box's out of
    # bounds fill).
    assert not a[:, HOPS + 7:].any()


def test_tile_frames_refuses_a_box_across_rows():
    planes = torch.zeros((1, 2, 20, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tile_frames(planes, 128, 8)


@pytest.mark.parametrize("sf,ff", CASES)
def test_tile_spectra_match_plain(sf, ff):
    cfg = _cfg(sf, ff)
    n = cfg.num_samples
    iq = _iq(cfg, _need(cfg, HOPS) - 37, seed=10 + sf + ff)
    mod = DirectSpectra(cfg, HOPS)
    a = tile_frames(chunk_planes(iq, n // 8, HOPS + 7), n, HOPS)
    got = [x[:, :HOPS] for x in tile_spectra(a, mod.w)]
    ref = mod.plain(iq)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * scale
    # The model's sweep on the model's folds is peaks_plain on them.
    peaks = sweep_peaks(*got, cfg.threshold, 8)
    assert peaks[3].any()
    for g, r in zip(peaks, peaks_plain(*got, cfg.threshold, 8)):
        assert torch.equal(g, r)


def _crafted(k):
    """Folds [rows, k] with the sweep's edge cases, each row one case."""
    rng = np.random.default_rng(k)
    faw = rng.random((12, k)).astype(np.float32) * 4       # below threshold
    # 0: a peak at bin 0 (its left neighbour is bin K-1).
    faw[0, [k - 1, 0, 1]] = [6.0, 9.0, 6.0]
    # 1: a peak at bin K-1 (its right neighbour is bin 0).
    faw[1, [k - 2, k - 1, 0]] = [6.0, 9.0, 6.0]
    # 2: bin 0 above its right neighbour but below bin K-1: only K-1.
    faw[2, [k - 2, k - 1, 0, 1]] = [6.0, 10.0, 9.0, 6.0]
    # 3: peaks on both sides of tile edges, and tile-edge bins that lose
    # to the neighbour across the edge.
    faw[3, [30, 31, 32, 33, 34]] = [6.0, 9.0, 7.0, 8.0, 6.0]
    faw[3, [63, 64, 65]] = [6.5, 8.5, 6.0]
    faw[3, [95, 96]] = [8.0, 9.5]
    faw[3, [127, 128, 129]] = [9.0, 9.5, 5.5]
    # 4: exact ties at distinct bins, a plateau (no strict maximum), a
    # value equal to the threshold.
    faw[4, [10, 40, 200]] = 7.0
    faw[4, [100, 101]] = 8.0
    faw[4, 150] = 5.0
    # 5: more than M candidates in one tile.
    faw[5, 64:96:2] = 6.0 + 0.1 * np.arange(16)
    # 6: twenty equal peaks: the top-M cut keeps the lowest bins.
    faw[6, 3:3 + 40:2] = 7.0
    # 7: nothing above the threshold.
    # 8-11: many random peaks.
    faw[8:] = rng.random((4, k)).astype(np.float32) * 10
    fa = rng.random((12, k)).astype(np.float32)
    hs = rng.random((12, k)).astype(np.float32)
    return [torch.from_numpy(x) for x in (fa, faw, hs)]


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k", [256, 1024])
def test_sweep_equals_plain_on_edge_cases(k, m):
    fa, faw, hs = _crafted(k)
    got = sweep_peaks(fa, faw, hs, 5.0, m)
    ref = peaks_plain(fa, faw, hs, 5.0, m)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    bins, valid = ref[0], ref[3]
    assert bins[0, 0] == 0 and valid[0, 0]
    assert bins[1, 0] == k - 1 and bins[2, 0] == k - 1
    assert not valid[7].any()
    if m >= 8:
        assert {31, 33, 64, 96, 128} <= set(bins[3][valid[3]].tolist())
        assert bins[4][valid[4]].tolist() == [10, 40, 200]
        assert valid[5].all() and bins[5, 0] == 94
        assert bins[6].tolist() == list(range(3, 3 + 2 * m, 2))
