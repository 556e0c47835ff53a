"""K6's and K3's walks on the shared wgmma + TMA product (the plain-torch
models of csrc/direct_spectra.cu ``grl_chunk_spectra`` and
csrc/rdft_spectra.cu) against the plain versions.

- K6's kernel weights (``ops/direct.chunk_weights``, K4b's
  ``direct_weights`` in chunk-row order) are the component weights' bf16
  values under a permutation (chunk-layout rows r w + c -> r lw + c, the
  pad rows dropped, columns into K4b's 16-bin interleave), bit for bit.
- K6's A tiles, loaded as the kernel's TMA boxes from the bf16 chunk rows
  (never from the pad columns), are the plain version's bf16 frames; the
  folds through wgmma's accumulator mapping are within 1e-4 of
  ``ChunkSpectra.plain``'s largest value (another f32 summation order).
- K3's W is a permutation of ``rdft_weights``' bf16 values into 32-bin
  pair tiles [cos S1 | -sin S1 | cos S2 | -sin S2] (rows past n zero);
  its A tiles hold the plain version's bf16 operands in the row order
  16 w + 8 i + r; the recombination and folds through the m64n128
  accumulator mapping and the mirror pairing are within 1e-4 of
  ``RdftSpectra.plain``'s largest value, at bins 0, K/2 and K-1 too.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.ops import chunk_spectra as cs
from gr_lora_tpu_torch.ops import rdft_spectra as rs
from gr_lora_tpu_torch.ops.dechirp import frame_signal
from gr_lora_tpu_torch.ops.direct import (chunk_weights, direct_weights,
                                          tile_spectra)

HOPS = 150                      # two K6 frame tiles and three K3 ones


def _cfg(sf, ff, p=2):
    return LoraConfig(sf=sf, cr=1, crc=True, ldr=False,
                      explicit_header=sf > 6, payload_len=4, p=p,
                      fft_factor=ff, threshold=5.0)


def _iq(cfg, hops, extra, seed):
    """[2, T, 2] noise with strong tones, T = the frames' need + extra."""
    n = cfg.num_samples
    t_len = (hops - 1) * (n // 8) + n + extra
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal((2, t_len, 2))
    s = np.arange(t_len)
    for lane, f0 in enumerate((0.11, 0.37)):
        ph = 2 * np.pi * (f0 * s + 0.5 * s * s / n)
        x[lane, :, 0] += np.cos(ph)
        x[lane, :, 1] += np.sin(ph)
    return torch.from_numpy(x.astype(np.float32))


def _close(got, ref, rtol=1e-4):
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= rtol * scale


@pytest.mark.parametrize("sf,ff,p", [(7, 2, 2), (7, 8, 1), (8, 8, 2),
                                     (6, 1, 1), (6, 8, 2), (7, 1, 3)])
def test_chunk_kernel_weights_are_a_permutation(sf, ff, p):
    """At hops 32, 16, 64, 8, 16 and 48: the chunk walk's W of K6, and of
    K4b / K4 where the hop is no multiple of 32."""
    cfg = _cfg(sf, ff, p)
    n = cfg.num_samples
    hop, beta = n // 8, float(cfg.beta)
    w, lw = cs.row_width(hop), cs.live_width(hop)
    k = cfg.bin_size
    got = chunk_weights(sf, p, ff, beta)
    assert got.dtype == torch.bfloat16 and got.shape == (8 * lw, 8 * k)
    cw = cs.component_weights(sf, p, ff, beta)
    # Row r lw + c, column 128 g + 32 comp + 16 j + b holds matrix
    # 2 comp + j at chunk row r w + c, bin 16 g + b.
    r, c = np.divmod(np.arange(8 * lw), lw)
    col = np.arange(8 * k)
    g, rest = np.divmod(col, 128)
    comp, rest = np.divmod(rest, 32)
    j, b = np.divmod(rest, 16)
    ref = cw[torch.from_numpy(2 * comp + j)[None, :],
             torch.from_numpy(r * w + c)[:, None],
             torch.from_numpy(16 * g + b)[None, :]]
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    # The dropped rows [lw, w) of every chunk row are zero in the
    # component weights.
    assert not cw.reshape(8, 8, w, k)[:, :, lw:].any()
    # Row for row, K4b's weights: chunk column c < hop is re sample
    # r hop + c, hop <= c < 2 hop im sample r hop + c - hop; columns in
    # [2 hop, lw) are zero.
    dw = direct_weights(sf, p, ff, beta)
    src = np.where(c < hop, r * hop + c, n + r * hop + c - hop)
    live = torch.from_numpy(c < 2 * hop)
    assert torch.equal(got[live].view(torch.int16),
                       dw[torch.from_numpy(src[c < 2 * hop])]
                       .view(torch.int16))
    assert not got[~live].any()


@pytest.mark.parametrize("extra", [-45, 37])
@pytest.mark.parametrize("sf,ff,p", [(7, 2, 2), (7, 8, 1)])
def test_chunk_tile_walk_matches_plain(sf, ff, p, extra):
    """At SF7 x ff 2 half of each chunk row is pad (hop 32, w 128, lw
    64) and the walk skips it; at p 1 hop is 16 samples."""
    cfg = _cfg(sf, ff, p)
    hop = cfg.num_samples // 8
    mod = cs.ChunkSpectra(cfg, HOPS)
    iq = _iq(cfg, HOPS, extra, seed=sf + ff + p)
    rows = cs.row_chunks(iq, hop, mod.width, HOPS).to(torch.bfloat16)
    assert rows.shape == (2, HOPS + 7, mod.width)
    a = cs.tile_frames(rows, hop, HOPS)
    lw = cs.live_width(hop)
    assert a.shape == (2, 256, 8 * lw)
    if lw < mod.width:
        assert lw == 2 * hop           # the pad columns are never read
    # The boxes give the plain version's bf16 frame matrix, in chunk
    # order: column r lw + c of frame f is chunk row f + r, column c.
    frames = mod.chunks(iq).unfold(-2, 8, 1).transpose(-1, -2)
    ref = frames[..., :lw].reshape(2, HOPS, -1).to(torch.bfloat16)
    assert torch.equal(a[:, :HOPS].view(torch.int16), ref.view(torch.int16))
    assert not a[:, HOPS + 7:].any()
    got = [x[:, :HOPS] for x in tile_spectra(a, mod.w_kernel)]
    _close(got, mod.plain(iq))


@pytest.mark.parametrize("sf,ff,p", [(7, 2, 2), (7, 1, 1), (8, 8, 2)])
def test_rdft_tile_weights_are_a_permutation(sf, ff, p):
    cfg = _cfg(sf, ff, p)
    n, k = cfg.num_samples, cfg.bin_size
    kp = k + 128
    got = rs.tile_weights(sf, p, ff)
    npad = -(-n // 64) * 64
    nt = k // 64 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (npad, nt * 128)
    assert not got[n:].any()
    w = torch.from_numpy(rs.rdft_weights(sf, p, ff)).to(torch.bfloat16)
    for t in (0, 1, nt - 2, nt - 1):
        b0 = 32 * t
        j = torch.arange(32)
        cols = torch.cat([b0 + j, kp + b0 + j, k - b0 - j, kp + k - b0 - j])
        assert torch.equal(got[:n, 128 * t:128 * (t + 1)].view(torch.int16),
                           w[:, cols].view(torch.int16))


@pytest.mark.parametrize("sf,ff,p,extra", [(7, 2, 2, -45), (7, 1, 1, 37),
                                           (8, 8, 2, 5)])
def test_rdft_tile_walk_matches_plain(sf, ff, p, extra):
    cfg = _cfg(sf, ff, p)
    n, k = cfg.num_samples, cfg.bin_size
    hop = n // 8
    mod = rs.RdftSpectra(cfg, HOPS)
    iq = _iq(cfg, HOPS, extra, seed=10 * sf + ff + p)
    a = rs.frame_tiles(iq, mod.consts, n, hop, HOPS)
    npad = -(-n // 64) * 64
    assert a.shape == (2, 3, 2, 128, npad) and a.dtype == torch.bfloat16
    # Row 16 w + 8 i + r of tile t: component i of frame 64 t + 8 w + r,
    # the plain version's bf16 operand; zero past the frames and n.
    fr = frame_signal(iq, n, hop, HOPS)
    xr, xi = fr[..., 0], fr[..., 1]
    dr, di, win = mod.consts[0], mod.consts[1], mod.consts[2]
    ur = xr * dr - xi * di
    ui = xr * di + xi * dr
    f = torch.arange(HOPS)
    t, fl = f // 64, f % 64
    row = 16 * (fl // 8) + fl % 8
    for pi, (x0, x1) in enumerate(((ur, ui), (ur * win, ui * win))):
        for i, x in enumerate((x0, x1)):
            got = a[:, t, pi, row + 8 * i, :n]
            assert torch.equal(got.view(torch.int16),
                               x.to(torch.bfloat16).view(torch.int16))
    last = 64 * 3 - HOPS
    assert not a[:, 2, :, :, n:].any()
    assert not a.reshape(2, 3, 2, 8, 2, 8, npad)[:, 2, :, 8 - last // 8:] \
        .any()
    got = rs.tile_spectra(a, mod.w_tiles, k, HOPS)
    ref = mod.plain(iq)
    _close(got, ref)
    # Bins 0 (partner column K), K/2 (the last pair tile alone) and K-1
    # (the mirror of bin 1) are written, not left zero.
    for b in (0, k // 2, k - 1):
        assert float(got[0][:, :, b].abs().min()) > 0
