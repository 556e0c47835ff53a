"""K6 (ops/chunk_spectra.py, backend "pallas") on the CPU against the JAX
package's ``make_pallas_spectra`` in interpret mode.

Tolerances: the dense folds within 1e-4 of their largest value (the same
bf16 frames and bit-equal weights; only the f32 summation order differs),
peak sets equal up to f32 ties (ops/peak_epilogue.compare_peaks), heights
within rtol 1e-4; ``pyramid_demodulate`` symbol vectors equal.  All at
SF7 x ff 2 and at most 256 hops, except the README collision (SF8 x ff 8,
the port alone).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gr_lora_tpu.models.pyramid import pyramid_demodulate as jax_demod
from gr_lora_tpu.ops import pallas_frontend as jpf
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for, pyramid_demodulate
from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra, row_chunks
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks, peaks_plain
from test_torch_core import config_pair

KW = dict(sf=7, cr=1, crc=True, ldr=False, explicit_header=True,
          payload_len=4, p=2, fft_factor=2, threshold=5.0)
JCFG, CFG = config_pair(**KW)
PDU1 = "0630f0010203040506050801"
PDU2 = "0530000707070707e76b01"


def _signal(seed, hops=200):
    """A packet in noise, cut to ``hops`` hop frames plus a ragged tail:
    iq float32 [T, 2]."""
    n = CFG.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, 4]), CFG), CFG,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    total = (hops - 1) * (n // 8) + n + 5
    iq = (0.01 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[n:n + len(pkt)] += pkt[:total - n]
    return to_ri(iq)


def _jax_spectra(iq, nh, **kw):
    fn = jpf.make_pallas_spectra(JCFG, nh, interpret=True, **kw)
    chunks = jpf.row_chunks(jnp.asarray(iq), JCFG, nh, **kw)
    return [np.asarray(x)[:nh] for x in jax.device_get(fn(chunks))]


@pytest.mark.parametrize("seed,hops", [(0, 200), (1, 256), (2, 37)])
def test_plain_matches_jax_interpret(seed, hops):
    iq = _signal(seed, hops)
    nh = num_hops_for(CFG, iq.shape[0])
    assert nh == hops
    ours = ChunkSpectra(CFG, nh)(torch.from_numpy(iq))
    ref = _jax_spectra(iq, nh)
    scale = max(np.abs(r).max() for r in ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * scale
    ref_peaks = peaks_plain(*(torch.tensor(r) for r in ref),
                            CFG.threshold, 8)
    assert ref_peaks[3].any()
    compare_peaks(ref_peaks, peaks_plain(*ours, CFG.threshold, 8), 1e-4,
                  faw=ref[1], threshold=CFG.threshold)


@pytest.mark.parametrize("sf,ff", [(7, 2), (7, 8), (8, 2)])
def test_weights_equal_jax_bits(sf, ff):
    """The weight buffer is ``jnp.asarray(_component_weights(cfg),
    jnp.bfloat16)`` bit for bit, in its [8, R*w, K] layout."""
    jcfg, cfg = config_pair(**{**KW, "sf": sf, "fft_factor": ff})
    ref = np.asarray(jnp.asarray(jpf._component_weights(jcfg),
                                 jnp.bfloat16)).view(np.uint16)
    ours = ChunkSpectra(cfg, 8).w
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape
    assert np.array_equal(ours.view(torch.int16).numpy().view(np.uint16),
                          ref)


def test_row_chunks_match_jax():
    """The port's chunk rows are the JAX ``row_chunks`` rows without the
    frame-tile padding of the frame count."""
    iq = _signal(3, 100)
    nh = num_hops_for(CFG, iq.shape[0])
    hop = CFG.num_samples // 8
    ours = row_chunks(torch.from_numpy(iq), hop, jpf._row_width(hop), nh)
    ref = np.asarray(jpf.row_chunks(jnp.asarray(iq), JCFG, nh))
    assert ours.shape == (nh + 7, jpf._row_width(hop))
    assert np.array_equal(ours.numpy(), ref[:nh + 7])


def test_padded_tail_gives_zero_spectra():
    """Frames past the end of the stream read zero-padded chunk rows and
    give exactly zero spectra."""
    iq = _signal(4, 64)
    nh = num_hops_for(CFG, iq.shape[0])
    fa, faw, hs = ChunkSpectra(CFG, nh + 24)(torch.from_numpy(iq))
    assert fa.shape == (nh + 24, CFG.bin_size)
    assert float(fa[:nh].max()) > CFG.threshold
    for t in (fa, faw, hs):
        assert float(t[nh + 8:].abs().max()) == 0.0


def test_pyramid_demodulate_matches_jax_pallas():
    """tests/test_pallas_frontend.py's scenario: the port's and the JAX
    package's ``pyramid_demodulate(backend="pallas")`` give equal symbol
    vectors."""
    iq = np.concatenate([
        np.zeros((1000, 2), np.float32),
        0.2 * to_ri(modulate(encode(bytes([1, 2, 3, 4]), CFG), CFG,
                             pad_front=0, pad_back=0)),
        np.zeros((4 * CFG.num_samples, 2), np.float32),
    ]).astype(np.float32)
    ours = pyramid_demodulate(iq, CFG, backend="pallas", device="cpu")
    ref = jax_demod(iq, JCFG, backend="pallas")
    assert len(ours) == len(ref) == 1
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))


def test_readme_collision_golden_pdus():
    """The README two-packet collision (SF8 x ff 8) decodes to both golden
    PDUs through backend "pallas"."""
    _, cfg = config_pair(**{**KW, "sf": 8, "fft_factor": 8,
                            "payload_len": 8})
    n = cfg.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg)
    off2 = 1000 + 16 * n + 4 * n // 8 + 204
    iq = np.zeros(off2 + len(p2) + 1000, np.complex64)
    iq[1000:1000 + len(p1)] += p1
    iq[off2:off2 + len(p2)] += p2
    syms = pyramid_demodulate(iq, cfg, backend="pallas", device="cpu")
    pdus = {bytes(r.payload).hex() for r in (decode(s, cfg) for s in syms)
            if r.ok and r.crc_ok}
    assert {PDU1, PDU2} <= pdus


def test_kernel_path_needs_cuda_tensor():
    """On a CPU tensor the module runs its plain version and counts no
    launch; its kernel entry refuses a CPU tensor."""
    mod = ChunkSpectra(CFG, 16)
    x = torch.from_numpy(_signal(5, 16))
    mod(x)
    assert mod.launches == 0
    with pytest.raises(ValueError):
        mod.kernel(x)
