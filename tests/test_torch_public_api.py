"""The public names and arguments the port took over from the JAX package
(tests/test_torch_api_parity.py guards that none is missing; this file
checks what they do, on the CPU):

- ``models/pyramid.make_peak_lattice`` against the JAX one at SF7 on the
  same numpy-seeded IQ (the "xla" backend: the same peaks up to f32 ties,
  heights within rtol 1e-4), and the same module on a second call however
  its arguments are passed; ``pyramid_demodulate`` and SIC reuse it;
- ``native.available()``: the host library builds here;
- the ``ops`` namespace's re-exports and the top-level ``__version__``,
  ``__all__`` and lazy attributes, equal to the JAX package's names;
- ``TrackerWalk.init_state`` defaults to the card as every entry point
  does (raising without a CUDA device), ``StreamingChannelizer.feed``
  takes ``iq_ri`` by keyword.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gr_lora_tpu
import gr_lora_tpu.ops as jops
import gr_lora_tpu_torch
import gr_lora_tpu_torch.ops as tops
from gr_lora_tpu.models.pyramid import make_peak_lattice as jax_lattice
from gr_lora_tpu_torch import native
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models import pyramid
from gr_lora_tpu_torch.models import sic
from gr_lora_tpu_torch.models.device_tracker import make_device_tracker
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks
from gr_lora_tpu_torch.pipeline.channelizer import StreamingChannelizer
from test_torch_core import config_pair


def _cfg():
    return config_pair(sf=7, cr=1, crc=True, ldr=False, explicit_header=True,
                       payload_len=4, p=2, fft_factor=2, threshold=5.0)


def _signal(cfg, seed=7):
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, 4]), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    total = len(pkt) + 6 * n
    iq = (0.01 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[2 * n:2 * n + len(pkt)] += pkt
    return to_ri(iq)


def test_make_peak_lattice_matches_jax_and_is_cached():
    jcfg, cfg = _cfg()
    iq = _signal(cfg)
    nh = pyramid.num_hops_for(cfg, iq.shape[0])
    lat = pyramid.make_peak_lattice(cfg, nh, 8, "xla", "cpu")
    assert lat is pyramid.make_peak_lattice(cfg, nh, max_peaks=8,
                                            backend="xla",
                                            device=torch.device("cpu"))
    assert lat is not pyramid.make_peak_lattice(cfg, nh, 16, "xla", "cpu")
    ours = lat(torch.from_numpy(iq))
    ref = jax.device_get(jax_lattice(jcfg, nh, 8, "xla")(jnp.asarray(iq)))
    assert ref[3].any()
    faw = lat.spectra(torch.from_numpy(iq))[1]
    compare_peaks(ref, ours, 1e-4, faw=faw, threshold=cfg.threshold)
    # The one-shot decoder and SIC's dense passes take the same module.
    hits = pyramid._lattice.cache_info().hits
    pyramid.pyramid_demodulate(iq, cfg, max_peaks=8, device="cpu")
    sic._demod_pass(iq, cfg, 8, "xla", 0, True, device=torch.device("cpu"))
    assert pyramid._lattice.cache_info().hits == hits + 2


def test_make_peak_lattice_defaults_to_the_card(monkeypatch):
    _, cfg = _cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pyramid.make_peak_lattice(cfg, 16)


def test_native_available():
    assert native.available() is True


def test_ops_namespace_matches_jax():
    """The JAX ``ops`` names, ZoomDft in place of BandSpec / ZoomDftPlan;
    each the object of its module."""
    want = set(jops.__all__) - {"BandSpec", "ZoomDftPlan"} | {"ZoomDft"}
    assert set(tops.__all__) == want
    from gr_lora_tpu_torch.ops import chirp, cplx, dechirp, dft
    for name in tops.__all__:
        mod = next(m for m in (chirp, cplx, dechirp, dft) if hasattr(m, name))
        assert getattr(tops, name) is getattr(mod, name)


def test_top_level_names_match_jax():
    assert gr_lora_tpu_torch.__version__ == gr_lora_tpu.__version__
    assert gr_lora_tpu_torch.__all__ == gr_lora_tpu.__all__
    for name in ("blocks", "blocks_meta", "native"):
        mod = getattr(gr_lora_tpu_torch, name)
        assert mod.__name__ == f"gr_lora_tpu_torch.{name}"
    with pytest.raises(AttributeError):
        gr_lora_tpu_torch.no_such_name


def test_tracker_state_defaults_to_the_card(monkeypatch):
    _, cfg = _cfg()
    walk = make_device_tracker(cfg, 8)
    assert walk is make_device_tracker(cfg, max_peaks=8, track_pool=64)
    assert walk.init_state(2, "cpu")["t_active"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        walk.init_state(2)


def test_streaming_channelizer_feed_takes_iq_ri():
    ch = StreamingChannelizer(4, 500e3, device="cpu")
    x = np.random.default_rng(1).standard_normal((4096, 2)).astype(np.float32)
    a = ch.feed(iq_ri=x)
    b = StreamingChannelizer(4, 500e3, device="cpu").feed(x)
    assert torch.equal(a, b)
