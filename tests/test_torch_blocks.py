"""The port's block-style API (blocks.py), its descriptors (blocks_meta.py)
and its debug taps (debug.py) on the CPU, twins of
tests/test_blocks_api.py, tests/test_blocks_meta.py and
tests/test_debug_taps.py, each held to the JAX package's.

The receivers' outputs (symbol vectors, decoded PDUs) equal the JAX
blocks' exactly.  The taps that are pure sample arithmetic (raw frames,
dechirped frames) equal the JAX taps within 1e-6; the spectra pass through
the zoom DFT, a torch.fft here and f32 matmuls there, and are held within
1e-4 of their largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gr_lora_tpu.blocks_meta as JM
import gr_lora_tpu_torch.blocks_meta as M
from gr_lora_tpu import blocks as jblocks
from gr_lora_tpu.debug import rx_taps as jax_rx_taps
from gr_lora_tpu_torch import blocks
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.debug import dump_rx_taps, profile, rx_taps
from gr_lora_tpu_torch.models.modulator import modulate
from test_torch_core import config_pair

CPU = dict(device="cpu")


def test_blocks_encode_mod_demod_decode_chain():
    """encode -> mod -> demod -> decode (txrx_sim.grc) as calls: the
    golden PDU, and every stage equal to the JAX blocks'."""
    ours = (blocks.encode(8, 1, True, False, True), blocks.mod(8),
            blocks.demod(8, True, 8, 1, True, False, fft_factor=8,
                         fs_bw_ratio=2, **CPU),
            blocks.decode(8, True, 8, 1, True, False))
    ref = (jblocks.encode(8, 1, True, False, True), jblocks.mod(8),
           jblocks.demod(8, True, 8, 1, True, False, fft_factor=8,
                         fs_bw_ratio=2),
           jblocks.decode(8, True, 8, 1, True, False))
    got = []
    for enc, tx, rx, dec in (ours, ref):
        syms = enc(bytes([1, 2, 3, 4, 5, 6]))
        iq = tx(syms, p=2)
        pkts = rx(iq)
        assert len(pkts) == 1
        res = dec(pkts[0])
        got.append((syms.tolist(), iq, pkts[0].tolist(), res.ok,
                    bytes(res.payload).hex()))
    assert got[0][3] and got[0][4] == "0630f0010203040506050801"
    assert got[0][:1] + got[0][2:] == got[1][:1] + got[1][2:]
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_blocks_pyramid_factory():
    """pyramid_demod on a single packet: the JAX block's symbols."""
    got = []
    for mod in (blocks, jblocks):
        enc = mod.encode(8, 1, True, False, True)
        tx = mod.mod(8)
        kw = CPU if mod is blocks else {}
        pyr = mod.pyramid_demod(8, False, fft_factor=8, threshold=5.0,
                                fs_bw_ratio=2, **kw)
        iq = np.concatenate([np.zeros(1000, np.complex64),
                             0.2 * tx(enc(bytes([1, 2, 3, 4, 5, 6])), p=2),
                             np.zeros(4096, np.complex64)])
        got.append([s.tolist() for s in pyr(iq.astype(np.complex64))])
    assert got[0] == got[1] and len(got[0]) == 1


def test_blocks_weak_demod_factory():
    """weak_demod round-trips symbols through the block API, as the JAX
    block does."""
    from gr_lora_tpu_torch.models.weak import modulate_weak

    rng = np.random.default_rng(3)
    syms = rng.integers(0, 256, 10).astype(np.uint16)
    got = []
    for mod in (blocks, jblocks):
        kw = CPU if mod is blocks else {}
        wd = mod.weak_demod(8, False, 6, 1, True, False, sym_num=10,
                            fft_factor=8, fs_bw_ratio=2, **kw)
        got.append([s.tolist() for s in wd(modulate_weak(syms, wd.cfg))])
    assert got[0] == got[1] == [syms.tolist()]


def test_blocks_default_to_card():
    """The receiver blocks run on the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        blocks.pyramid_demod(8, False)(np.zeros(4096, np.complex64))


def test_blocks_meta_equals_jax():
    """Every descriptor equals the JAX one field for field; the ids,
    defaults and port shapes of tests/test_blocks_meta.py; each factory
    resolves to the port's blocks."""
    assert [b.id for b in M.ALL_BLOCKS] == [
        "lora_mod", "lora_encode", "lora_decode", "lora_demod",
        "lora_pyramid_demod", "lora_weak_demod"]
    for ours, ref in zip(M.ALL_BLOCKS, JM.ALL_BLOCKS):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.defaults() == ref.defaults()
        assert hasattr(blocks, ours.factory), ours.factory
    assert M.get("lora_mod").defaults() == {"spreading_factor": 8,
                                            "sync_word": 0x12}
    p = M.get("lora_pyramid_demod").defaults()
    assert p["fft_factor"] == 2 and p["threshold"] == 0.005
    pd = M.get("lora_pyramid_demod")
    assert [x.domain for x in pd.inputs] == ["stream", "message"]
    assert M.get("lora_mod").outputs[0].dtype == "complex"
    with pytest.raises(KeyError):
        M.get("lora_nope")


def test_rx_taps_equal_jax(tmp_path):
    """rx_taps / dump_rx_taps: shapes, files, the preamble's dominant
    tone, and every tap against the JAX package's."""
    jcfg, cfg = config_pair(sf=7, cr=1, crc=True, ldr=False,
                            explicit_header=False, payload_len=4, p=2,
                            fft_factor=2)
    iq = modulate(encode(bytes([1, 2, 3, 4]), cfg), cfg)
    taps = dump_rx_taps(iq, cfg, tmp_path, **CPU)
    n, k = cfg.num_samples, cfg.bin_size
    num = (len(iq) - n) // (n // 8) + 1
    assert taps["raw"].shape == (num, n, 2)
    assert taps["dechirped"].shape == (num, n, 2)
    assert taps["folded"].shape == (num, k)
    assert taps["pyramid_fft_add"].shape == (num, k)
    folded = taps["folded"][4 * 8:6 * 8]
    assert (folded.max(-1) > 10 * np.median(folded, -1)).all()
    assert np.array_equal(np.load(tmp_path / "folded.npy"), taps["folded"])
    ref = {name: np.asarray(v) for name, v in jax_rx_taps(iq, jcfg).items()}
    assert set(ref) == set(taps)
    for name, v in taps.items():
        scale = 1.0 if name in ("raw", "dechirped") else \
            float(np.abs(ref[name]).max())
        tol = 1e-6 if name in ("raw", "dechirped") else 1e-4
        np.testing.assert_allclose(v, ref[name], rtol=0, atol=tol * scale,
                                   err_msg=name)
    hop = rx_taps(iq, cfg, hop=n // 4, **CPU)["raw"]
    assert hop.shape[0] == (len(iq) - n) // (n // 4) + 1


def test_profile_writes_a_trace(tmp_path):
    with profile(tmp_path / "prof") as d:
        rx_taps(np.zeros(4096, np.complex64),
                config_pair(sf=7, p=2, fft_factor=2)[1], **CPU)
    assert (d / "trace.json").stat().st_size > 0
