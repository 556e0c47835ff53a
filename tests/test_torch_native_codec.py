"""The port's native codec twin (csrc/host/lora_codec.cc) against the
port's NumPy core and the JAX package's native library, over
tests/test_native.py's grid: the three codecs agree (CLAUDE.md's
invariant: the NumPy core, the C++ twin and the in-graph header parser;
the header parser is held by tests/test_torch_demodulator.py)."""

import numpy as np
import pytest

from gr_lora_tpu import native as jnative
from gr_lora_tpu_torch import native
from gr_lora_tpu_torch.core.codec import decode as py_decode
from gr_lora_tpu_torch.core.codec import encode as py_encode
from gr_lora_tpu_torch.core.constants import WHITENING_SEQUENCE
from gr_lora_tpu_torch.core.crc import data_checksum
from test_torch_core import config_pair


def _grid():
    rng = np.random.default_rng(42)
    for sf in range(6, 13):
        for cr in (1, 4):
            for ldr in (False, True):
                for hdr in (False, True):
                    if hdr and sf == 6:
                        continue
                    for crc in (False, True):
                        plen = int(rng.integers(1, 24))
                        yield sf, cr, ldr, hdr, crc, plen


def _jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    return jnative


def test_library_holds_codec_and_ring():
    """One host library, built from the port's three sources."""
    lib = native.library()
    for name in ("lora_encode", "lora_decode", "lora_ring_create",
                 "lora_pyramid_multi_create"):
        assert hasattr(lib, name)
    assert native.LIB_PATH.parent.name == "_build"


def test_whitening_sequence_identical():
    assert np.array_equal(native.whitening_sequence(), WHITENING_SEQUENCE)
    assert np.array_equal(native.whitening_sequence(),
                          _jax_native().whitening_sequence())


def test_data_checksum_matches():
    jn = _jax_native()
    rng = np.random.default_rng(0)
    for ln in (0, 1, 2, 3, 8, 64, 255):
        data = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
        want = data_checksum(np.frombuffer(data, np.uint8), ln)
        assert native.data_checksum(data) == want == jn.data_checksum(data)


@pytest.mark.parametrize("sf", range(6, 13))
def test_codec_grid_three_way(sf):
    """Port native == port NumPy core == JAX native, encode and decode."""
    jn = _jax_native()
    rng = np.random.default_rng(7 + sf)
    for g_sf, cr, ldr, hdr, crc, plen in _grid():
        if g_sf != sf:
            continue
        jcfg, cfg = config_pair(sf=sf, cr=cr, crc=crc, ldr=ldr,
                                explicit_header=hdr, payload_len=plen)
        payload = bytes(rng.integers(0, 256, plen, dtype=np.uint8))
        case = (sf, cr, ldr, hdr, crc, plen)
        se = native.encode(payload, cfg)
        sp = py_encode(payload, cfg)
        assert np.array_equal(se, sp), case
        assert np.array_equal(se, jn.encode(payload, jcfg)), case

        nb, nhdr, nck, nok = native.decode(sp, cfg)
        r = py_decode(sp, cfg)
        jb, jhdr, jck, jok = jn.decode(sp, jcfg)
        assert nok == r.ok == jok, case
        assert np.array_equal(nb, r.payload), case
        assert np.array_equal(nb, jb) and nhdr == jhdr and nck == jck, case
        if crc:
            assert nck == r.crc_ok, case


def test_decode_rejects_corrupt_header():
    jcfg, cfg = config_pair(sf=8, cr=1, crc=True, explicit_header=True)
    syms = native.encode(bytes([1, 2, 3]), cfg).copy()
    syms[0] = (syms[0] + 96) % 256          # clobber a header symbol
    _, hdr, _, ok = native.decode(syms, cfg)
    assert ok == py_decode(syms, cfg).ok     # same accept/reject decision
    _, jhdr, _, jok = _jax_native().decode(syms, jcfg)
    assert (ok, hdr) == (jok, jhdr)
