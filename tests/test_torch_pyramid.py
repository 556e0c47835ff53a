"""The port's pyramid_demodulate on the README two-packet collision.

The collision is the one of tests/test_pyramid.py (sf 8, fs/bw 2,
fft_factor 8, threshold 5): both golden PDUs must decode byte-exact, and
under the fused backend the port's symbol vectors must equal the JAX
package's.  The port takes its own config and runs on the CPU here
(``device="cpu"``).
"""

import numpy as np
import pytest

from gr_lora_tpu_torch.core.codec import decode
from gr_lora_tpu.models.pyramid import pyramid_demodulate as jax_demod
from gr_lora_tpu_torch.models.pyramid import pyramid_demodulate
from test_pyramid import CFG as JAX_CFG
from test_pyramid import PDU_1, PDU_2, _N, _collision
from test_torch_core import port_config

CFG = port_config(JAX_CFG)

OFF2 = 1000 + 16 * _N + 4 * _N // 8 + 204   # deep overlap, distinct phase


def _pdus(syms):
    return {bytes(r.payload).hex() for r in (decode(s, CFG) for s in syms)
            if r.ok}


def test_fused_golden_pdus_and_jax_symbols():
    iq = _collision(OFF2)
    ours = pyramid_demodulate(iq, CFG, backend="fused", device="cpu")
    assert {PDU_1, PDU_2} <= _pdus(ours)
    ref = jax_demod(iq, JAX_CFG, backend="fused")
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("backend", ["xla", "fast"])
def test_dense_backends_golden_pdus(backend):
    assert {PDU_1, PDU_2} <= _pdus(
        pyramid_demodulate(_collision(OFF2), CFG, backend=backend,
                           device="cpu"))


def test_noisy_collision_fused():
    off2 = 1000 + 18 * _N + 2 * _N // 8 + 238
    iq = _collision(off2, noise=0.005, seed=3)
    assert {PDU_1, PDU_2} <= _pdus(pyramid_demodulate(iq, CFG,
                                                      backend="fused",
                                                      device="cpu"))


def test_python_tracker_not_ported():
    """use_native=False tracks with the Python PyramidTracker twin and
    returns the native tracker's symbol vectors."""
    iq = _collision(OFF2)
    py = pyramid_demodulate(iq, CFG, use_native=False, device="cpu")
    nat = pyramid_demodulate(iq, CFG, use_native=True, device="cpu")
    assert len(py) == len(nat) >= 2
    assert all(np.array_equal(a, b) for a, b in zip(py, nat))
    assert {PDU_1, PDU_2} <= _pdus(py)
