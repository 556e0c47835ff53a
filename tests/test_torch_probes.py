"""The probe kernels' plain versions (ops/probes.py) against NumPy.

P1's plain value is the two corner entries of the bf16 products summed in
f32 (NumPy sums the same exact products in float64: rtol 1e-5).  P2's
chain rounds each operation to f32 as NumPy's float32 arithmetic does,
except that torch's CPU square root is not correctly rounded (about one
result in 160 is one ulp off), so its slab agrees with NumPy's within
rtol 1e-5 over 6 rounds; on the card, where both take a correctly rounded
square root, the kernel's slab equals the plain one bit for bit
(tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.ops.probes import (CHAIN_PER, CHAIN_THREADS,
                                          MAIN_SHAPE, OverlapProbe,
                                          RateProbe, chain_round,
                                          chain_split, overlap_grid,
                                          probe_inputs)


def _np_chain(a, rounds):
    f = np.float32
    for _ in range(rounds):
        b = a * f(1.0001) + f(0.1)
        m = np.sqrt(a * a + b * b)
        g = np.sqrt(np.maximum(a + m, f(0.1)) * (b - m) * (b - m) + f(1.0))
        a = f(0.25) * (m + g) + f(0.5) * np.maximum(m, g)
    return a


def test_probe_inputs_follow_the_jax_probes_draws():
    x, w, v0 = probe_inputs(16, 32, 64, seed=0)
    rng = np.random.default_rng(0)
    xr = rng.normal(0, 1, (4, 16, 32)).astype(np.float32)
    wr = rng.normal(0, 1, (32, 64)).astype(np.float32)
    vr = rng.uniform(0.5, 1.5, (16, 1280)).astype(np.float32)
    assert x.dtype == w.dtype == torch.bfloat16 and v0.dtype == torch.float32
    np.testing.assert_array_equal(x.float().numpy(),
                                  torch.from_numpy(xr).bfloat16().float())
    np.testing.assert_array_equal(w.float().numpy(),
                                  torch.from_numpy(wr).bfloat16().float())
    np.testing.assert_array_equal(v0.numpy(), vr)
    assert MAIN_SHAPE == (256, 512, 4352)


def test_rate_probe_plain_matches_numpy():
    x, w, _ = probe_inputs(64, 128, 256, seed=1)
    probe = RateProbe()
    out = probe(x, w)
    assert out.shape == (1, 1) and probe.launches == 0
    xs, ws = x.double().numpy(), w.double().numpy()
    ref = (xs[0] @ ws)[0, 0] + (xs[3] @ ws)[-1, -1]
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    assert probe.flops(x, w) == 16 * 4 * 2 * 64 * 128 * 256


def test_rate_probe_plain_scratch_holds_the_four_products():
    """P1's plain scratch is laid out as the kernel's: slab j of [rows,
    4 width] is x[j] @ w, and the value is its two corners."""
    x, w, _ = probe_inputs(16, 32, 64, seed=3)
    out, scratch = RateProbe().plain(x, w)
    assert scratch.shape == (16, 4 * 64)
    xs, ws = x.double().numpy(), w.double().numpy()
    for j in range(4):
        np.testing.assert_allclose(scratch[:, 64 * j:64 * (j + 1)].numpy(),
                                   xs[j] @ ws, rtol=1e-5, atol=1e-5)
    assert float(out) == float(scratch[0, 0] + scratch[-1, -1])


@pytest.mark.parametrize("kind", ["mxu", "vpu", "both"])
def test_overlap_probe_plain_matches_numpy(kind):
    x, w, v0 = probe_inputs(32, 64, 128, batch=1, seed=2)
    probe = OverlapProbe(kind, steps=3, rounds=2)
    out, acc, vs = probe.plain(x[0], w, v0)
    chain = kind != "mxu"
    ref_vs = _np_chain(v0.numpy(), 6) if chain else v0.numpy()
    np.testing.assert_allclose(vs.numpy(), ref_vs, rtol=1e-5)
    a00 = 0.0
    if kind != "vpu":
        ref_acc = x[0].double().numpy() @ w.double().numpy()
        np.testing.assert_allclose(acc.numpy(), ref_acc, rtol=1e-5,
                                   atol=1e-5)
        a00 = float(acc[0, 0])
    else:
        assert acc is None
    assert float(out) == float(np.float32(a00) + vs[0, 0].numpy())
    assert torch.equal(probe(x[0], w, v0), out)


def test_chain_round_overflows_as_the_jax_chain_does():
    """The chain follows NumPy's while finite, and past some 16 rounds it
    leaves the f32 range (the JAX probe's 64 steps x 2 rounds end in inf
    and NaN too), as NumPy's does."""
    a = torch.linspace(0.5, 1.5, 64)
    ref = a.numpy()
    for _ in range(8):
        a = chain_round(a)
        ref = _np_chain(ref, 1)
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-5)
    for _ in range(32):
        a = chain_round(a)
    with np.errstate(all="ignore"):
        ref = _np_chain(ref, 32)
    assert not bool(torch.isfinite(a).any()) and not np.isfinite(ref).any()


def test_overlap_probe_rejects_unknown_kind():
    with pytest.raises(ValueError):
        OverlapProbe("tensor")


@pytest.mark.parametrize("units,kblocks,steps,slab", [
    (16, 4, 4, 128 * 1280),          # (128, 256, 1024) x 4 steps
    (2176, 8, 64, 256 * 1280),       # the main shape x 64 steps
    (2177, 8, 64, 256 * 1280),
])
def test_overlap_chain_split_gives_every_element_all_rounds(units, kblocks,
                                                            steps, slab):
    """P2's grid on 132 SMs holds every slab element in exactly one
    consumer thread, and every block runs exactly steps x rounds rounds:
    paced over its stages, at most ceil(total / smax) a stage, the rest
    after its last stage (none for the busiest blocks)."""
    sms, total = 132, 2 * steps
    grid = overlap_grid(units, slab, sms)
    e = (np.arange(grid * CHAIN_THREADS)[:, None]
         + np.arange(CHAIN_PER)[None, :] * grid * CHAIN_THREADS)
    np.testing.assert_array_equal(np.sort(e[e < slab]), np.arange(slab))
    smax = -(-units // grid) * kblocks
    for block in range(grid):
        per, end = chain_split(block, grid, units, kblocks, total)
        mine = len(range(block, units, grid))
        assert len(per) == mine * kblocks
        assert sum(per) + end == total and end >= 0
        assert all(0 <= n <= -(-total // smax) for n in per)
        if len(per) == smax:
            assert end == 0
    if units > sms:                   # one round a stage, or none
        assert max(chain_split(0, grid, units, kblocks, total)[0]) == 1
