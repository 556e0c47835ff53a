"""TriggeredPyramidGateway.warmup() and scan_precision on the CPU.

Two channels at SF7-8 (the golden SF8 collision on channel 0, an SF7
single on channel 1, noise), fed in chunks and flushed.  A gateway
warmed before its first feed returns exactly the packets of one that was
not (channel, SF, position, symbols), and they decode to the JAX
gateway's (channel, SF, payload) set at positions one hop apart at most
(as tests/test_torch_collision_gateway.py holds the port to it).  The
warm-up leaves ``wall``, ``stats()`` and the launch counts as they were;
it runs in ``tracker="device"`` mode and with ``sic=True`` too.
``scan_precision`` is accepted, checked, and changes no packet.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxGateway
from gr_lora_tpu_torch.config import PYRAMID_OVERLAP_FACTOR
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops import device_tracker as walk_ops
from gr_lora_tpu_torch.ops import peak_epilogue
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_collision_gateway import BASE as JAX_BASE
from test_collision_gateway import PDU1, PDU2, _golden_collision
from test_torch_core import port_config

BASE = port_config(JAX_BASE)
KW = dict(sfs=(7, 8), max_payload_len=16, scan_chunk_samples=1 << 16,
          event_batch=2)


def _fixture():
    cfg7 = BASE.replace(sf=7)
    single = 0.15 * modulate(encode(bytes([0xDE, 0xAD]), cfg7), cfg7,
                             pad_front=0, pad_back=0)
    coll = _golden_collision(JAX_BASE)
    total = 120_000
    iq = np.zeros((2, total), np.complex64)
    iq[0, 4000:4000 + len(coll)] += coll
    iq[1, 9000:9000 + len(single)] += single
    rng = np.random.default_rng(4)
    iq += 0.003 * (rng.standard_normal((2, total))
                   + 1j * rng.standard_normal((2, total))).astype(np.complex64)
    return to_ri(iq)


def _run(gw, ri, step=41_000):
    pkts = []
    for lo in range(0, ri.shape[1], step):
        pkts += gw.feed(ri[:, lo:lo + step])
    return pkts + gw.flush()


def _exact(pkts):
    return [(p.channel, p.sf, p.position, np.asarray(p.symbols).tobytes())
            for p in pkts]


def _decoded(pkts):
    got = {}
    for p in pkts:
        if p.result is not None and p.result.ok and p.result.crc_ok:
            got.setdefault((p.channel, p.sf, bytes(p.result.payload).hex()),
                           []).append(p.position)
    return got


def _counts():
    return (peak_epilogue.topm_launches, walk_ops.launches,
            walk_ops.global_launches)


def _warmed(**kw):
    gw = TriggeredPyramidGateway(BASE, 2, device="cpu", **KW, **kw)
    stats, counts, ring = gw.stats(), _counts(), gw._ring.length
    gw.warmup()
    assert gw.stats() == stats and _counts() == counts
    assert all(v == 0.0 for v in gw.wall.values())
    assert gw._ring.length == ring
    for sf in KW["sfs"]:
        assert all(getattr(m, "launches", 0) == 0
                   for m in gw.lattice(sf).modules())
    return gw


def test_warmup_changes_no_packet_and_matches_jax():
    ri = _fixture()
    warm = _run(_warmed(backend="fused"), ri)
    cold = _run(TriggeredPyramidGateway(BASE, 2, backend="fused",
                                        device="cpu", **KW), ri)
    assert _exact(warm) == _exact(cold)
    ours = _decoded(warm)
    ref = _decoded(_run(JaxGateway(JAX_BASE, 2, backend="xla", **KW), ri))
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    assert (0, 8, PDU1) in ours and (0, 8, PDU2) in ours
    assert any(ch == 1 and sf == 7 for ch, sf, _ in ours)
    for key, pos in ours.items():
        hop = BASE.replace(sf=key[1]).num_samples // PYRAMID_OVERLAP_FACTOR
        assert len(pos) == len(ref[key])
        assert all(abs(a - b) <= hop for a, b in zip(pos, ref[key]))


@pytest.mark.parametrize("kw", [dict(tracker="device"), dict(sic=True)],
                         ids=["device", "sic"])
def test_warmup_device_tracker_and_sic(kw):
    ri = _fixture()
    warm = _warmed(**kw)
    got = _run(warm, ri)
    cold = _run(TriggeredPyramidGateway(BASE, 2, device="cpu", **KW, **kw),
                ri)
    assert _exact(got) == _exact(cold)
    assert (0, 8, PDU1) in _decoded(got)
    if kw.get("sic"):
        assert warm.sic_windows > 0


def test_scan_precision_accepted_and_checked():
    ri = _fixture()
    ref = _exact(_run(TriggeredPyramidGateway(BASE, 2, device="cpu", **KW),
                      ri))
    gw = TriggeredPyramidGateway(BASE, 2, scan_precision="bf16",
                                 device="cpu", **KW)
    assert gw.sf_states[8].scan_cfg.precision == "bf16"
    assert _exact(_run(gw, ri)) == ref
    with pytest.raises(ValueError, match="precision"):
        TriggeredPyramidGateway(BASE, 2, scan_precision="tf32",
                                device="cpu", **KW)
