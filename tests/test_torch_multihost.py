"""The port's gateways across two ranks (dist/multihost.py over gloo on the
CPU), against the JAX package's single-process results on its 8 virtual
devices.

Two OS processes (tests/torch_multihost_worker.py) join one process group
at a free localhost port, hold four grid slots each on ``"cpu"`` and run
the five scenarios of tests/test_multihost.py in order: the FSM gateway
with a packet across the rank seam, the always-on gateway with one
channel row a rank, the same with one row across both ranks (its lattice
gathered along t), the gated gateway with channels split by rank, and the
device tracker.  The JAX side runs each fixture once in this process on
the same grid shape; each rank's packets (channel, position, symbols,
PDU) must equal the JAX result split by ownership.  The workers run under
``communicate(timeout=...)``, so a hang fails the test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_multihost_worker as W
from gr_lora_tpu.core.codec import decode as jax_decode
from gr_lora_tpu.dist import gateway as JG
from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxTriggered
from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway as JaxGateway
from gr_lora_tpu.ops.cplx import to_ri
from test_torch_core import config_pair

PDUS = ("0630f0010203040506050801", "0530000707070707e76b01")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks():
    """{scenario: [rank 0's result, rank 1's]} from one pair of workers."""
    port = _free_port()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, W.__file__, str(i), "2", str(port), "gloo", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(2)]
    out = {}
    try:
        for p in procs:
            stdout, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            for line in stdout.splitlines():
                if line.startswith("{"):
                    r = json.loads(line)
                    out.setdefault(r["scenario"], [None, None])[r["pid"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert set(out) == set(W.SCENARIOS), sorted(out)
    return out


def _jax_cfg(port_cfg):
    import dataclasses
    return config_pair(**{k: v for k, v in dataclasses.asdict(
        port_cfg).items() if k != "peak_search"})[0]


def _jax_mesh(nch, nt):
    return Mesh(np.asarray(jax.devices()[:nch * nt]).reshape(nch, nt),
                ("ch", "t"))


def _split(pkts, channels):
    return [p for p in pkts if p[0] in channels]


def test_fsm_seam_packet(ranks):
    """tests/test_multihost.py's seam case: disjoint halves of the stream,
    the same gathered packets on both ranks, equal to the JAX {1, 8}
    mesh's; channel 1's packet across the seam decoded once."""
    cfg, iq, block_len, offs, payload = W.fsm_fixture()
    jcfg = _jax_cfg(cfg)
    plan = JG.make_gateway(jcfg, _jax_mesh(1, 8), 2, block_len,
                           max_packets=2, gather_results=True)
    out, stats = JG.gateway_receive(plan, iq, jcfg, return_stats=True)
    ref = []
    for c, chan in enumerate(out):
        for pos, syms in chan:
            r = jax_decode(syms, jcfg)
            ref.append([c, pos, syms.tolist(),
                        bytes(r.payload).hex() if r.ok else None])
    a, b = ranks["fsm"]
    assert a["range"][1] == b["range"][0] == iq.shape[1] // 2
    assert a["packets"] == b["packets"] == ref
    assert a["dropped"] == b["dropped"] == stats["dropped"] == 0
    assert sorted(p[0] for p in ref) == [0, 1]
    for c, pos, _, pdu in ref:
        assert pdu.startswith(payload.hex())
        assert 0 <= pos - offs[c] <= 8 * cfg.num_samples


def _pyramid(channels, mesh, iq, **kw):
    gw = JaxGateway(_jax_cfg(W._pyramid_cfg()), channels, block_hops=512,
                    mesh=mesh, **kw)
    ri = to_ri(iq)
    return W._decoded(gw.feed(ri) + gw.flush())


def test_pyramid_row_owned(ranks):
    """{ch: 2, t: 4}, one row a rank: each rank reports exactly its
    channel's packets, the JAX mesh's, both golden PDUs once."""
    iq = W.collision_rows(W._pyramid_cfg(), 2, 76)
    ref = _pyramid(2, _jax_mesh(2, 4), iq)
    for r in ranks["pyramid_rows"]:
        assert r["packets"] == _split(ref, {r["pid"]})
        assert sorted(p[3] for p in r["packets"]) == sorted(PDUS)
        assert r["local_channels"] == 1


def test_pyramid_time_only_gathered(ranks):
    """One row across both ranks ({1, 8}): rank 0, the row's owner,
    reports the JAX mesh's packets; rank 1 none."""
    iq = W.collision_rows(W._pyramid_cfg(), 1, 74)
    ref = _pyramid(1, _jax_mesh(1, 8), iq)
    owner, other = ranks["pyramid_time"]
    assert owner["packets"] == ref and other["packets"] == []
    assert owner["local_channels"] == 1 and other["local_channels"] == 0
    assert sorted(p[3] for p in ref) == sorted(PDUS)


def test_gated_split_by_channel(ranks):
    """{ch: 8}: each rank emits exactly its own channels, the ranks'
    channels cover all eight once, and the union is the JAX ch mesh's
    packets."""
    channels = 8
    iq = W.collision_rows(W._pyramid_cfg(), channels, 90)
    gw = JaxTriggered(_jax_cfg(W._pyramid_cfg()), channels, sfs=(8,),
                      max_payload_len=16,
                      mesh=Mesh(np.asarray(jax.devices()[:channels]),
                                ("ch",)))
    ri = to_ri(iq)
    ref = W._decoded(gw.feed(ri) + gw.flush())
    a, b = ranks["gated"]
    assert set(a["own"]).isdisjoint(b["own"])
    assert set(a["own"]) | set(b["own"]) == set(range(channels))
    for r in (a, b):
        assert r["packets"] == _split(ref, set(r["own"]))
    assert sorted(p[3] for p in ref) == sorted(PDUS * channels)


def test_device_tracker_rows(ranks):
    """tracker="device" on {ch: 2, t: 4}: each rank its channel's JAX
    packets, no deviation, and a packet-sized copy to the host (under 64
    KB; the host tracker's is the lattice's)."""
    iq = W.collision_rows(W._pyramid_cfg(), 2, 76)
    ref = _pyramid(2, _jax_mesh(2, 4), iq, tracker="device")
    for r, host in zip(ranks["device_tracker"], ranks["pyramid_rows"]):
        assert r["packets"] == _split(ref, {r["pid"]}) == host["packets"]
        assert r["stats"]["deviations"] == 0
        assert r["fetched_bytes"] < 64 * 1024 < host["fetched_bytes"]
