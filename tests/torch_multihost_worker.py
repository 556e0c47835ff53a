"""One rank of a two-rank run of the port's gateways over a shard grid.

    python tests/torch_multihost_worker.py RANK WORLD PORT BACKEND DEVICE [SCENARIO ...]

Each rank joins the process group at ``localhost:PORT``
(``dist/multihost.initialize``, ``BACKEND`` gloo or nccl), holds four grid
slots on ``DEVICE`` (eight in all, as the JAX package's two-process tests
hold four virtual devices each), synthesises the same capture from fixed
payloads, runs the scenarios in order and prints one JSON line each:

- ``fsm``: the FSM gateway on {ch: 1, t: 8} (tests/multihost_worker.py's
  fixture: two channels, channel 1's packet across the rank seam), each
  rank feeding only its own time range, results gathered;
- ``pyramid_rows``: the always-on gateway on {ch: 2, t: 4}, each rank
  owning one channel row and feeding only it
  (tests/multihost_pyramid_worker.py);
- ``pyramid_time``: one channel row across both ranks ({ch: 1, t: 8}),
  every rank feeding the whole chunk, the row's lattice gathered along t
  and tracked on rank 0 (tests/multihost_pyramid_time_worker.py);
- ``gated``: the gated gateway on {ch: 8}, channels split by rank
  (tests/multihost_triggered_worker.py);
- ``device_tracker``: ``pyramid_rows`` with ``tracker="device"``
  (tests/multihost_device_tracker_worker.py), its bytes copied to the
  host.

``CHANNELS=N`` among the scenarios sets the FSM case's channel count (its
packets then on every channel), ``PYR_CHANNELS=N`` the other cases'
(default: one a row; eight for ``gated``).  ``gloo_cuda``, run only
when named, reports which gloo collectives take CUDA tensors, and
``gloo_cuda_p2p`` whether its point-to-point ops do (run it alone: see
``probe_gloo_cuda``).  Imports nothing of JAX.
"""

import json
import sys
import time

import numpy as np

PDU_PAYLOADS = (bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5))


def _pyramid_cfg():
    from gr_lora_tpu_torch import LoraConfig
    return LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0)


def _collision(cfg):
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.models.modulator import modulate
    p1 = 0.2 * modulate(encode(PDU_PAYLOADS[0], cfg), cfg, pad_front=0,
                        pad_back=0)
    p2 = 0.09 * modulate(encode(PDU_PAYLOADS[1], cfg), cfg, pad_front=0,
                         pad_back=0)
    return p1, p2


def collision_rows(cfg, channels: int, extra_symbols: int):
    """The golden collision on every channel at base 1000 + 2 n c, then
    ``extra_symbols`` more: complex iq [channels, total]."""
    n = cfg.num_samples
    p1, p2 = _collision(cfg)
    total = 1000 + channels * 2 * n + extra_symbols * n
    iq = np.zeros((channels, total), np.complex64)
    for c in range(channels):
        base = 1000 + c * 2 * n
        off2 = base + 16 * n + 4 * n // 8 + 204
        iq[c, base:base + len(p1)] += p1
        iq[c, off2:off2 + len(p2)] += p2
    return iq


def fsm_fixture(channels: int = 2):
    """tests/multihost_worker.py's capture at 8 time shards: one packet a
    channel, channel 1's (every odd channel's) across the middle seam.
    Returns (cfg, iq [C, total, 2], block_len, offs, payload)."""
    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.core.codec import encode
    from gr_lora_tpu_torch.dist.gateway import right_halo_len
    from gr_lora_tpu_torch.models.modulator import modulate
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg = LoraConfig(sf=6, cr=1, crc=False, ldr=False, explicit_header=False,
                     payload_len=2, p=2, fft_factor=1)
    block_len = max(right_halo_len(cfg), 4 * cfg.num_samples)
    total = 8 * block_len
    payload = bytes([7, 9])
    pkt = to_ri(modulate(encode(payload, cfg), cfg, pad_front=0,
                         pad_back=0))
    iq = np.zeros((channels, total, 2), np.float32)
    seam = total // 2
    offs = [cfg.num_samples if c % 2 == 0 else seam - len(pkt) // 2
            for c in range(channels)]
    for c, off in enumerate(offs):
        iq[c, off:off + len(pkt)] = pkt
    return cfg, iq, block_len, offs, payload


def _slots4(nch, nt, device):
    """A {ch, t} grid of four slots a rank on ``device``, in rank order."""
    import torch.distributed as dist

    from gr_lora_tpu_torch.dist.gateway import make_mesh

    return make_mesh(nch, nt, devices=[
        (r, device) for r in range(dist.get_world_size()) for _ in range(4)])


def _decoded(pkts):
    return sorted([p.channel, int(p.position), p.symbols.tolist(),
                   bytes(p.result.payload).hex()
                   if p.result is not None and p.result.ok else None]
                  for p in pkts)


def run_fsm(device, channels: int = 2) -> dict:
    from gr_lora_tpu_torch.core.codec import decode
    from gr_lora_tpu_torch.dist import multihost
    from gr_lora_tpu_torch.dist.gateway import make_gateway

    cfg, iq, block_len, _, _ = fsm_fixture(channels)
    total = iq.shape[1]
    mesh = _slots4(1, None, device)
    plan = make_gateway(cfg, mesh, channels, block_len, max_packets=2,
                        gather_results=True)
    lo, hi = multihost.time_range_of_process(plan, total)
    local = multihost.process_local_input(plan, iq[:, lo:hi], total)
    out, stats = multihost.multihost_gateway_receive(plan, local, cfg)
    got = []
    for c, chan in enumerate(out):
        for pos, syms in chan:
            r = decode(syms, cfg)
            got.append([c, pos, syms.tolist(),
                        bytes(r.payload).hex() if r.ok else None])
    return {"range": [lo, hi], "packets": got, "dropped": stats["dropped"]}


def run_pyramid_rows(device, channels: int | None = None,
                     tracker: str = "host") -> dict:
    """{ch: world, t: 4}: a rank feeds its row's channels only."""
    import torch.distributed as dist

    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg = _pyramid_cfg()
    world, rank = dist.get_world_size(), dist.get_rank()
    channels = channels or world
    iq = collision_rows(cfg, channels, 76)
    mesh = _slots4(world, None, device)
    gw = PyramidGateway(cfg, channels, block_hops=512, mesh=mesh,
                        tracker=tracker)
    cpr = channels // world
    assert gw.local_channels == gw.ingest_channels == cpr
    got = gw.feed(to_ri(iq[rank * cpr:(rank + 1) * cpr])) + gw.flush()
    return {"packets": _decoded(got), "stats": gw.stats(),
            "fetched_bytes": gw.fetched_bytes,
            "local_channels": gw.local_channels}


def run_pyramid_time(device, channels: int = 1) -> dict:
    """One channel row over every rank's slots ({ch: 1, t: 4 world})."""
    from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg = _pyramid_cfg()
    iq = collision_rows(cfg, channels, 74)
    mesh = _slots4(1, None, device)
    gw = PyramidGateway(cfg, channels, block_hops=512, mesh=mesh)
    assert gw.ingest_channels == channels
    got = gw.feed(to_ri(iq)) + gw.flush()
    return {"packets": _decoded(got), "local_channels": gw.local_channels}


def run_gated(device, channels: int = 8) -> dict:
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.ops.cplx import to_ri

    cfg = _pyramid_cfg()
    iq = collision_rows(cfg, channels, 90)
    mesh = _slots4(8, 1, device)
    gw = TriggeredPyramidGateway(cfg, channels, sfs=(8,),
                                 max_payload_len=16, mesh=mesh)
    got = gw.feed(to_ri(iq)) + gw.flush()
    return {"packets": _decoded(got), "own": gw._own_channels}


def probe_gloo_cuda(device, p2p: bool = False) -> dict:
    """Which gloo collectives take CUDA tensors in this torch: each is
    called on tensors on ``device`` by every rank alike, so a refusal
    raises on every rank, and a result that arrives is checked against
    the ranks' values.  With ``p2p`` (scenario ``gloo_cuda_p2p``) an
    isend / irecv pair of CUDA tensors instead, in a group of its own and
    waited on for at most 20 s: in torch 2.11 on the H100 gloo's send
    fails ("writev ... Bad address") and its background thread then
    aborts the process, so run it alone."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.full((4,), float(rank + 1), device=device)
    want = torch.arange(1, world + 1, device=device).repeat_interleave(4)

    def gather_into():
        got = torch.empty(4 * world, device=device)
        dist.all_gather_into_tensor(got, x)
        return torch.equal(got, want.float())

    def gather_list():
        got = [torch.empty(4, device=device) for _ in range(world)]
        dist.all_gather(got, x)
        return torch.equal(torch.cat(got), want.float())

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == world * (world + 1) / 2).all())

    def bcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return bool((y == 1).all())

    def send_recv():
        # Its own group: a refused send breaks the group's connections.
        group = dist.new_group(backend="gloo")
        peer = (rank + 1) % world
        buf = torch.empty(4, device=device)
        ops = [dist.P2POp(dist.isend, x, peer, group),
               dist.P2POp(dist.irecv, buf, (rank - 1) % world, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait(timedelta(seconds=20))
        return bool((buf == (rank - 1) % world + 1).all())

    calls = (("isend/irecv", send_recv),) if p2p else (
        ("all_gather_into_tensor", gather_into), ("all_gather", gather_list),
        ("all_reduce", reduce), ("broadcast", bcast))
    out = {}
    for name, call in calls:
        try:
            out[name] = ("accepts CUDA tensors, result " +
                         ("correct" if call() else "WRONG"))
        except (RuntimeError, ValueError) as e:
            out[name] = f"refuses: {str(e).splitlines()[0][:120]}"
    return {"gloo_cuda": out}


SCENARIOS = {
    "fsm": run_fsm,
    "pyramid_rows": run_pyramid_rows,
    "pyramid_time": run_pyramid_time,
    "gated": run_gated,
    "device_tracker": lambda dev, ch=None: run_pyramid_rows(
        dev, ch, tracker="device"),
}


def main(argv) -> None:
    rank, world, port, backend, device = argv[:5]
    names = [a for a in argv[5:] if "=" not in a] or list(SCENARIOS)
    opts = {k: int(v) for k, v in (a.split("=") for a in argv[5:]
                                   if "=" in a)}
    import torch

    from gr_lora_tpu_torch.dist import multihost

    torch.set_num_threads(2)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    multihost.initialize(f"localhost:{port}", int(world), int(rank),
                         backend=backend)
    try:
        for name in names:
            t0 = time.perf_counter()
            if name.startswith("gloo_cuda"):
                res = probe_gloo_cuda(device, p2p=name == "gloo_cuda_p2p")
            elif name == "fsm":
                res = run_fsm(device, opts.get("CHANNELS", 2))
            elif "PYR_CHANNELS" in opts:
                res = SCENARIOS[name](device, opts["PYR_CHANNELS"])
            else:
                res = SCENARIOS[name](device)
            res.update(scenario=name, pid=int(rank), backend=backend,
                       wall_s=time.perf_counter() - t0)
            print(json.dumps(res), flush=True)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
