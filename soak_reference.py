"""Decode given packets of a soak's traffic with the JAX package and with
the port, both on the CPU.

    JAX_PLATFORMS=cpu python3 soak_reference.py [options] CH:PAYLOAD ...

Regenerates the air that dist/soak.run_gateway_soak streams (the port's
driver, equal to the JAX package's from the same seed,
tests/test_torch_soak.py) on ``--channels`` channels at SF7-8 in
``--chunks`` chunks of 96 SF8 symbols, with the given seed, duty,
collision cadence and noise, through a gateway that decodes nothing.
For each CH:PAYLOAD (a channel and a payload in hex, as chip_smoke.py's
soak line prints the packets neither tracker decoded) it cuts that
channel's air from 10 chunks before the packet's first sample to 10
chunks after, and feeds it to the gated gateway (SF7-8, max_payload_len
8, split_repeats, 2^15-sample scan chunks) of each package with either
tracker: the JAX package's native and lax.scan trackers, the port's
native tracker and its device tracker's plain walk.  Prints, for every
packet, whether each decoded it, then one JSON line {"packets": N,
"decoded": {gateway: count}}.  Needs the JAX package; runs on the CPU.

    python3 soak_reference.py --stream cuda [options]

instead streams the whole soak through the port's gated gateway (the
settings above, ``--channels`` channels) on the card, once with the host
tracker and once with ``tracker="device"``, and prints, for each, the
injected packets it did not decode (as CH:PAYLOAD) and any it decoded
more often than injected, then one JSON line {"injected": N, "lost":
{tracker: count}}.  Needs no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

CHUNK = 96 * 512                  # 96 SF8 symbols at p 2


class _Capture:
    """A gateway that decodes nothing and keeps the chunks it needs."""

    class _Ring:
        cap = length = 0

    def __init__(self, sf_states, want: dict):
        self.sf_states = sf_states
        self._split_repeats = True
        self._ring = self._Ring()
        self.want = want             # chunk index -> channels to keep
        self.kept = {}
        self.ci = 0

    def feed(self, iq):
        for ch in self.want.get(self.ci, ()):
            self.kept[(ch, self.ci)] = np.array(iq[ch])
        self.ci += 1
        return []

    def flush(self):
        return []

    def stats(self):
        return {}


def _stream(device, channels, chunks, base, kw, traffic) -> int:
    """The whole soak through the port's gateway with either tracker."""
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.soak import run_gateway_soak

    lost = {}
    for tracker in ("host", "device"):
        gw = TriggeredPyramidGateway(base, channels, tracker=tracker,
                                     device=device, **kw)
        expected, got, _ = run_gateway_soak(gw, channels, (7, 8), chunks,
                                            CHUNK, **traffic)
        miss = sorted(f"{c}:{p.hex()}" for (c, p), k in expected.items()
                      if got.get((c, p), 0) < k)
        extra = sorted(f"{c}:{p.hex()}" for (c, p), k in got.items()
                       if k > expected.get((c, p), 0))
        lost[tracker] = len(miss)
        print(f"tracker={tracker}: injected {sum(expected.values())}, "
              f"lost {len(miss)} {' '.join(miss)}; extra {extra}")
    print(json.dumps({"injected": sum(expected.values()), "lost": lost}))
    return 0


def main(argv=None) -> int:
    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.dist.soak import run_gateway_soak

    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--chunks", type=int, default=640)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--duty", type=float, default=0.18)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--stream", metavar="DEVICE")
    ap.add_argument("packets", nargs="*")
    args = ap.parse_args(argv)
    fields = dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                  payload_len=8, p=2, fft_factor=8, threshold=5.0)
    kw = dict(sfs=(7, 8), max_payload_len=8, scan_chunk_samples=1 << 15,
              split_repeats=True)
    base = LoraConfig(**fields)
    traffic = dict(seed=args.seed, duty_target=args.duty,
                   collision_every=args.every, noise_sigma=args.noise)
    if args.stream:
        return _stream(args.stream, args.channels, args.chunks, base, kw,
                       traffic)
    from gr_lora_tpu import LoraConfig as JaxConfig
    from gr_lora_tpu.dist.collision_gateway import \
        TriggeredPyramidGateway as JaxGateway

    jax_base = JaxConfig(**fields)
    targets = [(int(c), bytes.fromhex(p))
               for c, p in (t.split(":") for t in args.packets)]

    # First pass: the injection log alone; second: the chunks around the
    # targets' first samples.
    proto = TriggeredPyramidGateway(base, args.channels, device="cpu", **kw)
    log = []
    run_gateway_soak(_Capture(proto.sf_states, {}), args.channels, (7, 8),
                     args.chunks, CHUNK, inject_log=log, **traffic)
    starts = {}
    for _, ch, _, start, pay in log:
        if (ch, pay) in targets:
            starts.setdefault((ch, pay), start)
    if len(starts) != len(targets):
        raise SystemExit(f"not injected: {set(targets) - set(starts)}")
    want = {}
    for (ch, _), start in starts.items():
        for ci in range(max(start // CHUNK - 10, 0), start // CHUNK + 11):
            want.setdefault(ci, set()).add(ch)
    cap = _Capture(proto.sf_states, want)
    run_gateway_soak(cap, args.channels, (7, 8), args.chunks, CHUNK,
                     **traffic)

    gateways = {
        "jax_native": lambda: JaxGateway(jax_base, 1, use_native=True, **kw),
        "jax_device": lambda: JaxGateway(jax_base, 1, tracker="device",
                                         **kw),
        "port_native": lambda: TriggeredPyramidGateway(base, 1,
                                                       device="cpu", **kw),
        "port_device": lambda: TriggeredPyramidGateway(
            base, 1, tracker="device", device="cpu", **kw)}
    decoded = {name: 0 for name in gateways}
    for (ch, pay), start in sorted(starts.items()):
        cis = sorted(ci for c, ci in cap.kept if c == ch
                     and abs(ci - start // CHUNK) <= 10)
        air = np.concatenate([cap.kept[(ch, ci)] for ci in cis])[None]
        row = {}
        for name, make in gateways.items():
            gw = make()
            got = {bytes(p.result.payload[3:3 + p.result.payload[0]])
                   for p in gw.feed(air) + gw.flush()
                   if p.result is not None and p.result.ok
                   and p.result.crc_ok}
            row[name] = pay in got
            decoded[name] += row[name]
        print(f"channel {ch} payload {pay.hex()} at sample {start}: {row}")
    print(json.dumps({"packets": len(starts), "decoded": decoded}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
