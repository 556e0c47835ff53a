"""Decode the collision pairs of chip_smoke.py's wideband capture with the
JAX package and with the port, both on the CPU.

    JAX_PLATFORMS=cpu python3 wideband_reference.py [--backend B] [CHANNEL ...]

Makes chip_smoke.py phase 10's capture on the CPU (payloads from
default_rng(0), noise from default_rng(1): the capture the card makes),
channelizes its first block (every SF8 pair lies in it) with each
package's own channelizer, and feeds the given channels (all 64 unless
given) to each package's gated gateway at SF8 with phase 10's settings
at backend B (``xla`` unless given; the JAX package runs ``fused``'s
Pallas kernel in interpret mode, the port its plain version), eight
channels at a time.  Prints, for every
pair packet, whether each package decoded it, then one JSON line:
{"injected", "jax", "port", "only_jax", "only_port"}, each a count of
pair packets.  The gateway's output is read before the app's dedupe.
Needs the JAX package; runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

GROUP = 8


def _decoded(pkts, chans) -> set:
    return {(chans[p.channel], bytes(p.result.payload).hex()) for p in pkts
            if p.result is not None and p.result.ok and p.result.crc_ok}


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from gr_lora_tpu import LoraConfig as JaxConfig
    from gr_lora_tpu.dist.collision_gateway import \
        TriggeredPyramidGateway as JaxGateway
    from gr_lora_tpu.pipeline.channelizer import channelize as jax_channelize
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.pipeline.channelizer import channelize

    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="xla")
    ap.add_argument("channels", nargs="*", type=int)
    args = ap.parse_args(argv)
    chans = args.channels or list(range(cs.CHANNELS))
    wide, injected = cs.wideband_capture(torch.device("cpu"))
    block = np.ascontiguousarray(wide[:cs.WB_BLOCK]).view(np.float32) \
        .reshape(-1, 2)
    del wide
    pairs = [p for p in injected if p.kind != "single"
             and p.channel in chans]
    base = cs.base_config()
    x_port = channelize(block, cs.CHANNELS, cs.WB_FS, device="cpu").numpy()
    if max(p.offset for p in pairs) + 48 * base.num_samples \
            > x_port.shape[1]:
        raise SystemExit("a pair ends beyond the first block")
    jax_base = JaxConfig(**{f: getattr(base, f) for f in (
        "sf", "cr", "crc", "ldr", "explicit_header", "payload_len", "p",
        "fft_factor", "threshold")})
    x_jax = np.asarray(jax_channelize(block, cs.CHANNELS, cs.WB_FS))
    got = {"jax": set(), "port": set()}
    for lo in range(0, len(chans), GROUP):
        group = chans[lo:lo + GROUP]
        jgw = JaxGateway(jax_base, len(group), sfs=(8,), max_payload_len=16,
                         backend=args.backend)
        got["jax"] |= _decoded(jgw.feed(x_jax[group]) + jgw.flush(), group)
        pgw = TriggeredPyramidGateway(base, len(group), sfs=(8,),
                                      max_payload_len=16,
                                      backend=args.backend, device="cpu")
        got["port"] |= _decoded(pgw.feed(torch.from_numpy(x_port[group]))
                                + pgw.flush(), group)
    keys = {p: (p.channel, p.pdu) for p in pairs}
    for p in pairs:
        print(f"{p}: jax {keys[p] in got['jax']}, port "
              f"{keys[p] in got['port']}")
    want = set(keys.values())
    print(json.dumps({"injected": len(want),
                      "jax": len(want & got["jax"]),
                      "port": len(want & got["port"]),
                      "only_jax": len(want & (got["jax"] - got["port"])),
                      "only_port": len(want & (got["port"] - got["jax"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
