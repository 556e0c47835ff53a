"""Transmitter to capture file — the tx_usrp.grc TX chain with a file sink.

    python -m gr_lora_tpu_torch.apps.tx_file out.cf64 --payload 0102030405 \
        --samp-rate 1e6 --sf 8

Encodes each --payload, modulates at 1 sample/chip, polyphase-upsamples to
the capture rate on ``device`` (the card unless a caller passes another),
sums at the requested offsets/amplitudes.  With multiple overlapping
payloads this fabricates collision captures for rx_file_collision.
"""

from __future__ import annotations

import argparse

import numpy as np

from .common import add_config_args, config_from_args, write_capture


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out", help="output raw complex64 IQ file")
    ap.add_argument("--payload", action="append", required=True,
                    help="hex payload (repeatable)")
    ap.add_argument("--offset", action="append", type=float, default=None,
                    help="start offset in symbols for each payload")
    ap.add_argument("--amplitude", action="append", type=float, default=None)
    ap.add_argument("--samp-rate", type=float, default=1e6)
    add_config_args(ap)
    args = ap.parse_args(argv)
    cfg = config_from_args(args)

    from ..core.codec import encode
    from ..models.modulator import modulate
    from ..pipeline.frontend import upsample_to_capture_rate

    payloads = [bytes.fromhex(h) for h in args.payload]
    offsets = args.offset or [i * 40.0 for i in range(len(payloads))]
    amps = args.amplitude or [0.3] * len(payloads)
    n1 = 1 << cfg.sf

    pkts = [modulate(encode(pl, cfg), cfg, p=1, pad_front=0, pad_back=0)
            for pl in payloads]
    total = max(int(o * n1) + len(p) for o, p in zip(offsets, pkts)) + 8 * n1
    mix = np.zeros(total, np.complex64)
    for off, amp, pkt in zip(offsets, amps, pkts):
        i = int(off * n1)
        mix[i:i + len(pkt)] += np.complex64(amp) * pkt

    cap = upsample_to_capture_rate(mix, 1, args.samp_rate, cfg, bw=args.bw,
                                   device=device)
    write_capture(args.out, cap)
    print(f"wrote {len(cap)} samples ({len(payloads)} packets) to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
