"""Whitening-sequence consensus tool — tools/whitening_consensus_tool.py
equivalent (twin of gr_lora_tpu/apps/whitening_consensus.py).

    python -m gr_lora_tpu_torch.apps.whitening_consensus dump.txt

Input: one whitening observation per line, hex bytes (each line is the XOR
of a known payload with the received bytes, as produced by decode's
whitening-derivation mode, reference decode_impl.cc:415-426).  Output: the
per-byte majority vote, printed as a Python array literal.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter


def consensus(lines: list[bytes]) -> bytes:
    length = max(len(b) for b in lines)
    out = bytearray()
    for i in range(length):
        votes = Counter(b[i] for b in lines if len(b) > i)
        out.append(votes.most_common(1)[0][0])
    return bytes(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump", help="file of hex lines (one observation each)")
    args = ap.parse_args(argv)
    lines = []
    for raw in open(args.dump):
        raw = raw.strip().replace(" ", "")
        if raw:
            lines.append(bytes.fromhex(raw))
    if not lines:
        print("no observations", file=sys.stderr)
        return 1
    seq = consensus(lines)
    print("WHITENING_SEQUENCE = bytes([")
    for i in range(0, len(seq), 12):
        print("    " + ", ".join(f"0x{b:02x}" for b in seq[i:i + 12]) + ",")
    print("])")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
