"""The comparisons that decide ``correct``, against the plain reference.

Each returns numbers; ``lorabench/limits/<cell>.json`` holds each one's
limit.  Nothing here imports the program: the program's outputs arrive as
plain tuples and tensors.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Pdu:
    """One PDU the program emitted with a good CRC."""

    position: int           # sample index in the concatenated feeds
    channel: int
    sf: int
    payload: bytes


def pdu_numbers(sent: list, got: list[Pdu], need_collisions: bool,
                p: int) -> dict:
    """``sent``: (stream start, air.Packet) of every packet handed to the
    program.  A PDU matches a sent packet of its channel, SF and payload
    when its position lies between 4 symbols before the packet's start
    and 16 after it (a receiver reports a place in the preamble).
    ``pdu_missing_pct``: the share, in percent, of the owed packets (sent
    ones; the colliding ones only when ``need_collisions``) that no PDU
    matches; ``pdu_extra``: PDUs that match no sent packet, or one that
    another PDU matched already."""
    index: dict = {}
    for start, pk in sent:
        index.setdefault((pk.channel, pk.sf, pk.payload), []).append(
            [start, pk, False])
    extra = 0
    for d in got:
        n = p << d.sf
        hit = None
        for entry in index.get((d.channel, d.sf, d.payload), []):
            if entry[0] - 4 * n <= d.position <= entry[0] + 16 * n \
                    and not entry[2]:
                hit = entry
                break
        if hit is None:
            extra += 1
        else:
            hit[2] = True
    lost = [(start, pk) for entries in index.values()
            for start, pk, ok in entries
            if not ok and (need_collisions or not pk.collides)]
    for start, pk in lost[:8]:
        print(f"pdu missing: channel {pk.channel} SF{pk.sf} at {start} "
              f"payload {pk.payload.hex()}", file=sys.stderr)
    owed = sum(1 for entries in index.values() for _, pk, _ in entries
               if need_collisions or not pk.collides)
    return {"pdu_missing_pct": 100.0 * len(lost) / max(owed, 1),
            "pdu_extra": extra}


def snr_gap(ratios: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest relative gap of the program's detection ratios to the
    reference's."""
    if ratios.numel() == 0:
        return 0.0
    return float(((ratios.double() - ref).abs() / ref).max())
