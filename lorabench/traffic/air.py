"""The one traffic generator: LoRa packets on noisy air, made from a seed.

A traffic mix is a data file beside this module (``<name>.json``) that this
generator reads; a new mix is a new file, never new code.  The file gives:

- ``samples_per_feed``: samples a channel a feed (at 250 ksps);
- ``pool_feeds``: distinct feeds made in set-up, cycled by the window;
- ``noise_sigma``: the standard deviation of each of I and Q of the
  complex Gaussian noise on every channel;
- ``packets``: what every channel carries in every feed, a list of
  entries with ``id``, ``amplitude``, the payload (``payload_hex``, fixed
  bytes; ``payload_by_sf``, fixed bytes for each SF; or
  ``payload_bytes``, that many bytes drawn from the seed), the SF
  (``sf``, or ``sf_by_channel``: the SF of channel c is the list's
  ``c % len`` entry), and either ``slot`` ([lo, hi) as fractions of the feed: the
  packet starts anywhere in it, and its whole group ends inside the feed)
  or ``after`` (another entry's ``id``) with ``delay_symbols`` and
  ``delay_samples``: it starts that long after that packet, and the two
  collide.

The seed chooses where each group starts inside its slot, the noise, and
the bytes of payloads given only by length; the cell alone fixes how many
packets there are, their SFs, amplitudes and collisions, so every seed
gives the program the same work.  Noise and waveforms are made on the
feed's device (the card in a run) with a ``torch.Generator`` there.

The LoRa encoder and chirp modulator below are a frozen plain copy of the
codec (whitening, CRC16, the explicit header, Hamming FEC, the diagonal
interleaver, the Gray map) and of the closed-form chirp modulator: they
import nothing of the program, so a change there cannot move the air the
program is measured on.  ``lorabench/tests`` holds them equal to the
program's own encoder and modulator.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
NUM_PREAMBLE_CHIRPS = 8
SYNC_WORD = 0x12


def load(name: str) -> dict:
    """The traffic mix ``name`` (``lorabench/traffic/<name>.json``)."""
    return json.loads((HERE / f"{name}.json").read_text())


# -- the frozen encoder ------------------------------------------------------

def _whitening_sequence() -> np.ndarray:
    """255 bytes of the x^8 + x^6 + x^5 + x^4 + 1 LFSR, seed all ones."""
    s = np.ones(255 + 7, np.uint8)
    for i in range(8, len(s)):
        s[i] = s[i - 4] ^ s[i - 5] ^ s[i - 6] ^ s[i - 8]
    win = np.lib.stride_tricks.sliding_window_view(s, 8)[:255]
    return (win * (1 << np.arange(7, -1, -1))).sum(axis=1).astype(np.uint8)


WHITENING = _whitening_sequence()


def crc16(data: np.ndarray) -> int:
    """LoRa's payload CRC: CCITT over all but the last two bytes, which
    are XORed in."""
    crc = 0
    for b in data[:max(len(data) - 2, 0)]:
        crc ^= int(b) << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
    x1 = int(data[-1]) if len(data) >= 1 else 0
    x2 = int(data[-2]) << 8 if len(data) >= 2 else 0
    return crc ^ x1 ^ x2


def header_checksum(length: int, cr_crc: int) -> int:
    a = [(length >> (4 + k)) & 1 for k in range(4)]
    b = [(length >> k) & 1 for k in range(4)]
    c = [(cr_crc >> k) & 1 for k in range(4)]
    return ((a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
            | (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
            | (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
            | (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
            | (a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]))


def num_symbols(length: int, sf: int, cr: int, crc: bool, ldr: bool) -> int:
    """Symbols of an explicit-header packet, header block included."""
    tmp = 2.0 * length - sf + 7 + 4 * int(crc)
    return 8 + max((4 + cr) * math.ceil(tmp / (sf - 2 * int(ldr))), 0)


def _parity(x: int, mask: int) -> int:
    return bin(x & mask).count("1") & 1


def _hamming(nib: int, cr: int) -> int:
    p1, p2, p3 = _parity(nib, 0x0D), _parity(nib, 0x0B), _parity(nib, 0x07)
    p4, p5 = _parity(nib, 0x0F), _parity(nib, 0x0E)
    return {1: p4 << 4 | nib, 2: p5 << 5 | p3 << 4 | nib,
            3: p2 << 6 | p5 << 5 | p3 << 4 | nib,
            4: p1 << 7 | p2 << 6 | p5 << 5 | p3 << 4 | nib}[cr]


def encode(payload: bytes, sf: int, cr: int, ldr: bool,
           crc: bool = True) -> np.ndarray:
    """Payload -> transmitted chirp bins of an explicit-header packet."""
    data = list(payload)
    size = len(data)
    if crc:
        c = crc16(np.array(data, np.uint8))
        data += [c & 0xFF, c >> 8]
    nsym = num_symbols(size, sf, cr, crc, ldr)
    nnib = sf - 2 + (nsym - 8) // (cr + 4) * (sf - 2 * int(ldr))
    data += [0] * max((nnib + 1) // 2 - len(data), 0)
    for i in range(min(size, 255)):
        data[i] ^= int(WHITENING[i])
    nibs = [data[i // 2] & 0xF if i % 2 == 0 else data[i // 2] >> 4
            for i in range(nnib)]
    cr_crc = (cr << 1 | int(crc)) & 0xFF
    cks = header_checksum(size, cr_crc)
    nibs = [size >> 4, size & 0xF, cr_crc, cks >> 4, cks & 0xF] + nibs
    cws = [_hamming(v, 4 if i < sf - 2 else cr) for i, v in enumerate(nibs)]
    syms, start, first = [], 0, True
    while True:
        ppm = sf - 2 if first else sf - 2 * int(ldr)
        bpw = 8 if first else cr + 4
        if start + ppm > len(cws):
            break
        block = cws[start:start + ppm]
        for x in range(bpw):
            syms.append(sum(((block[(j + x) % ppm] >> x) & 1) << j
                            for j in range(ppm)))
        start += ppm
        first = False
    out = []
    for i, g in enumerate(syms):
        for shift in (8, 4, 2, 1):          # inverse Gray map
            g ^= g >> shift
        out.append((g * 4 + 1) % (1 << sf) if i < 8 or ldr
                   else (g + 1) % (1 << sf))
    return np.array(out, np.int64)


# -- the frozen modulator ----------------------------------------------------

def chirp_phase(sf: int, p: int) -> np.ndarray:
    """phi(i) = pi/p (i - i^2/N), N = p 2^sf, in float64: the base upchirp
    is exp(-j phi), the receiver's dechirp table exp(+j phi)."""
    n = p << sf
    i = np.arange(n, dtype=np.float64)
    return np.pi / p * (i - i * i / n)


def packet_indices(symbols: np.ndarray, sf: int, p: int):
    """(table index, downchirp?) of every sample of a packet: 8 preamble
    upchirps, the two sync-word chirps, 2.25 SFD downchirps, the payload
    upchirps each advanced by ``symbol * p`` samples."""
    n = p << sf
    i = np.arange(n)
    parts = [np.tile(i, NUM_PREAMBLE_CHIRPS)]
    parts += [(8 * nib * p + i) % n for nib in (SYNC_WORD >> 4,
                                                SYNC_WORD & 0xF)]
    sfd = np.arange(2 * n + n // 4) % n
    pay = ((np.asarray(symbols)[:, None] * p + i[None, :]) % n).reshape(-1)
    idx = np.concatenate(parts + [sfd, pay])
    down = np.zeros(len(idx), bool)
    lo = (NUM_PREAMBLE_CHIRPS + 2) * n
    down[lo:lo + len(sfd)] = True
    return idx, down


def packet_length(payload_bytes: int, sf: int, p: int, cr: int,
                  ldr: bool) -> int:
    n = p << sf
    return ((NUM_PREAMBLE_CHIRPS + 2) * n + 2 * n + n // 4
            + num_symbols(payload_bytes, sf, cr, True, ldr) * n)


def waveform(symbols: np.ndarray, sf: int, p: int, amplitude: float,
             device) -> torch.Tensor:
    """[L, 2] float32 IQ of one packet on ``device``, complex64 rounding
    of a float64 phase table as the program's modulator rounds it."""
    ph = chirp_phase(sf, p)
    up = np.exp(-1j * ph).astype(np.complex64)
    idx, down = packet_indices(symbols, sf, p)
    wave = np.where(down, np.conj(up)[idx], up[idx]) * np.float32(amplitude)
    ri = np.stack([wave.real, wave.imag], -1).astype(np.float32)
    return torch.from_numpy(ri).to(device)


# -- feeds -------------------------------------------------------------------

@dataclass(frozen=True)
class Packet:
    """One transmitted packet of a feed: what the receiver owes."""

    channel: int
    sf: int
    start: int              # first preamble sample, within the feed
    length: int             # samples on air
    payload: bytes
    amplitude: float
    collides: bool


def _fixed_payload(spec: dict, sf: int) -> bytes | None:
    if "payload_hex" in spec:
        return bytes.fromhex(spec["payload_hex"])
    if "payload_by_sf" in spec:
        return bytes.fromhex(spec["payload_by_sf"][str(sf)])
    return None


def _ldr(sf: int, bw: float) -> bool:
    return (1 << sf) / bw > 16e-3          # the SX127x rule


def plan_feed(traffic: dict, lora: dict, channels: int, sfs: list,
              bw: float, seed: int, index: int) -> list[Packet]:
    """The packets of feed ``index`` of ``seed``: fixed counts, SFs and
    collisions; seeded bytes and offsets.  Host-side and cheap."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, seed >> 48, index])
    t = traffic["samples_per_feed"]
    p, cr = lora["p"], lora["cr"]
    specs = traffic["packets"]
    followers = {s["after"]: s for s in specs if "after" in s}
    out = []
    for c in range(channels):
        for s in specs:
            if "after" in s:
                continue
            group = [s]
            while group[-1]["id"] in followers:
                group.append(followers[group[-1]["id"]])
            rel, ends, members = 0, [], []
            for g in group:
                sf = g["sf"] if "sf" in g else \
                    g["sf_by_channel"][c % len(g["sf_by_channel"])]
                if sf not in sfs:
                    raise ValueError(f"packet {g['id']} at SF{sf} on a "
                                     f"receiver of SFs {sfs}")
                n = p << sf
                if "after" in g:
                    rel += int(g["delay_symbols"] * n) + g["delay_samples"]
                size = len(_fixed_payload(g, sf) or b"") \
                    or g["payload_bytes"]
                length = packet_length(size, sf, p, cr, _ldr(sf, bw))
                members.append((g, sf, rel, length, size))
                ends.append(rel + length)
            lo = int(s["slot"][0] * t)
            hi = min(int(s["slot"][1] * t), t - 1) - max(ends)
            if hi < lo:
                raise ValueError(f"packet group {s['id']} does not fit its "
                                 f"slot in a {t}-sample feed")
            start = int(rng.integers(lo, hi + 1))
            for g, sf, rel, length, size in members:
                payload = _fixed_payload(g, sf) or bytes(
                    rng.integers(0, 256, size, dtype=np.uint8))
                out.append(Packet(c, sf, start + rel, length, payload,
                                  float(g["amplitude"]), len(group) > 1))
    return out


def make_feed(traffic: dict, lora: dict, packets: list[Packet],
              channels: int, bw: float, seed: int, index: int,
              device) -> torch.Tensor:
    """[channels, T, 2] float32 IQ on ``device``: seeded noise plus every
    packet of ``packets``."""
    t = traffic["samples_per_feed"]
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + index) % (1 << 63))
    iq = torch.randn((channels, t, 2), generator=gen, device=device,
                     dtype=torch.float32)
    iq.mul_(traffic["noise_sigma"])
    for pk in packets:
        syms = encode(pk.payload, pk.sf, lora["cr"], _ldr(pk.sf, bw))
        w = waveform(syms, pk.sf, lora["p"], pk.amplitude, device)
        iq[pk.channel, pk.start:pk.start + len(w)] += w
    return iq
