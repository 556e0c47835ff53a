"""Shared CLI plumbing: config flags, capture file IO, PDU printing/UDP.

Port of gr_lora_tpu/apps/common.py (host code, unchanged).  Replaces the GRC variable blocks + stock GR utility blocks the reference
examples wire around the LoRa blocks: file_source/file_sink (complex64 raw),
blocks_message_debug (PDU hex printer), blocks_socket_pdu (UDP PDU ports
52001/52002 — reference examples/txrx_sim.grc, Dockerfile:29).
"""

from __future__ import annotations

import argparse
import socket

import numpy as np

from ..config import LoraConfig

DEFAULT_UDP_IN = 52001    # reference txrx_sim.grc socket_pdu "UDP_SERVER"
DEFAULT_UDP_OUT = 52002


def add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--sf", type=int, default=8, help="spreading factor 6-12")
    ap.add_argument("--bw", type=float, default=125e3, help="LoRa bandwidth")
    ap.add_argument("--cr", type=int, default=1, help="code rate 4/(4+cr)")
    ap.add_argument("--no-crc", action="store_true")
    ap.add_argument("--implicit-header", action="store_true")
    ap.add_argument("--payload-len", type=int, default=8,
                    help="payload bytes (implicit-header mode)")
    ap.add_argument("--sync-word", type=lambda s: int(s, 0), default=0x12)
    ap.add_argument("--p", type=int, default=2, help="fs/bw at the demod")
    ap.add_argument("--fft-factor", type=int, default=8)
    ap.add_argument("--beta", type=float, default=25.0)
    ap.add_argument("--threshold", type=float, default=5.0,
                    help="pyramid peak threshold")
    ap.add_argument("--ldr", choices=["auto", "on", "off"], default="auto",
                    help="low-data-rate opt (auto: 2^sf/bw > 16 ms)")


def config_from_args(args) -> LoraConfig:
    ldr = {"on": True, "off": False,
           "auto": (1 << args.sf) / args.bw > 16e-3}[args.ldr]
    return LoraConfig(
        sf=args.sf, cr=args.cr, crc=not args.no_crc, ldr=ldr,
        explicit_header=not args.implicit_header,
        payload_len=args.payload_len, sync_word=args.sync_word,
        p=args.p, fft_factor=args.fft_factor, beta=args.beta,
        threshold=args.threshold)


def read_capture(path: str) -> np.ndarray:
    """GR file_source equivalent: raw interleaved complex64."""
    return np.fromfile(path, dtype=np.complex64)


def write_capture(path: str, iq: np.ndarray) -> None:
    np.asarray(iq, dtype=np.complex64).tofile(path)


def format_pdu(payload: bytes) -> str:
    """blocks_message_debug-style hex line."""
    return " ".join(f"{b:02x}" for b in payload)


def print_pdu(payload: bytes, prefix: str = "pdu") -> None:
    print(f"{prefix} len={len(payload)}: {format_pdu(payload)}")


class UdpPduPort:
    """Datagram-per-PDU UDP endpoint (blocks_socket_pdu equivalent)."""

    def __init__(self, listen_port: int | None = None,
                 send_addr: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if listen_port is not None:
            self.sock.bind(("127.0.0.1", listen_port))
        self.send_addr = send_addr

    def recv(self, timeout: float | None = None) -> bytes | None:
        self.sock.settimeout(timeout)
        try:
            data, _ = self.sock.recvfrom(65536)
            return data
        except socket.timeout:
            return None

    def send(self, payload: bytes) -> None:
        assert self.send_addr is not None
        self.sock.sendto(payload, self.send_addr)

    def close(self) -> None:
        self.sock.close()
