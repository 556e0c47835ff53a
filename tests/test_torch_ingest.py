"""The port's native ring and threaded ring ingest, twins of
tests/test_native.py's ring tests and tests/test_ingest.py: a capture
streamed through producer thread -> native SPSC ring -> pipelined
StreamingDemodulator gives the JAX package's batch (position, symbols)
list exactly, with fast, slow (real-time paced) and live UDP producers."""

import io
import socket
import threading
import time

import numpy as np

from gr_lora_tpu.models.demodulator import \
    StreamingDemodulator as JaxStreamingDemodulator
from gr_lora_tpu_torch import native
from gr_lora_tpu_torch.apps.rx_stream import UdpIqSource
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.demodulator import StreamingDemodulator
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.pipeline.ingest import RingIngest, stream_demodulate
from test_torch_core import config_pair

JCFG, CFG = config_pair(sf=7, cr=1, crc=True, ldr=False,
                        explicit_header=False, payload_len=4, p=2,
                        fft_factor=2)


def test_ring_buffer_basic():
    rb = native.RingBuffer(1 << 12)
    assert rb.capacity == 1 << 12
    data = np.arange(1000, dtype=np.uint8)
    assert rb.write(data) == 1000
    assert rb.readable == 1000
    assert np.array_equal(rb.peek(10), data[:10])
    got = rb.read(1000)
    assert np.array_equal(got, data)
    assert rb.readable == 0
    # read returns a fresh array: later writes do not reach it
    rb.write(np.full(1000, 5, np.uint8))
    assert np.array_equal(got, data)


def test_ring_buffer_wraparound_and_partial():
    rb = native.RingBuffer(256)             # rounds to power of two
    cap = rb.capacity
    a = np.full(cap - 10, 7, np.uint8)
    assert rb.write(a) == cap - 10
    assert rb.write(np.full(100, 9, np.uint8)) == 10   # partial write
    got = rb.read(cap)
    assert len(got) == cap
    assert np.all(got[:cap - 10] == 7) and np.all(got[cap - 10:] == 9)


def test_ring_buffer_threaded_stream():
    """1 MB pushed through a small ring from a producer thread arrives
    intact and in order."""
    rb = native.RingBuffer(1 << 10)
    total = 1 << 20
    src = np.random.default_rng(3).integers(0, 256, total).astype(np.uint8)

    def producer():
        sent = 0
        while sent < total:
            sent += rb.write(src[sent:sent + 4096])

    t = threading.Thread(target=producer)
    t.start()
    out = np.zeros(total, np.uint8)
    got = 0
    while got < total:
        chunk = rb.read(min(4096, total - got))
        out[got:got + len(chunk)] = chunk
        got += len(chunk)
    t.join(timeout=60)
    assert not t.is_alive()
    assert np.array_equal(out, src)


def _capture(num_pkts=5, seed=0):
    rng = np.random.default_rng(seed)
    n = CFG.num_samples
    chunks = []
    for i in range(num_pkts):
        pkt = modulate(encode(bytes([i + 1, 2, 3, 4]), CFG), CFG,
                       pad_front=0, pad_back=0)
        chunks.append(0.3 * pkt)
        gap = int(rng.integers(2, 9)) * n + int(rng.integers(0, n))
        chunks.append(np.zeros(gap, np.complex64))
    iq = np.concatenate(chunks).astype(np.complex64)
    return iq + 0.01 * (rng.standard_normal(len(iq))
                        + 1j * rng.standard_normal(len(iq))).astype(np.complex64)


def _jax_batch(iq):
    """The JAX package's batch-mode packets: the reference list."""
    sd = JaxStreamingDemodulator(JCFG)
    return [(p, s.tobytes()) for p, s in sd.feed(iq) + sd.flush()]


def _bytes(pkts):
    return [(p, np.asarray(s, np.uint16).tobytes()) for p, s in pkts]


def test_ring_ingest_matches_batch():
    iq = _capture()
    got = stream_demodulate(CFG, io.BytesIO(iq.tobytes()), device="cpu")
    assert _bytes(got) == _jax_batch(iq)


class _PacedReader:
    """Emits the capture in small chunks with delays: a real-time source."""

    def __init__(self, data: bytes, chunk: int, delay: float):
        self._data = data
        self._off = 0
        self._chunk = chunk
        self._delay = delay

    def read(self, n: int) -> bytes:
        if self._off >= len(self._data):
            return b""
        time.sleep(self._delay)
        take = min(self._chunk, n, len(self._data) - self._off)
        out = self._data[self._off:self._off + take]
        self._off += take
        return out


def test_ring_ingest_slow_producer():
    iq = _capture(num_pkts=3, seed=1)
    src = _PacedReader(iq.tobytes(), chunk=4096 * 8, delay=2e-3)
    seen = []
    got = stream_demodulate(CFG, src, on_packet=lambda p, s: seen.append(p),
                            device="cpu")
    assert seen == [p for p, _ in got]
    assert _bytes(got) == _jax_batch(iq)


def test_ring_ingest_partial_trailing_sample():
    iq = _capture(num_pkts=1, seed=2)
    raw = iq.tobytes() + b"\x01\x02\x03"      # torn trailing sample
    ing = RingIngest(io.BytesIO(raw), block_samples=4096)
    blocks = list(ing.blocks())
    assert sum(b.shape[0] for b in blocks) % 4096 == 0   # zero-padded tail
    assert ing.trailing_bytes == 3
    assert ing.last_block_samples == len(iq) % 4096
    got = np.concatenate(blocks)[:len(iq)].view(np.complex64)[:, 0]
    assert np.array_equal(got, iq)


def test_pipelined_streaming_demod_equals_unpipelined():
    iq = _capture(num_pkts=4, seed=3)
    a = StreamingDemodulator(CFG, pipelined=False, device="cpu")
    b = StreamingDemodulator(CFG, pipelined=True, device="cpu")
    ra = _bytes(a.feed(iq) + a.flush())
    rb = []
    step = 10000
    for i in range(0, len(iq), step):
        rb += b.feed(iq[i:i + step])
    rb += b.flush()
    assert ra == _bytes(rb) == _jax_batch(iq)


def test_udp_iq_source_live_feed():
    """Live UDP datagrams -> UdpIqSource -> ring ingest == batch decode
    (the rx_usrp.grc live-source analog)."""
    iq = _capture(num_pkts=2, seed=4)
    raw = iq.tobytes()
    src = UdpIqSource(0, idle_timeout=1.0)
    port = src._sock.getsockname()[1]

    def sender():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i in range(0, len(raw), 8192):
            s.sendto(raw[i:i + 8192], ("127.0.0.1", port))
            time.sleep(0.0005)
        s.close()

    t = threading.Thread(target=sender)
    t.start()
    got = stream_demodulate(CFG, src, device="cpu")
    t.join(timeout=60)
    src.close()
    assert not t.is_alive()
    assert _bytes(got) == _jax_batch(iq)
