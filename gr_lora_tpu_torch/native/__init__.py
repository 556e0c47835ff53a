"""ctypes bindings for the port's host library.

The C++ sources in ``csrc/host/`` — the port's copies of the JAX package's
``native/src/pyramid_tracker.cc``, ``lora_codec.cc`` and
``ring_buffer.cc`` with its header — are compiled with the host C++
compiler, no nvcc, into ``gr_lora_tpu_torch/_build/liblora_host.so``
(listed in ``.gitignore``) at first use, and rebuilt whenever a source is
newer than the library.  A file lock serialises concurrent builds (several
test processes import this at once) and the library is renamed into
place, so no reader sees a half-written file.  A failed build raises with
the compiler's output: there is no fallback (:func:`available` reports
whether it builds, and is used by no caller to choose another path).

Bound: :class:`PyramidTracker` (one stream), :class:`MultiPyramidTracker`
(a bank of per-channel trackers fed whole ``[C, H, M]`` peak blocks), the
codec twin (:func:`encode`, :func:`decode`, :func:`data_checksum`,
:func:`whitening_sequence`, bit-exact with ``core.codec``) and
:class:`RingBuffer`, the SPSC byte ring behind ``pipeline.ingest``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..config import LoraConfig

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "liblora_host.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cc"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in SRC_DIR.iterdir())


def build() -> Path:
    """Compile ``csrc/host/*.cc`` into LIB_PATH if it is missing or
    stale; raise if the compiler is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale():
                return LIB_PATH
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (c++ or g++) to "
                                   "build the host library")
            tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, f"-I{SRC_DIR}", "-o", str(tmp),
                   *map(str, sources())]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"host library build failed ({res.returncode}):\n"
                        f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
                os.replace(tmp, LIB_PATH)
            finally:
                tmp.unlink(missing_ok=True)
            return LIB_PATH
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded host library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def available() -> bool:
    """Whether the host library builds (or is built) and loads.  Never
    raises; a report, not a fallback: the port's callers still choose the
    native tracker with their own ``use_native`` rule, which raises on a
    failed build."""
    try:
        library()
    except Exception:
        return False
    return True


class LoraParams(ctypes.Structure):
    """``lora_params``: the codec's view of a LoraConfig."""
    _fields_ = [
        ("sf", ctypes.c_int32), ("cr", ctypes.c_int32),
        ("crc", ctypes.c_int32), ("ldr", ctypes.c_int32),
        ("explicit_header", ctypes.c_int32), ("payload_len", ctypes.c_int32),
    ]

    @classmethod
    def from_config(cls, cfg: LoraConfig) -> "LoraParams":
        return cls(cfg.sf, cfg.cr, int(cfg.crc), int(cfg.ldr),
                   int(cfg.explicit_header), cfg.payload_len)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = ctypes.c_int32
    vp = ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    size = ctypes.c_size_t
    prm = ctypes.POINTER(LoraParams)
    sigs = {
        "lora_pyramid_create": (vp, [i32] * 4 + [ctypes.c_float] + [i32] * 3),
        "lora_pyramid_destroy": (None, [vp]),
        "lora_pyramid_step": (None, [vp, i32p, f32p, f32p, i32]),
        "lora_pyramid_pending": (i32, [vp]),
        "lora_pyramid_pop_ts": (i32, [vp, u16p, i32, i64p]),
        "lora_pyramid_flush_hops": (i32, [vp]),
        "lora_pyramid_stats": (None, [vp, i64p]),
        "lora_pyramid_multi_create": (
            vp, [i32] * 5 + [ctypes.c_float] + [i32] * 3),
        "lora_pyramid_multi_destroy": (None, [vp]),
        "lora_pyramid_multi_feed": (
            None, [vp, i32p, f32p, f32p, u8p, i32, i32, i32]),
        "lora_pyramid_multi_pending": (i32, [vp, i32]),
        "lora_pyramid_multi_pop_ts": (i32, [vp, i32, u16p, i32, i64p]),
        "lora_pyramid_multi_flush_hops": (i32, [vp]),
        "lora_pyramid_multi_stats": (None, [vp, i64p]),
        "lora_calc_sym_num": (i32, [prm, i32]),
        "lora_encode": (i32, [prm, u8p, i32, u16p, i32]),
        "lora_decode": (i32, [prm, u16p, i32, u8p, i32] + [i32p] * 5),
        "lora_data_checksum": (ctypes.c_uint16, [u8p, i32]),
        "lora_header_checksum": (ctypes.c_uint8,
                                 [ctypes.c_uint8, ctypes.c_uint8]),
        "lora_whitening_sequence": (None, [u8p]),
        "lora_ring_create": (vp, [size]),
        "lora_ring_destroy": (None, [vp]),
        "lora_ring_capacity": (size, [vp]),
        "lora_ring_readable": (size, [vp]),
        "lora_ring_writable": (size, [vp]),
        "lora_ring_write": (size, [vp, u8p, size]),
        "lora_ring_read": (size, [vp, u8p, size]),
        "lora_ring_peek": (size, [vp, u8p, size]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _stats(fn, handle) -> dict:
    s = np.zeros(3, np.int64)
    fn(handle, _ptr(s, ctypes.c_int64))
    return {"tracks_dropped": int(s[0]), "packets_dropped": int(s[1]),
            "tracks_overflow_finalized": int(s[2])}


class PyramidTracker:
    """Native pyramid peak-track state machine for one stream, fed one
    hop's peaks (sorted ascending by bin) per :meth:`step`."""

    def __init__(self, cfg: LoraConfig, grace: int = 0,
                 split_repeats: bool = False, quantize: str = "round"):
        if quantize not in ("floor", "round"):
            raise ValueError(f"quantize must be 'floor' or 'round': "
                             f"{quantize!r}")
        self._lib = library()
        self._h = self._lib.lora_pyramid_create(
            cfg.sf, cfg.p, cfg.fft_factor, int(cfg.ldr), cfg.threshold, grace,
            int(split_repeats), int(quantize == "round"))
        if not self._h:
            raise MemoryError("lora_pyramid_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.lora_pyramid_destroy(h)
            self._h = None

    def step(self, bins=(), h=(), h_single=()):
        b = np.ascontiguousarray(bins, np.int32)
        hh = np.ascontiguousarray(h, np.float32)
        hs = np.ascontiguousarray(h_single, np.float32)
        self._lib.lora_pyramid_step(
            self._h, _ptr(b, ctypes.c_int32), _ptr(hh, ctypes.c_float),
            _ptr(hs, ctypes.c_float), len(b))

    def flush_hops(self) -> int:
        return int(self._lib.lora_pyramid_flush_hops(self._h))

    def drain(self) -> list[np.ndarray]:
        """Every finished packet's symbols, oldest first."""
        return [s for _, s in self.drain_ts()]

    def drain_ts(self) -> list[tuple[int, np.ndarray]]:
        """As :meth:`drain`, as (preamble timestamp, symbols) pairs; the
        timestamp is the sample index modulo 2^28, as the tracker clock."""
        out = []
        buf = np.zeros(4096, np.uint16)
        ts = ctypes.c_int64(0)
        while self._lib.lora_pyramid_pending(self._h) > 0:
            n = self._lib.lora_pyramid_pop_ts(
                self._h, _ptr(buf, ctypes.c_uint16), len(buf),
                ctypes.byref(ts))
            if n == -2:          # packet larger than buffer: grow and retry
                buf = np.zeros(len(buf) * 2, np.uint16)
                continue
            if n < 0:
                break
            out.append((int(ts.value), buf[:n].copy()))
        return out

    def stats(self) -> dict:
        return _stats(self._lib.lora_pyramid_stats, self._h)


class MultiPyramidTracker:
    """Bank of per-channel pyramid trackers advanced by whole [C, H, M]
    peak-lattice blocks in one native call (the channels walk in
    parallel on the host's cores)."""

    def __init__(self, cfg: LoraConfig, channels: int, grace: int = 0,
                 split_repeats: bool = False, quantize: str = "round"):
        if quantize not in ("floor", "round"):
            raise ValueError(f"quantize must be 'floor' or 'round': "
                             f"{quantize!r}")
        self._lib = library()
        self.channels = channels
        self._h = self._lib.lora_pyramid_multi_create(
            channels, cfg.sf, cfg.p, cfg.fft_factor, int(cfg.ldr),
            cfg.threshold, grace, int(split_repeats), int(quantize == "round"))
        if not self._h:
            raise MemoryError("lora_pyramid_multi_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.lora_pyramid_multi_destroy(h)
            self._h = None

    def feed(self, bins, h, h_single, valid) -> None:
        """bins int32[C, H, M], h/h_single float32[C, H, M],
        valid bool[C, H, M] — one device block for every channel."""
        b = np.ascontiguousarray(bins, np.int32)
        hh = np.ascontiguousarray(h, np.float32)
        hs = np.ascontiguousarray(h_single, np.float32)
        v = np.ascontiguousarray(valid, np.uint8)
        c, nh, mp = b.shape
        if c != self.channels or not (hh.shape == hs.shape == v.shape
                                      == b.shape):
            raise ValueError(f"peak block shapes {b.shape}, {hh.shape}, "
                             f"{hs.shape}, {v.shape} for {self.channels} "
                             "channels")
        self._lib.lora_pyramid_multi_feed(
            self._h, _ptr(b, ctypes.c_int32), _ptr(hh, ctypes.c_float),
            _ptr(hs, ctypes.c_float), _ptr(v, ctypes.c_uint8), c, nh, mp)

    def flush_hops(self) -> int:
        return int(self._lib.lora_pyramid_multi_flush_hops(self._h))

    def drain(self) -> list[tuple[int, int, np.ndarray]]:
        """All finished packets as (channel, position, symbols) tuples;
        position is the preamble sample index (mod 2^28)."""
        out = []
        buf = np.zeros(4096, np.uint16)
        ts = ctypes.c_int64(0)
        for c in range(self.channels):
            while self._lib.lora_pyramid_multi_pending(self._h, c) > 0:
                n = self._lib.lora_pyramid_multi_pop_ts(
                    self._h, c, _ptr(buf, ctypes.c_uint16), len(buf),
                    ctypes.byref(ts))
                if n == -2:      # packet larger than buffer: grow and retry
                    buf = np.zeros(len(buf) * 2, np.uint16)
                    continue
                if n < 0:
                    break
                out.append((c, int(ts.value), buf[:n].copy()))
        return out

    def stats(self) -> dict:
        return _stats(self._lib.lora_pyramid_multi_stats, self._h)


# -- the codec twin -----------------------------------------------------------

def encode(payload: bytes, cfg: LoraConfig) -> np.ndarray:
    """Native payload -> symbols; bit-exact with core.codec.encode."""
    lib = library()
    prm = LoraParams.from_config(cfg)
    data = np.frombuffer(bytes(payload), dtype=np.uint8)
    cap = lib.lora_calc_sym_num(ctypes.byref(prm), len(data)) + 16
    out = np.zeros(cap, dtype=np.uint16)
    n = lib.lora_encode(ctypes.byref(prm), _ptr(data, ctypes.c_uint8),
                        len(data), _ptr(out, ctypes.c_uint16), cap)
    if n < 0:
        raise ValueError(f"lora_encode failed ({n}) for {len(data)} bytes "
                         f"at {cfg}")
    return out[:n].copy()


def decode(symbols: np.ndarray, cfg: LoraConfig):
    """Native symbols -> (bytes, header dict | None, crc_ok | None, ok):
    the JAX package's native.decode contract."""
    lib = library()
    prm = LoraParams.from_config(cfg)
    syms = np.ascontiguousarray(symbols, dtype=np.uint16)
    cap = 1024
    out = np.zeros(cap, dtype=np.uint8)
    hv, hl, hc, hk, ck = (ctypes.c_int32(-1) for _ in range(5))
    n = lib.lora_decode(ctypes.byref(prm), _ptr(syms, ctypes.c_uint16),
                        len(syms), _ptr(out, ctypes.c_uint8), cap,
                        ctypes.byref(hv), ctypes.byref(hl), ctypes.byref(hc),
                        ctypes.byref(hk), ctypes.byref(ck))
    header = None
    if cfg.explicit_header:
        header = dict(is_valid=bool(hv.value), payload_len=hl.value,
                      cr=hc.value, crc=bool(hk.value))
    if n < 0:
        return np.zeros(0, np.uint8), header, None, False
    crc_ok = None if ck.value < 0 else bool(ck.value)
    return out[:n].copy(), header, crc_ok, True


def data_checksum(data: bytes) -> int:
    """CRC16 of ``data`` with the reference's quirk (core.crc)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(library().lora_data_checksum(_ptr(arr, ctypes.c_uint8),
                                            len(arr)))


def whitening_sequence() -> np.ndarray:
    """The 255-byte whitening sequence (core.constants)."""
    out = np.zeros(255, dtype=np.uint8)
    library().lora_whitening_sequence(_ptr(out, ctypes.c_uint8))
    return out


# -- the ring -----------------------------------------------------------------

class RingBuffer:
    """SPSC byte ring buffer (GR stream-buffer analog): one thread writes,
    one reads, no locks.  The capacity rounds up to a power of two."""

    def __init__(self, capacity: int):
        self._lib = library()
        self._h = self._lib.lora_ring_create(capacity)
        if not self._h:
            raise MemoryError("lora_ring_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.lora_ring_destroy(h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.lora_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.lora_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.lora_ring_writable(self._h)

    def write(self, data) -> int:
        """Copy as much of ``data`` (bytes or a uint8 array) as fits;
        returns the bytes written."""
        arr = np.frombuffer(bytes(data), np.uint8) \
            if isinstance(data, (bytes, bytearray)) \
            else np.ascontiguousarray(data, np.uint8).reshape(-1)
        return self._lib.lora_ring_write(self._h, _ptr(arr, ctypes.c_uint8),
                                         arr.nbytes)

    def read(self, n: int) -> np.ndarray:
        """Up to ``n`` bytes, consumed.  Always a fresh array, never a view
        of ring memory: the consumer uploads blocks asynchronously, and the
        producer would overwrite a view under the copy."""
        out = np.zeros(n, np.uint8)
        got = self._lib.lora_ring_read(self._h, _ptr(out, ctypes.c_uint8), n)
        return out[:got]

    def peek(self, n: int) -> np.ndarray:
        """As :meth:`read`, without consuming."""
        out = np.zeros(n, np.uint8)
        got = self._lib.lora_ring_peek(self._h, _ptr(out, ctypes.c_uint8), n)
        return out[:got]
