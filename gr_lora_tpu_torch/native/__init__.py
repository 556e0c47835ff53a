"""ctypes bindings for the port's host tracker library.

The C++ Pyramid peak tracker (``csrc/host/``: the port's copy of the JAX
package's ``native/src/pyramid_tracker.cc`` and the tracker part of its
header) is compiled with the host C++ compiler — no nvcc — into
``gr_lora_tpu_torch/_build/liblora_tracker.so`` (listed in ``.gitignore``)
at first use, and rebuilt whenever a source is newer than the library.  A
file lock serialises concurrent builds (several test processes import
this at once) and the library is renamed into place, so no reader sees a
half-written file.  A failed build raises with the compiler's output.

Only what the port uses is bound: :class:`PyramidTracker` (one stream)
and :class:`MultiPyramidTracker` (a bank of per-channel trackers fed whole
``[C, H, M]`` peak blocks).
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
LIB_PATH = BUILD_DIR / "liblora_tracker.so"
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
                                   "build the tracker library")
            tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, f"-I{SRC_DIR}", "-o", str(tmp),
                   *map(str, sources())]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=600)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"tracker build failed ({res.returncode}):\n"
                        f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
                os.replace(tmp, LIB_PATH)
            finally:
                tmp.unlink(missing_ok=True)
            return LIB_PATH
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded tracker library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32 = ctypes.c_int32
    vp = ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
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
