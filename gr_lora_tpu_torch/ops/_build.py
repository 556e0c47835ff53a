"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` into one shared library under ``gr_lora_tpu_torch/_build/``
(listed in ``.gitignore``), then loaded with ctypes.  The library is built
at first use and rebuilt whenever a source is newer than it, so a fresh
checkout builds everything on its first kernel launch.  Every entry point
takes its pointers and the CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

Nothing here runs at import: the CPU tests import every module, and a
machine without a GPU may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libgr_lora_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of each kernel entry point (all return int).
SIGNATURES = {
    "grl_rdft_spectra": [_P, _P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "grl_overlap_spectra": [_P] * 8 + [_I] * 7 + [_P],
    "grl_peak_topm": [_P] * 7 + [_LL, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in sources())


def build() -> Path:
    """Compile ``csrc/*.cu`` into LIB_PATH if it is missing or stale.

    A file lock serialises concurrent builds (several test processes);
    the library is written under a temporary name and renamed into place,
    so a reader never sees a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale():
                return LIB_PATH
            tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(p) for p in sources())]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, LIB_PATH)
            return LIB_PATH
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def stream_of(t) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
