"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources have a plain C interface.  Each is compiled with its own
``nvcc`` for ``sm_90a``, all at once, and the objects are linked into one
shared library under ``gr_lora_tpu_torch/_build/`` (listed in
``.gitignore``), then loaded with ctypes.  The library is built
at first use and rebuilt whenever a source or a header they share
(``csrc/*.cuh``) is newer than it, so a fresh checkout builds everything
on its first kernel launch.  The host tracker's C++ (``csrc/host/``) is
not part of it: ``gr_lora_tpu_torch/native`` builds that with the host
compiler.  Every entry point
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
#: ptxas's resource report (registers, spills, static shared memory) of
#: every kernel of the last build.
PTXAS_PATH = BUILD_DIR / "ptxas.txt"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
#: Flags of one source beside COMPILE_FLAGS: the tracker rounds every f32
#: operation on its own, as the JAX package does (no FMA contraction).
SOURCE_FLAGS = {"device_tracker.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of each kernel entry point (all return int).
SIGNATURES = {
    "grl_rdft_spectra": [_P] * 7 + [_I] * 6 + [_P],
    "grl_rdft_peaks": [_P] * 10 + [_I] * 7 + [_F, _P],
    "grl_overlap_spectra": [_P] * 7 + [_I] * 9 + [_P],
    "grl_overlap_peaks": [_P] * 10 + [_I] * 10 + [_F, _P],
    "grl_direct_spectra": [_P] * 6 + [_I] * 6 + [_P],
    "grl_direct_peaks": [_P] * 7 + [_I] * 7 + [_F, _P],
    "grl_peak_topm": [_P] * 7 + [_LL, _I, _I, _F, _P],
    "grl_chunk_spectra": [_P] * 6 + [_I] * 6 + [_P],
    "grl_rate_probe": [_P] * 4 + [_I] * 4 + [_P],
    "grl_overlap_probe": [_P] * 6 + [_I] * 7 + [_P],
    "grl_device_tracker": [_P, _P, _F] + [_P] * 5,
    "grl_device_tracker_global": [_P, _P, _F] + [_P] * 5,
    "grl_fsm_win": [_P, _P],
    "grl_fsm_sfd": [_P, _P],
    "grl_fsm_update": [_P, _P],
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
    return any(p.stat().st_mtime > built
               for p in (*sources(), *CSRC.glob("*.cuh")))


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise with the output of each that
    failed, after all have ended.  Returns their standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(errs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into LIB_PATH if it is missing or stale.

    A file lock serialises concurrent builds (several test processes);
    the objects and the library are written under temporary names and
    the library is renamed into place, so a reader never sees a
    half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale():
                return LIB_PATH
            nvcc = _nvcc()
            tag = os.getpid()
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
            tmp = LIB_PATH.with_suffix(f".{tag}.tmp")
            try:
                report = _run_all([[nvcc, *COMPILE_FLAGS,
                                    *SOURCE_FLAGS.get(src.name, ()), "-o",
                                    str(obj), str(src)]
                                   for src, obj in zip(sources(), objs)])
                _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)]])
                PTXAS_PATH.write_text(report)
                os.replace(tmp, LIB_PATH)
            finally:
                for f in (*objs, tmp):
                    f.unlink(missing_ok=True)
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


def resources() -> dict[str, str]:
    """{kernel function: ptxas's "Used N registers ..." line, with its
    spill line} from the last build's report."""
    out, name = {}, None
    text = PTXAS_PATH.read_text() if PTXAS_PATH.exists() else ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill" in line:
            out[name] = line.strip()
        elif name and "Used" in line:
            out[name] = (f"{line.split(':', 1)[1].strip()}; "
                         f"{out.get(name, '')}")
            name = None
    return out


def check(name: str, err: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def stream_of(t) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
