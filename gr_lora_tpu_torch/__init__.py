"""gr_lora_tpu_torch — the PyTorch + CUDA port of gr_lora_tpu.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``pipeline/``, ``dist/``) and imports nothing of
it, nor jax.  It keeps its own copies of what it needs that holds no JAX:
``config`` (``LoraConfig``), ``core`` (the NumPy codec) and ``native``
(ctypes bindings of the C++ Pyramid tracker in ``csrc/host/``, built with
the host C++ compiler at first use).

Hand-written Hopper kernels live in ``csrc/*.cu`` and are built with nvcc
at first use (``ops/_build.py``).  Every kernel op keeps a plain PyTorch
version beside it; a wrapper takes the plain version only for a tensor that
lies on the CPU, and on a CUDA tensor it launches the kernel or raises.
The entry points (``pyramid_demodulate``, ``StreamingPyramidDemodulator``,
the gateways, ``DeviceRing``) run on the card unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

from .config import LoraConfig, PeakSearch

__version__ = "0.2.0"
__all__ = ["LoraConfig", "PeakSearch", "blocks", "blocks_meta", "__version__"]

_LAZY = ("blocks", "blocks_meta", "native")


def __getattr__(name):
    # Lazy, as in the JAX package: the block-style API pulls in model
    # modules, and ``native`` its host library's bindings, on first touch.
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
