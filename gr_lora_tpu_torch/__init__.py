"""gr_lora_tpu_torch — the PyTorch + CUDA port of gr_lora_tpu.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``pipeline/``, ``dist/``) and never imports jax.
What holds no JAX is shared, not copied: ``gr_lora_tpu.config``,
``gr_lora_tpu.core`` (the codec) and ``gr_lora_tpu.native`` (the C++
tracker bank) import only numpy and ctypes.

Hand-written Hopper kernels live in ``csrc/`` and are built with nvcc at
first use (``ops/_build.py``).  Every kernel op keeps a plain PyTorch
version beside it; a wrapper takes the plain version only for a tensor that
lies on the CPU, and on a CUDA tensor it launches the kernel or raises.
"""

from gr_lora_tpu.config import LoraConfig, PeakSearch

__all__ = ["LoraConfig", "PeakSearch"]
