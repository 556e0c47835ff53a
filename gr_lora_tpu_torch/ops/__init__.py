"""Signal-processing ops and the hand-written kernel wrappers.

The NumPy / plain-torch ops of the JAX package's ``ops`` namespace are
re-exported here (``ZoomDft`` stands for its ``BandSpec`` / ``ZoomDftPlan``);
importing them loads no kernel.  The kernel wrappers (``direct``,
``rdft_spectra``, ``overlap_spectra``, ...) are imported by module path,
and each builds its CUDA library only when it first launches a kernel."""

from .chirp import chirp_tables, mod_reference_tables, symbol_chirp
from .cplx import cmag, cmag2, cmatmul, cmul, from_ri, to_ri
from .dechirp import (
    band_peak,
    down_bands,
    down_peak,
    frame_signal,
    kaiser_window,
    pyramid_spectra,
    up_bands,
    up_peak,
)
from .dft import ZoomDft

__all__ = [
    "chirp_tables", "mod_reference_tables", "symbol_chirp",
    "cmag", "cmag2", "cmatmul", "cmul", "from_ri", "to_ri",
    "ZoomDft",
    "band_peak", "down_bands", "down_peak", "frame_signal",
    "kaiser_window", "pyramid_spectra", "up_bands", "up_peak",
]
