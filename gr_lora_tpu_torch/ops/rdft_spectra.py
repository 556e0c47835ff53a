"""K3: the rDFT pyramid spectra (backend "rdft"; the front end of K1).

Replaces gr_lora_tpu/ops/pallas_rdft.py ``make_rdft_spectra``.  Per hop
frame the dechirped frame u (and u x Kaiser) is transformed by one shared
bf16 ``[n, 2(K+128)]`` block of ``[cos | -sin]`` columns over bins 0..K;
the conjugate recombination gives ``|X(b)|`` and ``|X(b-K)|`` from the
positive band alone, and the folds give fa / faw / hs ``[..., H, K]``.

On a CUDA tensor :class:`RdftSpectra` launches ``csrc/rdft_spectra.cu``
(``wgmma`` + TMA on the ring K4b uses): a pre-pass writes the dechirped
frames (and the windowed ones) once as bf16 tiles in the row order the
fold needs, and the product reads them as TMA boxes against W re-laid in
tiles of 32-bin pairs (:func:`tile_weights`), so that bin b and its
partner column K - b sit in one thread's accumulator registers, where the
recombination and folds are taken.  On a CPU tensor it runs
:meth:`RdftSpectra.plain`, the same numeric class in plain PyTorch
(bf16-rounded operands, an f32 ``torch.matmul``, the recombination).  The
TPU kernel's anti-identity lane reversal (``rev="matmul"``) is not carried
over: bin K-j is indexed directly, so the mirror magnitudes are never
rounded to bf16 (the JAX ``rev="flip"`` variant is the matching one).
The kernel serves n a multiple of 32 and K a multiple of 64 and raises
otherwise.

:func:`tile_weights`, :func:`frame_tiles` and :func:`tile_spectra` are the
kernel's walk in plain torch, for the tests: its W, its A tiles and the
fold through wgmma's accumulator-to-bin mapping.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .chirp import chirp_tables
from .dechirp import frame_signal, kaiser_window

_R = PYRAMID_OVERLAP_FACTOR
_PAD = 128          # kp = K + 128 columns per half, as in the JAX plan
#: The kernel's tiles: 64 frames (rows ur, ui) x 32-bin pairs (128 W
#: columns), 64 deep a stage.
FRAME_TILE = 64
PAIR = 32
DEPTH = 64


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of two bf16 tensors with the products summed in f32 —
    the tensor-core class, in plain PyTorch.  Both operands are upcast to
    f32 exactly.  TF32, where the caller allows it, rounds an operand to
    10 mantissa bits and so leaves these 7-bit values unchanged, and every
    product of two of them is exact in f32: the result is an f32 sum of
    exact products whatever the process's TF32 setting, which is read and
    never written here."""
    return torch.matmul(a.float(), w.float())


@lru_cache(maxsize=None)
def rdft_weights(sf: int, p: int, fft_factor: int) -> np.ndarray:
    """float32 [n, 2*kp] (bf16-representable after rounding): zoom-DFT
    exponentials [cos | -sin] for bins 0..K inclusive, columns K+1..kp-1
    of each half zero (pallas_rdft._rdft_weights)."""
    n = p << sf
    f = fft_factor * n
    k = fft_factor << sf
    kp = k + _PAD
    th = 2.0 * np.pi * np.outer(np.arange(n), np.arange(kp)) / f
    w = np.zeros((n, 2 * kp), np.float32)
    w[:, :kp] = np.cos(th)
    w[:, kp:] = -np.sin(th)
    w[:, k + 1:kp] = 0.0
    w[:, kp + k + 1:] = 0.0
    return w


def _npad(n: int) -> int:
    return -(-n // DEPTH) * DEPTH


@lru_cache(maxsize=4)
def tile_weights(sf: int, p: int, fft_factor: int) -> torch.Tensor:
    """bf16 [npad, (K / 64 + 1) 128]: the kernel's W, a permutation of
    ``rdft_weights``' bf16 values (rows past n zero, npad = n rounded up
    to 64).  Pair tile t (b0 = 32 t) holds the columns [cos S1 | -sin S1 |
    cos S2 | -sin S2], S1 = bins b0 + j and S2 = K - b0 - j, j < 32; the
    last tile (b0 = K / 2) serves bin K / 2 alone."""
    n = p << sf
    k = fft_factor << sf
    kp = k + _PAD
    w = torch.from_numpy(rdft_weights(sf, p, fft_factor)).to(torch.bfloat16)
    b0 = torch.arange(k // (2 * PAIR) + 1)[:, None] * PAIR
    j = torch.arange(PAIR)[None, :]
    s1, s2 = b0 + j, k - b0 - j
    cols = torch.stack([s1, kp + s1, s2, kp + s2], dim=1).reshape(-1)
    out = torch.zeros((_npad(n), cols.numel()), dtype=torch.bfloat16)
    out[:n] = w[:, cols]
    return out


@lru_cache(maxsize=None)
def rdft_consts(sf: int, p: int, beta: float) -> np.ndarray:
    """float32 [8, n]: rows 0/1 the dechirp multiplier (re/im), row 2 the
    Kaiser window (pallas_rdft._consts)."""
    n = p << sf
    _, down = chirp_tables(sf, p)
    c = np.zeros((8, n), np.float32)
    c[0] = down.real.astype(np.float32)
    c[1] = down.imag.astype(np.float32)
    c[2] = kaiser_window(n, beta).astype(np.float32)
    return c


class RdftSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_frames, K].

    Buffers: ``w`` bf16 [n, 2*kp] (the plain version's), ``w_tiles`` (the
    kernel's, :func:`tile_weights`) and ``consts`` f32 [8, n].
    ``launches`` counts kernel launches made through :meth:`forward` (one
    per call on a CUDA tensor); :meth:`kernel` launches without counting,
    for the lattices that compose this front end (K1)."""

    def __init__(self, cfg: LoraConfig, num_frames: int):
        super().__init__()
        self.n = cfg.num_samples
        self.hop = self.n // _R
        self.k = cfg.bin_size
        self.kp = self.k + _PAD
        self.num_frames = num_frames
        w = torch.from_numpy(rdft_weights(cfg.sf, cfg.p, cfg.fft_factor))
        self.register_buffer("w", w.to(torch.bfloat16))
        self.register_buffer("w_tiles", tile_weights(cfg.sf, cfg.p,
                                                     cfg.fft_factor))
        self.register_buffer("consts", torch.tensor(
            rdft_consts(cfg.sf, cfg.p, float(cfg.beta))))
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        if iq.device.type == "cpu":
            return self.plain(iq)
        out = self.kernel(iq)
        self.launches += 1
        return out

    def plain(self, iq: torch.Tensor):
        """(fa, faw, hs) [..., H, K] in the kernel's numeric class."""
        frames = frame_signal(iq, self.n, self.hop, self.num_frames)
        xr, xi = frames[..., 0], frames[..., 1]
        dr, di, win = self.consts[0], self.consts[1], self.consts[2]
        ur = xr * dr - xi * di
        ui = xr * di + xi * dr

        def dot(u):
            return bf16_matmul(u.to(torch.bfloat16), self.w)

        k, kp = self.k, self.kp

        def recombine(y1, y2):
            rre, rim = y1[..., :kp], y1[..., kp:]
            ire, iim = y2[..., :kp], y2[..., kp:]
            xre = rre[..., :k] - iim[..., :k]
            xim = rim[..., :k] + ire[..., :k]
            mpos = torch.sqrt(xre * xre + xim * xim)
            gre = rre[..., 1:k + 1] + iim[..., 1:k + 1]
            gim = ire[..., 1:k + 1] - rim[..., 1:k + 1]
            g = torch.sqrt(gre * gre + gim * gim)        # |X(-b)|, b in 1..K
            return mpos, torch.flip(g, dims=[-1])        # |X(j-K)|

        m0, m1 = recombine(dot(ur), dot(ui))
        m2, m3 = recombine(dot(ur * win), dot(ui * win))
        return m0 + m1, m2 + m3, torch.maximum(m0, m1)

    def launch_args(self, iq: torch.Tensor):
        """(iq [lanes, T, 2] contiguous, its leading shape, the A tiles
        scratch) for a kernel launch; raises on what the kernel does not
        take."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("the rDFT kernel takes CUDA float32 [..., T, 2]")
        if self.w_tiles.device != iq.device:
            raise ValueError(f"module on {self.w_tiles.device}, "
                             f"iq on {iq.device}")
        if self.n % 32 or self.k % (2 * PAIR):
            raise RuntimeError(
                f"the rDFT kernel needs n a multiple of 32 and K a multiple "
                f"of {2 * PAIR}: n {self.n}, K {self.k}")
        x = iq.reshape(-1, iq.shape[-2], 2).contiguous()
        tiles = -(-self.num_frames // FRAME_TILE)
        a = torch.empty((x.shape[0], tiles, 2, 2 * FRAME_TILE,
                         _npad(self.n)), dtype=torch.bfloat16,
                        device=iq.device)
        return x, iq.shape[:-2], a

    def kernel(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq (not counted)."""
        x, lead, a = self.launch_args(iq)
        lanes, t_len = x.shape[0], x.shape[1]
        out = torch.empty((3, lanes, self.num_frames, self.k),
                          dtype=torch.float32, device=iq.device)
        fa, faw, hs = out[0], out[1], out[2]
        lib = _build.library()
        with torch.cuda.device(iq.device):
            err = lib.grl_rdft_spectra(
                x.data_ptr(), self.w_tiles.data_ptr(),
                self.consts.data_ptr(), a.data_ptr(), fa.data_ptr(),
                faw.data_ptr(), hs.data_ptr(), lanes, t_len,
                self.num_frames, self.n, self.hop, self.k,
                _build.stream_of(x))
        _build.check("grl_rdft_spectra", err)
        shape = (*lead, self.num_frames, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)


# ---- the kernel's walk in plain torch (tests) ---------------------------

def frame_tiles(iq: torch.Tensor, consts: torch.Tensor, n: int, hop: int,
                num_frames: int) -> torch.Tensor:
    """The pre-pass: iq [..., T, 2] -> bf16 A tiles [..., tiles, 2 (plain,
    windowed), 128, npad]; row 16 w + 8 i + r of tile t is component i
    (ur, ui) of frame 64 t + 8 w + r, zero past the frames, past T and at
    depths >= n.  Each value is rounded as :meth:`RdftSpectra.plain`
    rounds its operands (f32 dechirp and window, then bf16 once)."""
    tiles = -(-num_frames // FRAME_TILE)
    fr = frame_signal(iq, n, hop, num_frames)                 # [..., H, n, 2]
    pad = tiles * FRAME_TILE - num_frames
    fr = torch.nn.functional.pad(fr, (0, 0, 0, _npad(n) - n, 0, pad))
    dr, di, win = (torch.nn.functional.pad(consts[c], (0, _npad(n) - n))
                   for c in range(3))
    xr, xi = fr[..., 0], fr[..., 1]
    ur = xr * dr - xi * di
    ui = xr * di + xi * dr
    v = torch.stack([torch.stack([ur, ui]), torch.stack([ur * win,
                                                         ui * win])])
    # v [2 (p), 2 (i), ..., tiles * 64, npad] -> rows (w, i, r) of 64 frames.
    v = v.reshape(2, 2, *v.shape[2:-2], tiles, 8, 8, v.shape[-1])
    v = v.movedim((0, 1), (-5, -3))           # [..., tiles, p, w, i, r, npad]
    return v.reshape(*v.shape[:-5], 2, 2 * FRAME_TILE, v.shape[-1]) \
        .to(torch.bfloat16)


def _accumulator_layout():
    """(row, col) [256 threads, 64 registers] of one of the two consumer
    warpgroups' wgmma m64n128k16 accumulators on a 128 x 128 tile: d[4 j +
    2 i + c] of thread t holds row 64 wg + 16 warp + lane // 4 + 8 i,
    column 8 j + 2 (lane % 4) + c."""
    t = torch.arange(256)[:, None]
    r = torch.arange(64)[None, :]
    wg, warp, lane = t // 128, t % 128 // 32, t % 32
    j, i, c = r // 4, r % 4 // 2, r % 2
    return (64 * wg + 16 * warp + lane // 4 + 8 * i,
            8 * j + 2 * (lane % 4) + c)


def tile_spectra(a: torch.Tensor, w_tiles: torch.Tensor, k: int,
                 num_frames: int):
    """(fa, faw, hs) [..., num_frames, K] from A tiles [..., tiles, 2, 128,
    npad] and the re-laid W through the kernel's tiles: each 128 x 128
    product tile (plain and windowed) read as the threads' accumulator
    registers, each thread recombining and folding its bin pairs and
    writing bins b0 + j and K - b0 - j by the kernel's rules: the mirror
    side in pairs formed across the quad of lanes, column K to no bin,
    bin K / 2 from the last pair tile alone."""
    lead, tiles = a.shape[:-4], a.shape[-4]
    ntiles = k // (2 * PAIR) + 1
    y = bf16_matmul(a, w_tiles)                      # [..., T, 2, 128, N]
    y = y.reshape(*lead, tiles, 2, 2 * FRAME_TILE, ntiles, 4 * PAIR) \
        .movedim(-2, -4)                         # [..., T, nt, 2, 128, 128]
    row, col = _accumulator_layout()
    # Register 4 (4 g + t) + 2 i + c: [..., T, nt, p, thread, g, t, i, c].
    d = y[..., row, col].reshape(*y.shape[:-2], 256, 4, 4, 2, 2)

    def mags(g0):
        """(|X(b)|, |X(-b)|) [..., T, nt, p, thread, t, c] of S1 (g0 0) or
        S2 (g0 2)."""
        rre, rim = d[..., g0, :, 0, :], d[..., g0 + 1, :, 0, :]
        ire, iim = d[..., g0, :, 1, :], d[..., g0 + 1, :, 1, :]
        xre, xim = rre - iim, rim + ire
        gre, gim = rre + iim, ire - rim
        return (torch.sqrt(xre * xre + xim * xim),
                torch.sqrt(gre * gre + gim * gim))

    (p1, n1), (p2, n2) = mags(0), mags(2)

    def fold(m0, m1):
        """(fa, faw, hs) [..., T, nt, thread, t, c] of p = plain, windowed."""
        return (m0[..., 0, :, :, :] + m1[..., 0, :, :, :],
                m0[..., 1, :, :, :] + m1[..., 1, :, :, :],
                torch.maximum(m0[..., 0, :, :, :], m1[..., 0, :, :, :]))

    # Bin b0 + j from S1 and S2's conjugate side, bin K - b0 - j the
    # other way round.
    v1, v2 = fold(p1, n2), fold(p2, n1)
    thread = torch.arange(256)
    frame = (thread // 128) * 32 + (thread % 128 // 32) * 8 + thread % 32 // 4
    q = thread % 4
    t = torch.arange(4)
    b0 = torch.arange(ntiles - 1)[:, None, None] * PAIR
    # e: the mirror bin K - b0 - 8 t - 2 q of each thread's c = 0 value
    # [nt - 1, thread, t].  The kernel stores the pair (e - 2, e - 1): the
    # c = 0 value of lane q + 1 (lane 0's at t + 1 for q = 3) beside its own
    # c = 1 value; alone, bin e - 1 at q = t = 3 and bin e (its own c = 0)
    # at q = t = 0 for b0 > 0.  Unwritten slots go to the spare bin K.
    e = k - b0 - 8 * t - 2 * q[:, None]
    src = torch.where(q < 3, thread + 1, thread - 3)[:, None]
    src_t = torch.where(q[:, None] < 3, t, (t + 1).clamp(max=3))
    edge = (q[:, None] == 3) & (t == 3)
    alone = (q[:, None] == 0) & (t == 0) & (b0 > 0)
    fi = torch.arange(tiles)[:, None, None, None, None]
    fr = frame[:, None, None]
    out = torch.zeros((3, *lead, tiles, FRAME_TILE, k + 1))
    sel = q == 0
    bins = b0[..., None] + 8 * t[:, None] + 2 * q[:, None, None] \
        + torch.arange(2)                            # [nt - 1, thread, t, c]
    fi3, fr3 = fi[..., 0], fr[..., 0]
    for o, x1, x2 in zip(out, v1, v2):
        # The last pair tile: bin K/2 alone, from lane q = 0 at t = c = 0.
        o[..., fi[:, 0, 0, 0], frame[sel], k // 2] = \
            x1[..., ntiles - 1, :, 0, 0][..., sel]
        x1, x2 = x1[..., :ntiles - 1, :, :, :], x2[..., :ntiles - 1, :, :, :]
        o[..., fi, fr, bins] = x1
        o[..., fi3, fr3, torch.where(edge, k, e - 2)] = x2[..., src, src_t, 0]
        o[..., fi3, fr3, e - 1] = x2[..., 1]
        o[..., fi3, fr3, torch.where(alone, e, k)] = x2[..., 0]
    out = out[..., :k].reshape(3, *lead, tiles * FRAME_TILE, k)
    return tuple(x[..., :num_frames, :] for x in out)
