"""librosa mel spectrogram by a Cooley-Tukey FFT: the CUDA kernel
``ct_mel.cu``, its binding, and its plain PyTorch version.

Replaces the TPU kernel ``mfcc_rust_tpu/ops/pallas/ct_mel.py``
(``ct_mel_pallas``): window, real FFT, |X|² and the mel projection in one
launch that reads the (centre-padded) signal and writes only the
(B, F, n_mels) answer, frame-major.  The kernel takes its own
factorization (see the note in the .cu source): path 1, a warp-per-frame
register FFT over cp.async-staged tiles (``fft_regs.cuh``), when n/2 is a
power of two from 64 to 1024 and the tile fits; path 2, the radix-4
Stockham stages of ``fft_stages.cuh`` with G frames a block, for every
other even n.

:func:`ct_mel` launches the kernel for a CUDA tensor and runs
:func:`ct_mel_plain` for a CPU tensor; it never falls back from one to the
other.  ``ct_mel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ... import features as _F
from ...config import FeatureConfig
from ...constants import constant_bundle, tensor_cache
from ..fft import good_factorization
from ..framing import pad_signal

KERNEL = "ct_mel"

# ct_mel.cu: kMaxSmem and path 1's kTileF
_MAX_SMEM, _TILE_F = 232448, 16

_round4 = lambda x: -(-x // 4) * 4


def fft_plan(n: int) -> Optional[Tuple[int, int, int]]:
    """The kernel's complex FFT of n/2 points as Stockham stages:
    (m_odd, n4, has2) with n/2 = m_odd * 4**n4 * 2**has2, m_odd odd (one
    direct-DFT stage when > 1).  None for an odd n."""
    if n % 2:
        return None
    m, n4 = n // 2, 0
    while m % 4 == 0:
        m, n4 = m // 4, n4 + 1
    has2 = int(m % 2 == 0)
    return m // 2 ** has2, n4, has2


def smem_bytes(n: int, g: int, nnz: int) -> int:
    """Path 2's dynamic shared memory of one block (``Layout`` in the .cu):
    two buffers of n/2 complex values per frame, then the nnz packed
    filterbank weights."""
    return 4 * (g * 2 * _round4(n) + _round4(nnz))


def frames_per_block(n: int, nnz: int) -> int:
    """Path 2's G, a power of two (each frame of a block gets 256/G
    threads): the most frames (<= 8) for which three blocks share an SM,
    else 1 (0 when even one frame does not fit)."""
    for g in (8, 4, 2, 1):
        if smem_bytes(n, g, nnz) <= _MAX_SMEM // 3:
            return g
    return 1 if smem_bytes(n, 1, nnz) <= _MAX_SMEM else 0


def fft_smem_bytes(n: int, hop: int, kmax: int, nnz: int, m: int, warps: int) -> int:
    """Path 1's dynamic shared memory of one block (``Layout1`` in the .cu),
    n/2 a power of two from 64 to 1024: two slabs of a tile's (16 - 1) * hop
    + n samples, the window, the packed weights and ranges, then per frame
    of each warp the re and im exchange buffers (one float skipped every 32
    points at n/2 = 1024, every 8 below) and the power spectrum (which
    reuses re at n/2 = 1024); a frame has min(32, n/16) lanes."""
    nc = n // 2
    slab = _round4((_TILE_F - 1) * hop + n + 3)
    if nc == 1024:
        frame = 2 * _round4(nc + nc // 32)
    else:
        frame = 2 * _round4(nc + nc // 8) + _round4(kmax)
    per_warp = 32 // min(32, nc // 8) * frame
    return 4 * (2 * slab + _round4(n) + _round4(nnz) + _round4(3 * m) + warps * per_warp)


def fft_warps(n: int, hop: int, kmax: int, nnz: int, m: int) -> int:
    """Path 1's warps a block (``path1_warps`` in the .cu): the most of 8,
    4, 2, 1 whose block fits; 0 where n/2 is no power of two from 64 to
    1024 or not even one warp fits, and then the kernel takes path 2."""
    nc = n // 2
    if n % 2 or not 64 <= nc <= 1024 or nc & (nc - 1):
        return 0
    for w in (8, 4, 2, 1):
        if fft_smem_bytes(n, hop, kmax, nnz, m, w) <= _MAX_SMEM:
            return w
    return 0


def fft_path(n: int, hop: int, kmax: int, nnz: int, m: int) -> int:
    """The kernel's path (``ct_path`` in the .cu): 1, the register FFT,
    where path 1 has warps; else 2, the Stockham stages."""
    return 1 if fft_warps(n, hop, kmax, nnz, m) else 2


def path_for(cfg: FeatureConfig) -> int:
    """The kernel's path for a supported config."""
    _, _, wpack, _, kmax = _kernel_constants(cfg)
    return fft_path(cfg.fft_points, cfg.frame_step, kmax, wpack.size, cfg.num_filters)


def ct_mel_supported(cfg: FeatureConfig) -> bool:
    """librosa framing (frames of fft_points), power 2, an even fft size,
    and one frame's buffers and the packed filterbank in shared memory:
    every even n up to ~28,000 points with slaney banks, which holds every
    config the TPU kernel takes (n a multiple of 256) up to that size."""
    n = cfg.fft_points
    if cfg.frame_size != n or cfg.power != 2.0 or fft_plan(n) is None:
        return False
    # the frame buffers alone first: no constants are built for a size
    # that cannot fit
    return (frames_per_block(n, 0) > 0
            and frames_per_block(n, _kernel_constants(cfg)[2].size) > 0)


def twiddle_table(n: int) -> np.ndarray:
    """(n, 2) float32 (cos, sin)(2πj/n) from float64: W_n^j of the kernels'
    FFTs (``fft_stages.cuh``)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return np.ascontiguousarray(np.stack([np.cos(ang), np.sin(ang)], axis=1), np.float32)


def pack_filterbank(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A (M, K) filterbank packed for the kernels' sparse projections: wpack
    (nnz,) float32, each filter's weights over its nonzero bins [lo, hi) in
    turn, and ranges (M, 3) int32 (lo, hi, offset into wpack); an all-zero
    filter gets lo = hi = 0."""
    k = fb.shape[1]
    nz = fb != 0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, np.argmax(nz, axis=1), 0)
    hi = np.where(any_nz, k - np.argmax(nz[:, ::-1], axis=1), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    wpack = np.concatenate([fb[i, lo[i]:hi[i]] for i in range(fb.shape[0])])
    return (np.ascontiguousarray(wpack, np.float32),
            np.ascontiguousarray(np.stack([lo, hi, off], axis=1), np.int32))


@functools.lru_cache(maxsize=16)
def _kernel_constants(cfg: FeatureConfig):
    """float32 numpy constants: win (n,), tw (n, 2) = (cos, sin)(2πj/n),
    wpack (nnz,), each filter's weights over its nonzero bins [lo, hi) in
    turn, ranges (M, 3) int32 (lo, hi, offset into wpack), and kmax =
    max(hi), the bins the kernel computes."""
    bundle = constant_bundle(cfg)
    wpack, ranges = pack_filterbank(bundle["fbank"])
    return (np.ascontiguousarray(bundle["window"], np.float32), twiddle_table(cfg.fft_points),
            wpack, ranges, int(ranges[:, 1].max(initial=0)))


@tensor_cache(maxsize=16)
def _kernel_tensors(cfg: FeatureConfig, device: torch.device) -> dict:
    win, tw, wpack, ranges, _ = _kernel_constants(cfg)
    t = lambda a: torch.from_numpy(a).to(device)
    return {"win": t(win), "tw": t(tw), "wpack": t(wpack), "ranges": t(ranges)}


def _center(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    n = cfg.fft_points
    return pad_signal(signal, n // 2, n // 2, cfg.pad_mode) if cfg.center else signal


def ct_mel_plain(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (..., T) -> (..., F, M)
    frame-major, F = 1 + (T' - n)//hop over the centre-padded length T' (0
    when negative): frames by a strided view, the window, then
    ``ct_power_project`` of :mod:`..fft`, factored as the reference factors
    (or 2 x n/2 where it finds no balanced factorization)."""
    n = cfg.fft_points
    return _F.ct_frames_mel(_center(signal, cfg), cfg, good_factorization(n) or (2, n // 2))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    return _bind(library(KERNEL))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the C interface."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ct_mel_launch.argtypes = [p, p, p, p, p, p, i, ll] + [i] * 10 + [p]
    lib.ct_mel_launch.restype = i
    lib.ct_mel_plan.argtypes = [i] * 8 + [ctypes.POINTER(ll)]
    lib.ct_mel_plan.restype = i
    lib.ct_mel_path.argtypes = [i] * 5
    lib.ct_mel_path.restype = i
    lib.ct_mel_smem_bytes.argtypes = [i, i, i]
    lib.ct_mel_smem_bytes.restype = ll
    lib.ct_mel_fft_smem_bytes.argtypes = [i] * 6
    lib.ct_mel_fft_smem_bytes.restype = ll
    lib.ct_mel_error_string.argtypes = [i]
    lib.ct_mel_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: {lib.ct_mel_error_string(err).decode()}")


def launch_plan(cfg: FeatureConfig, batch: int, frames: int) -> dict:
    """The launch shape the kernel's host code picks for (batch, frames) on
    the current CUDA device: path, warps a block, shared bytes a block,
    resident blocks per SM and the grid."""
    lib = _lib()
    _, _, wpack, _, kmax = _kernel_constants(cfg)
    info = (ctypes.c_longlong * 5)()
    n = cfg.fft_points
    _check(lib, lib.ct_mel_plan(n, cfg.frame_step, kmax, wpack.size, cfg.num_filters, batch,
                                frames, frames_per_block(n, wpack.size), info), "ct_mel_plan")
    return dict(zip(("path", "warps", "smem_bytes", "blocks_per_sm", "grid"), info))


def _launch(lib: ctypes.CDLL, x: torch.Tensor, cfg: FeatureConfig, out: torch.Tensor,
            stream: int) -> int:
    """One launch of the kernel in ``lib`` on x (B, T), centre-padded, into
    out (B, F, M), both contiguous float32 on the kernel's device, F > 0.
    Returns the C interface's error code."""
    n = cfg.fft_points
    m_odd, n4, has2 = fft_plan(n)
    c = _kernel_tensors(cfg, x.device)
    kmax, nnz = _kernel_constants(cfg)[4], c["wpack"].numel()
    return lib.ct_mel_launch(
        x.data_ptr(), c["win"].data_ptr(), c["tw"].data_ptr(), c["wpack"].data_ptr(),
        c["ranges"].data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], out.shape[1],
        cfg.frame_step, n, m_odd, n4, has2, kmax, nnz, cfg.num_filters,
        frames_per_block(n, nnz), stream,
    )


def ct_mel(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """librosa mel power spectrogram, (..., T) -> (..., F, M) frame-major,
    centre padding included.  A CUDA tensor launches the kernel (and counts
    the launch); a CPU tensor runs :func:`ct_mel_plain`."""
    if not ct_mel_supported(cfg):
        raise ValueError("config not supported by the CT mel kernel")
    if not signal.is_cuda:
        return ct_mel_plain(signal, cfg)
    if signal.dtype != torch.float32:
        raise TypeError(f"the CT mel kernel takes float32, got {signal.dtype}")
    n, hop, m = cfg.fft_points, cfg.frame_step, cfg.num_filters
    x = _center(signal, cfg)
    lead, t = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, t).contiguous()
    count = max(1 + (t - n) // hop, 0)
    out = torch.empty((x.shape[0], count, m), dtype=torch.float32, device=x.device)
    if count == 0 or x.shape[0] == 0:
        return out.reshape(lead + out.shape[1:])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = _launch(lib, x, cfg, out, torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "ct_mel_launch")
    ct_mel.launches += 1
    return out.reshape(lead + out.shape[1:])


ct_mel.launches = 0
