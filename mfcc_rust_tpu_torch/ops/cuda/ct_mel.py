"""librosa mel spectrogram by a Cooley-Tukey FFT: the CUDA kernel
``ct_mel.cu``, its binding, and its plain PyTorch version.

Replaces the TPU kernel ``mfcc_rust_tpu/ops/pallas/ct_mel.py``
(``ct_mel_pallas``): window, real FFT, |X|² and the mel projection in one
launch that reads the (centre-padded) signal and writes only the
(B, F, n_mels) answer, frame-major.  The kernel takes its own
factorization, a radix-4 Stockham FFT (see the note in the .cu source).

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
from ...constants import constant_bundle
from ..fft import good_factorization
from ..framing import pad_signal

KERNEL = "ct_mel"

# ct_mel.cu: kMaxSmem
_MAX_SMEM = 232448


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
    """Dynamic shared memory of one block (``Layout`` in the .cu): two
    buffers of n/2 complex values per frame, then the nnz packed filterbank
    weights."""
    round4 = lambda x: -(-x // 4) * 4
    return 4 * (g * 2 * round4(n) + round4(nnz))


def frames_per_block(n: int, nnz: int) -> int:
    """G, a power of two (each frame of a block gets 256/G threads): the
    most frames (<= 8) for which three blocks share an SM, else 1 (0 when
    even one frame does not fit)."""
    for g in (8, 4, 2, 1):
        if smem_bytes(n, g, nnz) <= _MAX_SMEM // 3:
            return g
    return 1 if smem_bytes(n, 1, nnz) <= _MAX_SMEM else 0


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


@functools.lru_cache(maxsize=16)
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

    lib = library(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ct_mel_launch.argtypes = [p, p, p, p, p, p, i, ctypes.c_longlong] + [i] * 10 + [p]
    lib.ct_mel_launch.restype = i
    lib.ct_mel_smem_bytes.argtypes = [i, i, i]
    lib.ct_mel_smem_bytes.restype = ctypes.c_longlong
    lib.ct_mel_error_string.argtypes = [i]
    lib.ct_mel_error_string.restype = ctypes.c_char_p
    return lib


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
    m_odd, n4, has2 = fft_plan(n)
    c = _kernel_tensors(cfg, x.device)
    kmax, nnz = _kernel_constants(cfg)[4], c["wpack"].numel()
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ct_mel_launch(
            x.data_ptr(), c["win"].data_ptr(), c["tw"].data_ptr(), c["wpack"].data_ptr(),
            c["ranges"].data_ptr(), out.data_ptr(), x.shape[0], t, count, hop, n, m_odd, n4,
            has2, kmax, nnz, m, frames_per_block(n, nnz),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"ct_mel_launch failed: {lib.ct_mel_error_string(err).decode()}")
    ct_mel.launches += 1
    return out.reshape(lead + out.shape[1:])


ct_mel.launches = 0
