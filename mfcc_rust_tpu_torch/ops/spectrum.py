"""rFFT power spectra (port of ``mfcc_rust_tpu.ops.spectrum``).

``matmul`` computes the real DFT as two products against the cos/-sin
matrices of :func:`..constants.rdft_matrices`; ``ct`` as the two-stage
Cooley-Tukey products of :mod:`.fft`; ``fft`` uses ``torch.fft.rfft``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FeatureConfig, fp32_matmul
from ..constants import bundle_tensor
from .fft import good_factorization


def resolve_fft_impl(cfg: FeatureConfig) -> str:
    if cfg.fft_impl != "auto":
        return cfg.fft_impl
    if cfg.fft_points <= 1024:
        return "matmul"
    return "ct" if good_factorization(cfg.fft_points) else "fft"


def zero_handling(x: torch.Tensor, eps: Optional[float] = None) -> torch.Tensor:
    """Replace exact zeros with machine epsilon before logs (f32 epsilon,
    as the reference does, whatever the dtype)."""
    if eps is None:
        eps = float(np.finfo(np.float32).eps)
    return torch.where(x == 0.0, torch.full_like(x, eps), x)


def rdft(
    frames: torch.Tensor, cfg: FeatureConfig, windowed: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real DFT of (..., F, L) frames -> (real, imag) each (..., F, K),
    K = fft_points//2+1.  Frames shorter than fft_points are implicitly
    zero-padded."""
    impl = resolve_fft_impl(cfg)
    n = cfg.fft_points
    if impl == "matmul":
        c, s = bundle_tensor(cfg, "dft_windowed" if windowed else "dft",
                             frames.device, frames.dtype)
        L = frames.shape[-1]
        if L > c.shape[0]:
            # rfft(x, n) truncates inputs longer than n
            frames = frames[..., : c.shape[0]]
        elif L < c.shape[0]:
            raise ValueError(
                f"frame length {L} does not match DFT constant rows {c.shape[0]}"
            )
        with fp32_matmul():
            return torch.matmul(frames, c), torch.matmul(frames, s)
    if windowed:
        w = bundle_tensor(cfg, "window", frames.device, frames.dtype)
        frames = frames * w[: frames.shape[-1]]
    if impl == "ct":
        from .fft import rfft_ct

        return rfft_ct(frames, n)
    if frames.numel() == 0:  # no frames: the CPU FFT raises on an empty batch
        z = frames.new_zeros(frames.shape[:-1] + (n // 2 + 1,))
        return z, z
    spec = torch.fft.rfft(frames, n=n, dim=-1)
    return spec.real.to(frames.dtype), spec.imag.to(frames.dtype)


def fft_spectrum(
    frames: torch.Tensor, cfg: FeatureConfig, windowed: bool = False
) -> torch.Tensor:
    """rFFT magnitude per frame."""
    xr, xi = rdft(frames, cfg, windowed)
    return torch.sqrt(xr * xr + xi * xi)


def power_spectrum(
    frames: torch.Tensor, cfg: FeatureConfig, windowed: bool = False
) -> torch.Tensor:
    """speechpy power spectrum ``|X|^2 / fft_points``."""
    xr, xi = rdft(frames, cfg, windowed)
    return (xr * xr + xi * xi) * (1.0 / cfg.fft_points)


def log_power_spectrum(
    frames: torch.Tensor, cfg: FeatureConfig, normalize: bool = True
) -> torch.Tensor:
    """10*log10 power with a -200 dB floor; with ``normalize`` the maximum of
    the whole array (not of each row) is subtracted."""
    ps = power_spectrum(frames, cfg)
    lps = torch.where(ps > 1e-20, 10.0 * torch.log10(torch.clamp_min(ps, 1e-30)),
                      torch.full_like(ps, -200.0))
    if normalize:
        lps = lps - torch.amax(lps)
    return lps


def power_to_db(s: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0, per_spectrogram: bool = True) -> torch.Tensor:
    """librosa-compatible power to dB with the top_db clamp.  With
    ``per_spectrogram`` (the default) the top_db reference maximum is taken
    over the trailing two axes when ``s.ndim > 2``, so each spectrogram of a
    batch is clamped against its own maximum, as librosa applied per
    utterance; False takes librosa's literal whole-array maximum.  An empty
    spectrogram (no frames) comes back empty."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(s, amin))
    log_spec = log_spec - 10.0 * math.log10(max(amin, ref))
    if top_db is not None and log_spec.numel():
        if per_spectrogram and s.ndim > 2:
            ref_max = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
        else:
            ref_max = torch.amax(log_spec)
        log_spec = torch.maximum(log_spec, ref_max - top_db)
    return log_spec
