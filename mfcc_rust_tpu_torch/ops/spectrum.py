"""rFFT power spectra (port of ``mfcc_rust_tpu.ops.spectrum``).

``matmul`` computes the real DFT as two products against the cos/-sin
matrices of :func:`..constants.rdft_matrices`; ``fft`` uses
``torch.fft.rfft``.  The Cooley-Tukey lowering (``ct``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FeatureConfig, fp32_matmul
from ..constants import bundle_tensor


def good_factorization(n: int) -> Optional[Tuple[int, int]]:
    """N1·N2 = n for the reference's two-stage Cooley-Tukey lowering (the
    JAX package's ``ops/fft.py``), used here only to resolve ``"auto"`` the
    way the reference does."""
    if n % 128 == 0 and n // 128 >= 8:
        return (128, n // 128)
    best = None
    for n2 in range(int(math.isqrt(n)), 1, -1):
        if n % n2 == 0:
            n1 = n // n2
            if n1 / n2 <= 8:
                best = (n1, n2)
            break
    return best


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
    if impl == "ct":
        raise NotImplementedError(
            "fft_impl='ct' (Cooley-Tukey, fft_points > 1024) is not ported "
            "yet: ROADMAP.md Queue 1 item 7; pass fft_impl='fft'"
        )
    if windowed:
        w = bundle_tensor(cfg, "window", frames.device, frames.dtype)
        frames = frames * w[: frames.shape[-1]]
    spec = torch.fft.rfft(frames, n=n, dim=-1)
    return spec.real.to(frames.dtype), spec.imag.to(frames.dtype)


def power_spectrum(
    frames: torch.Tensor, cfg: FeatureConfig, windowed: bool = False
) -> torch.Tensor:
    """speechpy power spectrum ``|X|^2 / fft_points``."""
    xr, xi = rdft(frames, cfg, windowed)
    return (xr * xr + xi * xi) * (1.0 / cfg.fft_points)
