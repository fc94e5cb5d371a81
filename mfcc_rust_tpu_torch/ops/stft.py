"""Framed short-time Fourier transforms (port of the framed part of
``mfcc_rust_tpu.ops.stft``): centred librosa framing or speechpy framing,
any window, any hop."""

from __future__ import annotations

import torch

from ..config import FeatureConfig
from . import framing
from .spectrum import rdft


def librosa_frame_count(length: int, n_fft: int, hop: int, center: bool) -> int:
    """Frames of a librosa STFT of ``length`` samples, 0 when the (padded)
    signal is shorter than one frame: the entry points slice the bucketed
    result to this count, and a negative count would keep bucket frames."""
    if center:
        length = length + 2 * (n_fft // 2)
    return max(1 + (length - n_fft) // hop, 0)


def stft_framed(
    signal: torch.Tensor,
    cfg: FeatureConfig,
    framing_style: str = "librosa",
    return_power: bool = True,
) -> torch.Tensor:
    """Framed, windowed STFT: (..., T) -> (..., F, K).

    ``framing_style``:
      * ``librosa`` — centre pad in ``cfg.pad_mode`` (when ``cfg.center``),
        frames of fft_points, count ``1 + (T_padded - n_fft)//hop``.
      * ``speechpy_nopad`` / ``speechpy_pad`` — speechpy frame counts with
        frames of cfg.frame_size right-zero-padded into the DFT.

    Returns the power ``|X|**cfg.power`` or, with ``return_power=False``,
    the complex spectrum."""
    n = cfg.fft_points
    hop = cfg.frame_step
    if framing_style == "librosa":
        if cfg.center:
            signal = framing.pad_signal(signal, n // 2, n // 2, cfg.pad_mode)
        count = 1 + (signal.shape[-1] - n) // hop
        frames = framing.frame_signal(signal, n, hop, count)
    elif framing_style in ("speechpy_nopad", "speechpy_pad"):
        frames = framing.stack_frames_samples(
            signal, cfg.frame_size, hop, window=None,
            zero_padding=framing_style == "speechpy_pad",
        )
    else:
        raise ValueError(f"unknown framing_style {framing_style!r}")
    xr, xi = rdft(frames, cfg, windowed=True)
    if return_power:
        power = xr * xr + xi * xi
        if cfg.power != 2.0:
            power = power ** (cfg.power / 2.0)
        return power
    return torch.complex(xr, xi)
