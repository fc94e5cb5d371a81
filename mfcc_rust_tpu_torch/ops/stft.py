"""Short-time Fourier transforms (port of ``mfcc_rust_tpu.ops.stft``).

* :func:`stft_vorbis_power` / :func:`stft_vorbis` — the reference's
  streaming ("DFN") STFT computed in one batch: the same output as a freshly
  reset frame-by-frame stream, the ``n_pad`` warm-up frames dropped and
  ``n_pad`` never-written zero rows at the tail.
* :func:`streaming_init` / :func:`streaming_step` / :func:`stft_streaming`
  — the same STFT with an explicit carry (the last ``fft_points - hop``
  samples): one frame out per hop, resettable, no state across sessions.
* :func:`stft_framed` — the framed family (speechpy and librosa presets:
  optional centring, any window, any hop).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as tF

from ..config import FeatureConfig
from ..utils.device import resolve_device
from . import framing
from .spectrum import rdft


# ------------------------------------------------------------- vorbis batch --
def _vorbis_frames(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T) -> (..., ceil(T/hop), fft_points): the stream's frames, the
    zero analysis memory (fft_points - hop zeros) prepended and the last
    partial chunk zero-padded."""
    hop = cfg.stream_hop
    n = cfg.fft_points
    t = signal.shape[-1]
    n_chunks = int(math.ceil(t / hop))
    x = tF.pad(signal, (n - hop, n_chunks * hop - t))
    return framing.frame_signal(x, n, hop, n_chunks)


def stft_vorbis_power(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T) -> (..., T', K) power, T' = ceil(T/hop): ``|stft1|^2`` of a
    fresh reference stream."""
    xr, xi = rdft(_vorbis_frames(signal, cfg), cfg, windowed=True)
    return _apply_npad_layout((xr * xr + xi * xi) * (cfg.wnorm * cfg.wnorm), cfg)


def stft_vorbis(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Complex form of :func:`stft_vorbis_power`, scaled by wnorm."""
    xr, xi = rdft(_vorbis_frames(signal, cfg), cfg, windowed=True)
    return _apply_npad_layout(torch.complex(xr, xi) * cfg.wnorm, cfg)


def _apply_npad_layout(frames_out: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T', D): drop the first ``n_pad`` rows and append ``n_pad`` zero
    rows, the reference's output layout."""
    n_pad = cfg.stream_n_pad
    if n_pad == 0:
        return frames_out
    zeros = frames_out.new_zeros(frames_out.shape[:-2] + (n_pad, frames_out.shape[-1]))
    return torch.cat([frames_out[..., n_pad:, :], zeros], dim=-2)


# ---------------------------------------------------------------- streaming --
def streaming_init(cfg: FeatureConfig, batch_shape: Tuple[int, ...] = (),
                   dtype: Optional[torch.dtype] = None, device=None) -> torch.Tensor:
    """A fresh carry: ``fft_points - hop`` zeros (the reference's analysis
    memory, made explicit), on ``device`` (``None`` means CUDA)."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    return torch.zeros(tuple(batch_shape) + (cfg.stream_mem,), dtype=dtype,
                       device=resolve_device(device))


def streaming_step(carry: torch.Tensor, chunk: torch.Tensor,
                   cfg: FeatureConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the analysis recurrence: ``buf = concat(carry, chunk)``,
    its windowed real DFT's power times wnorm², and the carry ``buf[hop:]``.
    Returns (carry', power (..., K))."""
    full = torch.cat([carry, chunk], dim=-1)
    xr, xi = rdft(full[..., None, :], cfg, windowed=True)
    power = (xr * xr + xi * xi)[..., 0, :] * (cfg.wnorm * cfg.wnorm)
    return full[..., cfg.stream_hop:], power


def stft_streaming(signal: torch.Tensor, cfg: FeatureConfig,
                   carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`streaming_step` over a (..., T) signal, T a multiple of the
    hop: returns (carry', power (..., T/hop, K)), every frame computed (the
    session drops the warm-up, see ``models.StreamingExtractor``).

    The reference scans one hop at a time.  Here the carry and the signal
    are joined once, framed into T/hop windows of fft_points at every hop,
    and transformed by one windowed DFT: the same frames, and the new carry
    is the last ``fft_points - hop`` samples."""
    hop = cfg.stream_hop
    t = signal.shape[-1]
    if t % hop != 0:
        raise ValueError(f"streaming signal length {t} must be a multiple of hop {hop}")
    if carry is None:
        carry = streaming_init(cfg, signal.shape[:-1], signal.dtype, signal.device)
    full = torch.cat([carry, signal], dim=-1)
    frames = framing.frame_signal(full, cfg.fft_points, hop, t // hop)
    xr, xi = rdft(frames, cfg, windowed=True)
    power = (xr * xr + xi * xi) * (cfg.wnorm * cfg.wnorm)
    return full[..., full.shape[-1] - cfg.stream_mem:], power


# ------------------------------------------------------------------- framed --
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
