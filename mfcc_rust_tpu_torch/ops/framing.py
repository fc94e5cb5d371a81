"""Signal framing and pre-emphasis (port of ``mfcc_rust_tpu.ops.framing``).

All functions take arbitrary leading batch dims.  Framing is a strided view
(``Tensor.unfold``) in place of the reference's index gather; frame counts
follow speechpy's rules exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from ..config import FeatureConfig


def preemphasis(signal: torch.Tensor, shift: int = 1, cof: float = 0.98) -> torch.Tensor:
    """``signal - cof * roll(signal, shift)`` with np.roll wrap-around
    semantics: the first sample takes the last one."""
    return signal - cof * torch.roll(signal, shift, dims=-1)


def pad_signal(signal: torch.Tensor, left: int, right: int,
               mode: str = "reflect", dim: int = -1) -> torch.Tensor:
    """``np.pad`` of axis ``dim`` (the last by default) by (left, right) in
    ``mode`` ("constant", "reflect", "symmetric", "edge" or "wrap"), at any
    length.  A "reflect" pad whose two sides are both shorter than the axis
    is one ``torch.nn.functional.pad`` launch on a (rows, 1, T) view.  A pad
    as long as the axis or longer reflects again and again, as numpy does
    (``torch.nn.functional.pad`` raises there), so each output sample of it,
    and of the other modes, is read through a folded index
    (:func:`pad_index`); a 1-sample axis reflects to itself."""
    if left == 0 and right == 0:
        return signal
    if dim not in (-1, signal.ndim - 1):
        return pad_signal(signal.movedim(dim, -1), left, right, mode).movedim(-1, dim)
    if mode == "constant":
        return tF.pad(signal, (left, right))
    t = signal.shape[-1]
    if mode == "reflect" and left < t and right < t:
        return tF.pad(signal.reshape(-1, 1, t), (left, right),
                      mode="reflect").view(signal.shape[:-1] + (left + t + right,))
    return signal.index_select(-1, pad_index(-left, t + right, t, mode, signal.device))


def center_pad(signal: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """The librosa centre pad of a (..., T) signal: ``cfg.fft_points // 2``
    samples on each side in ``cfg.pad_mode`` when ``cfg.center``, else
    ``signal`` itself.  Raises for an empty signal when centred."""
    if not cfg.center:
        return signal
    half = cfg.fft_points // 2
    return pad_signal(signal, half, half, cfg.pad_mode)


def pad_index(start: int, stop: int, t: int, mode: str, device=None) -> torch.Tensor:
    """The samples that positions ``start .. stop - 1`` of an axis of ``t``
    samples read once it is padded in ``mode`` (not "constant"), position 0
    being its first sample: numpy's folds, as :func:`pad_signal` reads
    them."""
    if t == 0:
        raise ValueError(f"cannot {mode}-pad an empty axis")
    idx = torch.arange(start, stop, device=device)
    if mode == "reflect":
        if t == 1:
            return torch.zeros_like(idx)
        period = 2 * (t - 1)
        m = idx % period
        return torch.where(m >= t, period - m, m)
    if mode == "symmetric":
        m = idx % (2 * t)
        return torch.where(m >= t, 2 * t - 1 - m, m)
    if mode == "edge":
        return idx.clamp(0, t - 1)
    if mode == "wrap":
        return idx % t
    raise ValueError(f"unsupported pad mode {mode!r}")


def speechpy_frame_counts(
    length: int, frame_len: int, frame_step: int, zero_padding: bool
) -> Tuple[int, int]:
    """(num_frames, effective_signal_len) with speechpy's count rules:
    ``ceil((L-fl)/step)`` + zero pad, or ``floor((L-fl)/step)`` + truncate
    (which drops the final otherwise-valid frame, speechpy issue #34)."""
    if length < frame_len:
        # too short for one frame: zero frames, an empty feature matrix
        return 0, 0
    if zero_padding:
        num = int(math.ceil((length - frame_len) / frame_step))
        eff = num * frame_step + frame_len
    else:
        num = int(math.floor((length - frame_len) / frame_step))
        eff = (num - 1) * frame_step + frame_len
    return num, eff


def frame_indices(num_frames: int, frame_len: int, frame_step: int) -> np.ndarray:
    """Static (num_frames, frame_len) int32 gather index matrix: row f holds
    the sample indices of frame f (the reference's gather; ``frame_signal``
    takes the same samples as a strided view)."""
    return (
        np.arange(num_frames, dtype=np.int32)[:, None] * frame_step
        + np.arange(frame_len, dtype=np.int32)[None, :]
    )


def frame_signal(
    signal: torch.Tensor, frame_len: int, frame_step: int, num_frames: int
) -> torch.Tensor:
    """Overlapping windows: (..., T) -> (..., num_frames, frame_len)."""
    if num_frames <= 0:
        return signal.new_zeros(signal.shape[:-1] + (0, frame_len))
    return signal.unfold(-1, frame_len, frame_step)[..., :num_frames, :]


def stack_frames(
    signal: torch.Tensor,
    sample_rate: int,
    frame_length: float = 0.020,
    frame_stride: float = 0.020,
    window: Optional[torch.Tensor] = None,
    zero_padding: bool = True,
) -> torch.Tensor:
    """speechpy-compatible framing: (..., T) -> (..., F, frame_len)."""
    frame_len = int(round(sample_rate * frame_length))
    frame_step = int(round(sample_rate * frame_stride))
    return stack_frames_samples(signal, frame_len, frame_step, window, zero_padding)


def stack_frames_samples(
    signal: torch.Tensor,
    frame_len: int,
    frame_step: int,
    window: Optional[torch.Tensor] = None,
    zero_padding: bool = True,
) -> torch.Tensor:
    length = signal.shape[-1]
    num, eff = speechpy_frame_counts(length, frame_len, frame_step, zero_padding)
    if eff > length:
        signal = tF.pad(signal, (0, eff - length))
    frames = frame_signal(signal, frame_len, frame_step, num)
    if window is not None:
        frames = frames * window
    return frames
