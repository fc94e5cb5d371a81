"""Signal framing and pre-emphasis (port of ``mfcc_rust_tpu.ops.framing``).

All functions take arbitrary leading batch dims.  Framing is a strided view
(``Tensor.unfold``) in place of the reference's index gather; frame counts
follow speechpy's rules exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as tF


def preemphasis(signal: torch.Tensor, shift: int = 1, cof: float = 0.98) -> torch.Tensor:
    """``signal - cof * roll(signal, shift)`` with np.roll wrap-around
    semantics: the first sample takes the last one."""
    return signal - cof * torch.roll(signal, shift, dims=-1)


def pad_signal(signal: torch.Tensor, left: int, right: int,
               mode: str = "reflect", dim: int = -1) -> torch.Tensor:
    """``np.pad`` of axis ``dim`` (the last by default) by (left, right) in
    ``mode`` ("constant", "reflect", "symmetric", "edge" or "wrap"), at any
    length.  A pad as long as the axis or longer reflects again and again,
    as numpy does (``torch.nn.functional.pad`` raises there), so each output
    sample is read through a folded index; a 1-sample axis reflects to
    itself."""
    if left == 0 and right == 0:
        return signal
    if dim not in (-1, signal.ndim - 1):
        return pad_signal(signal.movedim(dim, -1), left, right, mode).movedim(-1, dim)
    if mode == "constant":
        return tF.pad(signal, (left, right))
    t = signal.shape[-1]
    if t == 0:
        raise ValueError(f"cannot {mode}-pad an empty axis")
    idx = torch.arange(-left, t + right, device=signal.device)
    if mode == "reflect":
        if t == 1:
            idx = torch.zeros_like(idx)
        else:
            period = 2 * (t - 1)
            m = idx % period
            idx = torch.where(m >= t, period - m, m)
    elif mode == "symmetric":
        m = idx % (2 * t)
        idx = torch.where(m >= t, 2 * t - 1 - m, m)
    elif mode == "edge":
        idx = idx.clamp(0, t - 1)
    elif mode == "wrap":
        idx = idx % t
    else:
        raise ValueError(f"unsupported pad mode {mode!r}")
    return signal.index_select(-1, idx)


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
