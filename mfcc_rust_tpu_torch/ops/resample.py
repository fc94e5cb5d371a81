"""Polyphase sample-rate conversion as one chunk-GEMM (port of
``mfcc_rust_tpu.ops.resample``; scipy ``resample_poly`` semantics with the
``("kaiser", 5.0)`` window).

For a ratio up/down (coprime after gcd reduction) and the centred Kaiser
sinc lowpass ``h``, ``y[m] = sum_j h[j] * x_up[m*down + half - j]`` over the
zero-stuffed ``x_up``.  Group outputs by phase, ``m = q*up + m0``: each phase's
taps meet a window of input that moves by ``down`` samples per q.  Placing
every phase's reversed taps at its offset in one (r*down, up) wall makes the
resampler one product of the overlapping ``r*down``-sample windows, taken
every ``down`` samples, with the wall: (..., Q, r*down) @ (r*down, up) ->
(..., Q, up), which flattens row-major to the output stream.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from ..config import fp32_matmul
from ..constants import tensor_cache


def kaiser_lowpass(up: int, down: int, beta: float = 5.0,
                   half_factor: int = 10) -> np.ndarray:
    """The prototype filter (float64): Kaiser-windowed sinc, cutoff
    1/max(up, down) of the upsampled Nyquist, unit DC gain, times ``up``;
    2*half+1 taps, half = half_factor * max(up, down)."""
    max_rate = max(up, down)
    half = half_factor * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = np.sinc(n / max_rate) / max_rate
    h *= np.kaiser(2 * half + 1, beta)
    h /= h.sum()
    return h * up


@functools.lru_cache(maxsize=32)
def _polyphase_wall(up: int, down: int, beta: float,
                    half_factor: int) -> Tuple[np.ndarray, int, int]:
    """The (r*down, up) float64 wall.  Returns (wall, imin, r): output
    ``q*up + m0 = sum_w x[imin + q*down + w] * wall[w, m0]`` (x indexed
    before padding; a negative imin is a left zero pad)."""
    h = kaiser_lowpass(up, down, beta, half_factor)
    half = (len(h) - 1) // 2
    tops, phase_taps = [], []
    for m0 in range(up):  # phase m0: taps h[c + u*up] meet input i_top - u
        c = (m0 * down + half) % up
        tops.append((m0 * down + half - c) // up)
        phase_taps.append(h[c::up])
    imin = min(t - (len(p) - 1) for t, p in zip(tops, phase_taps))
    r = math.ceil((max(tops) - imin + 1) / down)
    wall = np.zeros((r * down, up))
    for m0, (i_top, taps) in enumerate(zip(tops, phase_taps)):
        for u, tap in enumerate(taps):
            wall[i_top - u - imin, m0] = tap
    return wall, imin, r


@tensor_cache(maxsize=64)
def _wall_tensor(up: int, down: int, beta: float, half_factor: int,
                 device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    wall, _, _ = _polyphase_wall(up, down, beta, half_factor)
    return torch.as_tensor(wall, dtype=dtype, device=device)


def resample_poly(signal: torch.Tensor, up: int, down: int, precision: str = "highest",
                  beta: float = 5.0, half_factor: int = 10) -> torch.Tensor:
    """Resample (..., T) along the last axis by up/down: output length
    ceil(T*up/down).  ``up == down`` after gcd reduction returns the input;
    an empty signal gives an empty result.  ``precision`` is the reference's
    argument, kept so its calls carry over: the product is IEEE FP32
    (:func:`..config.fp32_matmul`) whatever it says."""
    if up <= 0 or down <= 0:
        raise ValueError(f"up/down must be positive, got {up}/{down}")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down:
        return signal
    t = signal.shape[-1]
    if t == 0:  # no output rows: the windows below need r*down samples
        return signal.new_zeros(signal.shape)
    n_out = -(-t * up // down)
    q = -(-n_out // up)  # output rows of `up` samples
    _, imin, r = _polyphase_wall(up, down, beta, half_factor)
    wall = _wall_tensor(up, down, beta, half_factor, signal.device, signal.dtype)
    # x'[k] = x[k + imin], zero outside; the product needs (q + r - 1)*down
    need = (q + r - 1) * down
    left = max(0, -imin)
    right = max(0, need - (t + left - max(0, imin)))
    x = tF.pad(signal, (left, right))[..., max(0, imin):][..., :need]
    with fp32_matmul():
        y = torch.matmul(x.unfold(-1, r * down, down), wall)  # (..., q, up)
    return y.reshape(y.shape[:-2] + (q * up,))[..., :n_out]


def resample(signal: torch.Tensor, orig_sr: int, target_sr: int,
             precision: str = "highest") -> torch.Tensor:
    """Resample (..., T) audio from orig_sr to target_sr (both in Hz)."""
    if orig_sr <= 0 or target_sr <= 0:
        raise ValueError(f"sample rates must be positive, got {orig_sr} -> {target_sr}")
    return resample_poly(signal, target_sr, orig_sr, precision)
