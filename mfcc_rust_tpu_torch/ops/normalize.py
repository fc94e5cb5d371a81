"""Cepstral mean and variance normalization: global, sliding-window and
corpus (port of ``mfcc_rust_tpu.ops.normalize``).

The sliding window is a cumulative-sum moving average (O(T), not
O(T·win)).  Its symmetric padding goes through :func:`.framing.pad_signal`,
which reflects again and again when the pad is longer than the clip, as
numpy does: the default 301-frame window pads 150 frames a side, more than a
short clip holds.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as tF

from .framing import pad_signal

EPS = 2.0 ** -30  # the reference's epsilon


def cmvn(vec: torch.Tensor, variance_normalization: bool = False) -> torch.Tensor:
    """Per-feature mean (and optionally variance) normalization over the
    observation axis (-2).  The mean takes two passes (the mean of the
    residuals is added back), so a float32 feature with a large mean does
    not inherit the rounding of a single T·mean sum."""
    m1 = torch.mean(vec, dim=-2, keepdim=True)
    mean = m1 + torch.mean(vec - m1, dim=-2, keepdim=True)
    centered = vec - mean
    if variance_normalization:
        stdev = torch.sqrt(torch.mean(centered * centered, dim=-2, keepdim=True))
        return centered / (stdev + EPS)
    return centered


def _windowed_moments(x: torch.Tensor, win_size: int, want_sq: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sliding (mean, E[x^2]) of each row over its symmetric-padded window,
    by cumulative sums: (..., T, D) -> two (..., T, D).  The sums run along
    the last, contiguous axis of the (..., D, T) transpose: a scan along
    an outer axis gives the card one thread a column (B·D of them) walking
    T rows."""
    pad_size = (win_size - 1) // 2
    xp = pad_signal(x.transpose(-1, -2), pad_size, pad_size, "symmetric")
    t = x.shape[-2]

    def window_mean(v):
        cs = tF.pad(torch.cumsum(v, dim=-1), (1, 0))
        return ((cs[..., win_size : win_size + t] - cs[..., :t]) / win_size).transpose(-1, -2)

    mean = window_mean(xp)
    return mean, (window_mean(xp * xp) if want_sq else None)


def cmvnw(vec: torch.Tensor, win_size: int = 301,
          variance_normalization: bool = False) -> torch.Tensor:
    """Sliding-window CMVN: each row less the mean of its window, and with
    ``variance_normalization`` over the population std (ddof 0) of the
    window of centred rows.  An even window raises.

    The cumulative sums run on data shifted by the global per-feature mean:
    a float32 running sum of raw large-mean features grows until rounding
    swamps the window means.  The shift cancels in the output.

    A window of one row is its own mean, so the result is exact zeros, as
    the float64 speechpy oracle gives.  The cumulative-sum difference would
    leave a float32 residue there, which variance normalization divides by
    a std near ``EPS`` (the reference returns values up to ~1e3)."""
    if win_size % 2 != 1:
        raise ValueError("Windows size must be odd!")
    if win_size == 1:
        return torch.zeros_like(vec)
    v0 = vec - torch.mean(vec, dim=-2, keepdim=True)
    mean0, _ = _windowed_moments(v0, win_size, want_sq=False)
    centered = v0 - mean0
    if not variance_normalization:
        return centered
    cmean, cmean2 = _windowed_moments(centered, win_size)
    var = torch.clamp_min(cmean2 - cmean * cmean, 0.0)
    return centered / (torch.sqrt(var) + EPS)


def masked_moments(feats: torch.Tensor, mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum, sum_sq, count) over every axis of (..., T, D) but the last,
    counting only rows where the (..., T) ``mask`` is true.  Returns (D,),
    (D,) and a scalar in the features' dtype."""
    red = tuple(range(feats.ndim - 1))
    if mask is None:
        n = feats.new_tensor(float(math.prod(feats.shape[:-1])))
        return torch.sum(feats, dim=red), torch.sum(feats * feats, dim=red), n
    m = mask[..., None].to(feats.dtype)
    return (torch.sum(feats * m, dim=red), torch.sum(feats * feats * m, dim=red),
            torch.sum(m))


def apply_corpus_cmvn(feats: torch.Tensor, moments,
                      variance_normalization: bool = True) -> torch.Tensor:
    """Normalize by corpus moments: any object with ``.m2``, ``.mean`` and
    ``.std`` (a Welford accumulator, whose variance has no float32
    cancellation), or the (sum, sum_sq, count) triple of
    :func:`masked_moments`."""
    if hasattr(moments, "m2"):
        centered = feats - moments.mean
        if not variance_normalization:
            return centered
        return centered / (moments.std + EPS)
    s, ss, n = moments
    mean = s / n
    centered = feats - mean
    if not variance_normalization:
        return centered
    var = torch.clamp_min(ss / n - mean * mean, 0.0)
    return centered / (torch.sqrt(var) + EPS)
