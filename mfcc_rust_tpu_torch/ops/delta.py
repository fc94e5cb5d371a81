"""Temporal-derivative (delta) features (port of ``mfcc_rust_tpu.ops.delta``).

* :func:`derivative_extraction` — speechpy parity, both quirks kept: the
  derivative runs along the *feature* axis (last), and only the forward term
  is weighted by the window index.
* :func:`delta` — the symmetric regression delta along the *time* axis (-2).
* :func:`delta_librosa` — librosa's Savitzky-Golay derivative (scipy
  ``savgol_filter``, ``mode="interp"``), frames last.

Edges are padded by :func:`.framing.pad_signal` in ``"edge"`` mode, which
takes any shape (``torch.nn.functional.pad``'s replicate mode does not).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import fp32_matmul
from .framing import pad_signal


def derivative_extraction(feat: torch.Tensor, delta_windows: int = 2) -> torch.Tensor:
    """speechpy deltas along the last (feature) axis: edge-pad, then
    ``sum_r (r * x[+r] - x[-r]) / sum_r 2 r^2``."""
    cols = feat.shape[-1]
    features = pad_signal(feat, delta_windows, delta_windows, "edge")
    dif = torch.zeros_like(feat)
    scale = 0.0
    offset = delta_windows
    for rng in range(1, delta_windows + 1):
        dif = dif + (rng * features[..., offset + rng : offset + rng + cols]
                     - features[..., offset - rng : offset - rng + cols])
        scale += 2.0 * rng**2
    return dif / scale


def extract_derivative_feature(feature: torch.Tensor) -> torch.Tensor:
    """Static + delta + delta-delta cube: (..., T, M) -> (..., T, M, 3)."""
    d1 = derivative_extraction(feature, 2)
    d2 = derivative_extraction(d1, 2)
    return torch.stack([feature, d1, d2], dim=-1)


def delta(feat: torch.Tensor, width: int = 2) -> torch.Tensor:
    """Symmetric delta along the time axis (-2), edge-padded:
    ``sum_r r*(x[t+r]-x[t-r]) / (2*sum_r r^2)``."""
    rows = feat.shape[-2]
    f = pad_signal(feat, width, width, "edge", dim=-2)
    num = torch.zeros_like(feat)
    denom = 0.0
    for r in range(1, width + 1):
        num = num + r * (f[..., width + r : width + r + rows, :]
                         - f[..., width - r : width - r + rows, :])
        denom += 2.0 * r**2
    return num / denom


@functools.lru_cache(maxsize=32)
def _savgol_operator(width: int, polyorder: int, deriv: int) -> np.ndarray:
    """float64 Savitzky-Golay operator, (width, width): row p maps a window
    to the deriv-th derivative of its least-squares polynomial fit at window
    position p.  Row ``width//2`` is the interior kernel; the first and last
    half rows are the ``mode="interp"`` edges."""
    a = np.vander(np.arange(width, dtype=np.float64), polyorder + 1, increasing=True)
    coef = np.linalg.pinv(a)  # (polyorder+1, width): window -> poly coeffs
    rows = np.zeros((width, polyorder + 1))
    p = np.arange(width, dtype=np.float64)
    for j in range(deriv, polyorder + 1):
        rows[:, j] = (math.factorial(j) / math.factorial(j - deriv)) * p ** (j - deriv)
    return rows @ coef


def delta_librosa(feat: torch.Tensor, width: int = 9, order: int = 1,
                  axis: int = -1) -> torch.Tensor:
    """librosa.feature.delta: the Savitzky-Golay derivative (polyorder =
    deriv = order, ``mode="interp"``) along ``axis``.  Needs an odd
    ``width`` >= 3, 0 < order < width, and at least ``width`` frames."""
    if width < 3 or width % 2 == 0:
        raise ValueError(f"width must be odd and >= 3, got {width}")
    if order <= 0:
        raise ValueError(f"order must be positive, got {order}")
    if order >= width:
        raise ValueError(f"order ({order}) must be less than width ({width})")
    t = feat.shape[axis]
    if t < width:
        raise ValueError(f"need at least width={width} frames, got {t}")
    x = feat.movedim(axis, -1)
    d = torch.as_tensor(_savgol_operator(width, order, order), dtype=x.dtype, device=x.device)
    h = width // 2
    with fp32_matmul():
        # interior: every width-window against the centre row, one product
        y_int = torch.matmul(x.unfold(-1, width, 1), d[h])
        # edges: the polynomial fit of the first and last window
        y_left = torch.matmul(x[..., :width], d[:h].T)
        y_right = torch.matmul(x[..., -width:], d[h + 1 :].T)
    return torch.cat([y_left, y_int, y_right], dim=-1).movedim(-1, axis)
