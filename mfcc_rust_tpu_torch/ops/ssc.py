"""Spectral subband centroids (port of ``mfcc_rust_tpu.ops.ssc``): per mel
band, ``sum(freq * power) / sum(power)`` with bin centre frequencies
``linspace(1, fs/2, K)``, speechpy framing and filterbanks."""

from __future__ import annotations

import numpy as np
import torch

from ..config import FeatureConfig, fp32_matmul
from .mel import filterbank_matrix

# SSC replaces a zero power bin by the float64 epsilon, whatever the dtype
SSC_EPS = float(np.finfo(np.float64).eps)


def ssc_ramp(cfg: FeatureConfig) -> np.ndarray:
    """(K,) float64 bin centre frequencies in Hz."""
    return np.linspace(1.0, cfg.sample_rate / 2.0, cfg.freq_size)


def ssc_from_power(power: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., F, K) power spectrum -> (..., F, M) subband centroids in Hz."""
    power = torch.where(power == 0.0, torch.full_like(power, SSC_EPS), power)
    fb = filterbank_matrix(cfg, power.dtype, power.device)
    r = torch.as_tensor(ssc_ramp(cfg), dtype=power.dtype, device=power.device)
    with fp32_matmul():
        num = torch.matmul(power * r, fb.T)
        den = torch.matmul(power, fb.T)
    return num / den
