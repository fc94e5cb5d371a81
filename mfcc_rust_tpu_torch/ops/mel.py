"""Mel filterbank projection (port of ``mfcc_rust_tpu.ops.mel``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import FeatureConfig, fp32_matmul
from ..constants import bundle_tensor
from .spectrum import zero_handling


def filterbank_matrix(cfg: FeatureConfig, dtype: Optional[torch.dtype] = None,
                      device=None) -> torch.Tensor:
    """(num_filters, freq_size) mel filterbank for the config."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    return bundle_tensor(cfg, "fbank", torch.device(device or "cpu"), dtype)


def apply_filterbank(power: torch.Tensor, cfg: FeatureConfig,
                     handle_zeros: bool = False) -> torch.Tensor:
    """(..., F, K) power -> (..., F, M) mel energies."""
    fb = filterbank_matrix(cfg, power.dtype, power.device)
    with fp32_matmul():
        feats = torch.matmul(power, fb.T)
    if handle_zeros:
        feats = zero_handling(feats)
    return feats


def mel_project_time_major(power: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(..., T, K) -> (..., M, T): the mel-spectrogram orientation."""
    return apply_filterbank(power, cfg).transpose(-1, -2)
