"""DCT-II (ortho) as a product with a precomputed matrix (port of
``mfcc_rust_tpu.ops.dct``)."""

from __future__ import annotations

import torch

from ..config import FeatureConfig, fp32_matmul
from ..constants import bundle_tensor


def dct2_ortho(x: torch.Tensor, cfg: FeatureConfig, truncate: bool = True) -> torch.Tensor:
    """(..., M) -> (..., num_cepstral) orthonormal DCT-II along the last
    axis."""
    d = bundle_tensor(cfg, "dct" if truncate else "dct_full", x.device, x.dtype)
    with fp32_matmul():
        return torch.matmul(x, d)
