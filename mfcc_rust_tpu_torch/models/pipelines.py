"""Pipeline modules (port of ``mfcc_rust_tpu.models.pipelines``, the
speechpy part).

Each pipeline is an ``nn.Module`` bound to a config.  Its chunk-GEMM
constants (``wall``, ``proj``, ``dct`` and the Parseval ``w2``) are
registered buffers, so ``.to(device)`` moves them and ``forward`` runs the
function of :mod:`..features` on them: on a CUDA float32 input the MFCC
pipeline is one launch of the fused kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import features as F
from ..config import FeatureConfig
from ..utils.device import resolve_device


class Pipeline(nn.Module):
    """Base: a feature function of :mod:`..features` bound to a config.
    ``device=None`` means CUDA, and raises when CUDA is absent."""

    _fn_name: str = ""

    def __init__(self, cfg: FeatureConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self._has_consts = F._fast_path_ok(cfg)
        if self._has_consts:
            # configs off the chunk-GEMM path use the gather fallback, which
            # takes its DFT constants per call
            consts = F._speechpy_tensors(cfg, resolve_device(device), getattr(torch, cfg.dtype))
            for name, t in consts.items():
                self.register_buffer(name, t.clone(), persistent=False)

    def forward(self, signal: torch.Tensor):
        consts = dict(self.named_buffers()) if self._has_consts else None
        return getattr(F, self._fn_name)(signal, self.cfg, consts)


class MFCCPipeline(Pipeline):
    """(..., T) -> (..., F, num_cepstral)."""

    _fn_name = "mfcc"


class MFEPipeline(Pipeline):
    """(..., T) -> ((..., F, M), (..., F))."""

    _fn_name = "mfe"


class LogMFEPipeline(Pipeline):
    """(..., T) -> (..., F, M)."""

    _fn_name = "lmfe"
