"""Pipeline modules (port of ``mfcc_rust_tpu.models.pipelines``, the
speechpy and librosa parts).

Each pipeline is an ``nn.Module`` bound to a config.  The speechpy
pipelines register their chunk-GEMM constants (``wall``, ``proj``, ``dct``
and the Parseval ``w2``) as buffers, so ``.to(device)`` moves them and
``forward`` runs the function of :mod:`..features` on them: on a CUDA
float32 input the MFCC pipeline is one launch of the fused kernel.  The
librosa pipelines hold no buffers (their constants differ from the
speechpy ones and are cached per device by :mod:`..features`); on a CUDA
float32 input each is one launch of the CT mel kernel and a little plain
work after it.
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
    _speechpy: bool = True  # takes the speechpy chunk-GEMM constants

    def __init__(self, cfg: FeatureConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self._has_consts = self._speechpy and F._fast_path_ok(cfg)
        if self._has_consts:
            # configs off the chunk-GEMM path use the gather fallback, which
            # takes its DFT constants per call
            consts = F._speechpy_tensors(cfg, dev, getattr(torch, cfg.dtype))
            for name, t in consts.items():
                self.register_buffer(name, t.clone(), persistent=False)

    def forward(self, signal: torch.Tensor):
        fn = getattr(F, self._fn_name)
        if not self._speechpy:
            return fn(signal, self.cfg)
        consts = dict(self.named_buffers()) if self._has_consts else None
        return fn(signal, self.cfg, consts)


class MFCCPipeline(Pipeline):
    """(..., T) -> (..., F, num_cepstral)."""

    _fn_name = "mfcc"


class MFEPipeline(Pipeline):
    """(..., T) -> ((..., F, M), (..., F))."""

    _fn_name = "mfe"


class LogMFEPipeline(Pipeline):
    """(..., T) -> (..., F, M)."""

    _fn_name = "lmfe"


class LibrosaMelPipeline(Pipeline):
    """(..., T) -> (..., n_mels, frames)."""

    _fn_name = "mel_spectrogram_librosa"
    _speechpy = False


class LibrosaMFCCPipeline(Pipeline):
    """(..., T) -> (..., n_mfcc, frames)."""

    _fn_name = "mfcc_librosa"
    _speechpy = False
