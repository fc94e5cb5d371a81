"""Pipeline modules (port of ``mfcc_rust_tpu.models.pipelines``, the batch
part).

Each pipeline is an ``nn.Module`` bound to a config.  The speechpy
pipelines (MFCC, MFE, log-MFE, SSC) register their chunk-GEMM constants
(``wall``, ``proj``, ``dct``, the Parseval ``w2`` and the SSC projection
``ssc``) as buffers, so ``.to(device)`` moves them and ``forward`` runs the
function of :mod:`..features` on them: on a CUDA float32 input the MFCC
pipeline is one launch of the fused kernel.  The librosa and vorbis
pipelines hold no buffers (their constants are cached per device by
:mod:`..features`); on a CUDA float32 input each librosa pipeline is one
launch of the CT mel kernel and a little plain work after it.
:class:`FeatureExtractor` holds one pipeline of each speechpy family and
the vorbis mel spectrogram.
"""

from __future__ import annotations

from typing import Optional

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


class SSCPipeline(Pipeline):
    """(..., T) -> (..., F, M) subband centroids in Hz."""

    _fn_name = "ssc"


class MelSpectrogramPipeline(Pipeline):
    """The reference's vorbis-STFT mel spectrogram, (..., M, T')."""

    _fn_name = "mel_spectrogram"
    _speechpy = False

    def __init__(self, cfg: FeatureConfig, device=None):
        super().__init__(cfg.replace(window="vorbis"), device)


class LibrosaMelPipeline(Pipeline):
    """(..., T) -> (..., n_mels, frames)."""

    _fn_name = "mel_spectrogram_librosa"
    _speechpy = False


class LibrosaMFCCPipeline(Pipeline):
    """(..., T) -> (..., n_mfcc, frames)."""

    _fn_name = "mfcc_librosa"
    _speechpy = False


class FeatureExtractor(nn.Module):
    """One module, every speechpy family and the vorbis mel spectrogram of
    one config, each a submodule on one device.  Calling it computes the
    MFCC, which on a CUDA float32 input is one launch of the fused kernel."""

    def __init__(self, cfg: Optional[FeatureConfig] = None, sample_rate: int = 16000,
                 device=None):
        super().__init__()
        self.cfg = cfg if cfg is not None else FeatureConfig(sample_rate=sample_rate)
        self.mfcc = MFCCPipeline(self.cfg, device)
        self.mfe = MFEPipeline(self.cfg, device)
        self.lmfe = LogMFEPipeline(self.cfg, device)
        self.ssc = SSCPipeline(self.cfg, device)
        self.mel_spectrogram = MelSpectrogramPipeline(self.cfg, device)

    def forward(self, signal: torch.Tensor) -> torch.Tensor:
        return self.mfcc(signal)
