"""Pipeline modules and streaming sessions (port of
``mfcc_rust_tpu.models.pipelines``).

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

:class:`StreamingFeatures` and :class:`StreamingExtractor` are explicit-state
sessions: feed chunks, get the newly completed frames, equal to what the
batch transform gives on the samples seen.  They keep every tensor on the
session's device and read nothing back from it: what a call emits is
decided by host counts of samples.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import features as F
from ..config import FeatureConfig, fp32_matmul, librosa_config, vorbis_config
from ..constants import bundle_tensor
from ..ops import stft as _stft
from ..utils.device import resolve_device
from .incremental import IncrementalFrontend, incremental_supported


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


STREAMING_FEATURES = ("mfcc", "lmfe", "mfe", "mel_librosa")


class StreamingFeatures:
    """Streaming MFCC / log-MFE / MFE session with speechpy framing, plus
    ``"mel_librosa"``, the block-wise ``center=False`` librosa mel
    spectrogram (``librosa.stream``'s semantics: centring needs future
    samples).

    Feed chunks of any length; each call returns the frames completed so
    far and not yet returned, as tensors on the session's device (``None``
    means CUDA).  After L samples in all, the returns concatenated equal
    ``features.<feature>`` of those L samples, speechpy's frame count
    included; ``mel_librosa`` rows are frame-major (frames, n_mels).  The
    dB and MFCC heads of librosa are not offered: ``power_to_db``'s top_db
    clamp refers to the block's maximum, so they do not stream exactly.

    Two exact algorithms, both on the session's device: the carried
    chunk-GEMM (:class:`.incremental.IncrementalFrontend`) where
    :func:`.incremental.incremental_supported` holds, and otherwise the
    recompute path, which runs the batch function on the buffered samples
    of the new frames (on a CUDA float32 session, ``mfcc`` through the
    fused kernel and ``mel_librosa`` through the CT mel kernel)."""

    def __init__(self, cfg: Optional[FeatureConfig] = None, sample_rate: int = 16000,
                 feature: str = "mfcc", device=None):
        if feature not in STREAMING_FEATURES:
            raise ValueError(f"unsupported streaming feature {feature!r}")
        if feature == "mel_librosa":
            cfg = cfg if cfg is not None else librosa_config(sample_rate)
            if cfg.frame_size != cfg.fft_points:
                raise ValueError(
                    "mel_librosa streaming requires frame_size == fft_points"
                    " (librosa frames by n_fft; use win_length for short"
                    " analysis windows)"
                )
            cfg = cfg.replace(center=False)
        elif cfg is None:
            cfg = FeatureConfig(sample_rate=sample_rate)
        if cfg.preemphasis_cof:
            # np.roll's wrap couples the first sample to the signal's end
            raise ValueError(
                "preemphasis_cof != 0 cannot be streamed exactly (its np.roll"
                " wrap couples the first sample to the signal's end); "
                "pre-emphasize the signal before streaming instead"
            )
        self.cfg = cfg
        self.feature = feature
        self.device = resolve_device(device)
        self._dtype = getattr(torch, cfg.dtype)
        self._inc = (IncrementalFrontend(cfg, feature, self.device)
                     if incremental_supported(cfg, feature) else None)
        self.reset()

    def reset(self) -> None:
        """Start a new stream."""
        self._buf = torch.zeros(0, dtype=self._dtype, device=self.device)
        self._seen = 0
        self._emitted = 0
        if self._inc is not None:
            self._inc.reset()

    def _frame_len(self) -> int:
        # librosa frames by n_fft, the speechpy family by frame_size
        return self.cfg.fft_points if self.feature == "mel_librosa" else self.cfg.frame_size

    def _frames_ready(self, total: int) -> int:
        """The batch frame count of ``total`` samples."""
        fl, hop = self._frame_len(), self.cfg.frame_step
        if self.feature == "mel_librosa":
            return (total - fl) // hop + 1 if total >= fl else 0
        return max(0, (total - fl) // hop)

    def _empty(self):
        d = self.cfg.num_cepstral if self.feature == "mfcc" else self.cfg.num_filters
        rows = torch.zeros((0, d), dtype=self._dtype, device=self.device)
        if self.feature == "mfe":
            return rows, torch.zeros(0, dtype=self._dtype, device=self.device)
        return rows

    def process(self, chunk):
        """Feed (T,) samples (numpy or tensor); returns the newly completed
        frames, possibly none: (n_new, D), or for ``mfe`` the pair
        ((n_new, M), (n_new,))."""
        x = torch.as_tensor(chunk).to(device=self.device, dtype=self._dtype)
        self._seen += x.shape[0]
        ready = self._frames_ready(self._seen)
        n_new = ready - self._emitted
        if self._inc is not None:
            # the rows fed out end at the ready count: the new frames are
            # the last n_new (earlier rows are warm-up or already emitted)
            rows = self._inc.feed(x)
            self._emitted = ready
            if n_new <= 0:
                return self._empty()
            if self.feature == "mfe":
                return rows[0][-n_new:], rows[1][-n_new:]
            return rows[-n_new:]
        self._buf = torch.cat([self._buf, x])
        if n_new <= 0:
            return self._empty()
        # the least length with exactly n_new frames: speechpy's count
        # floor((L - fl)/hop) needs n_new*hop + fl, librosa's one hop less
        fl, hop = self._frame_len(), self.cfg.frame_step
        need = n_new * hop + (fl - hop if self.feature == "mel_librosa" else fl)
        out = self._batch(self._buf[:need])
        self._buf = self._buf[n_new * hop:]
        self._emitted = ready
        return out

    def _batch(self, x: torch.Tensor):
        if self.feature == "mel_librosa":
            return F.mel_spectrogram_librosa(x, self.cfg).transpose(-1, -2)
        return getattr(F, self.feature)(x, self.cfg)


class StreamingExtractor:
    """Explicit-carry streaming mel (or power) session on the reference's
    vorbis STFT.

    Feed chunks whose lengths are multiples of the hop; the first
    ``n_pad`` frames of a session are dropped and :meth:`finalize` returns
    the ``n_pad`` zero rows of the reference's layout, so a whole session
    concatenated equals the batch transform (``features.mel_spectrogram``,
    transposed).  Returns tensors on the session's device (``None`` means
    CUDA)."""

    def __init__(self, cfg: Optional[FeatureConfig] = None, sample_rate: int = 16000,
                 mel: bool = True, device=None):
        cfg = cfg if cfg is not None else vorbis_config(sample_rate)
        if cfg.window != "vorbis":
            cfg = cfg.replace(window="vorbis")
        self.cfg = cfg
        self.mel = mel
        self.device = resolve_device(device)
        self._dtype = getattr(torch, cfg.dtype)
        self._fbt = bundle_tensor(cfg, "fbank", self.device, self._dtype).T if mel else None
        self.reset()

    def reset(self) -> None:
        """Start a new stream: a zero carry and the warm-up to drop."""
        self._carry = _stft.streaming_init(self.cfg, dtype=self._dtype, device=self.device)
        self._to_drop = self.cfg.stream_n_pad

    def process(self, chunk) -> torch.Tensor:
        """Feed (T,) samples, T % hop == 0; returns the new frames,
        (new_frames, num_filters) mel energies (power bins with
        ``mel=False``)."""
        x = torch.as_tensor(chunk).to(device=self.device, dtype=self._dtype)
        self._carry, power = _stft.stft_streaming(x, self.cfg, self._carry)
        out = self._project(power)
        if self._to_drop:
            k = min(self._to_drop, out.shape[0])
            out = out[k:]
            self._to_drop -= k
        return out

    def finalize(self) -> torch.Tensor:
        """End the session: the ``n_pad`` never-written zero rows at the
        tail of the reference's layout.  Resets the session."""
        width = self.cfg.num_filters if self.mel else self.cfg.freq_size
        self.reset()
        return torch.zeros((self.cfg.stream_n_pad, width), dtype=self._dtype,
                           device=self.device)

    def _project(self, power: torch.Tensor) -> torch.Tensor:
        if not self.mel:
            return power
        with fp32_matmul():
            return torch.matmul(power, self._fbt)
