"""Pipeline modules and streaming sessions (port of
``mfcc_rust_tpu.models.pipelines``).

Each pipeline is an ``nn.Module`` bound to a config.  A pipeline that holds
the constants of its plain lowering holds them as non-persistent buffers,
so ``.to(device)`` moves them, a trace reads them as buffers and
``forward`` runs the function of :mod:`..features` on them.  The speechpy
pipelines (MFCC, MFE, log-MFE, SSC) hold their chunk-GEMM constants (``wall``,
``proj``, ``dct``, the Parseval ``w2`` and the SSC projection ``ssc``); on a
CUDA float32 input the MFCC pipeline is one launch of the fused kernel.
The vorbis mel pipeline (its chunk-GEMM ``wall`` and ``fb2``) and the
librosa pipelines (the constants of their plain lowering; on a CUDA
float32 input they launch the CT mel kernel, whose constants are its own)
hold theirs only when built with ``hold_constants=True``, as
:mod:`..export` builds them; otherwise :mod:`..features` caches them per
device.
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
    ``device=None`` means CUDA, and raises when CUDA is absent.
    ``hold_constants`` (None: the class's default) registers the constants
    of the plain lowering as buffers; a config with none to hold (the gather
    fallback, the framed STFT) takes its constants per call."""

    _fn_name: str = ""
    _holds_constants: bool = True

    def __init__(self, cfg: FeatureConfig, device=None, hold_constants: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        self._device = dev = resolve_device(device)
        hold = self._holds_constants if hold_constants is None else hold_constants
        consts = self._constants(cfg, dev, getattr(torch, cfg.dtype)) if hold else None
        self._has_consts = consts is not None
        for name, t in (consts or {}).items():
            self.register_buffer(name, t.clone(), persistent=False)

    @staticmethod
    def _constants(cfg: FeatureConfig, device: torch.device, dtype: torch.dtype):
        """The speechpy chunk-GEMM constants, or None off that path."""
        return F._speechpy_tensors(cfg, device, dtype) if F._fast_path_ok(cfg) else None

    def forward(self, signal: torch.Tensor):
        consts = dict(self.named_buffers()) if self._has_consts else None
        return getattr(F, self._fn_name)(signal, self.cfg, consts)

    def lower(self, signal_shape, dtype: Optional[torch.dtype] = None):
        """The ``torch.export.ExportedProgram`` of this pipeline for
        ``signal_shape`` inputs of ``dtype`` (default: the config's), on the
        device of its buffers, through :func:`..export.export_pipeline`.
        Unlike the JAX package's ``lower``, which lowers the jitted function
        as it would run, this one always takes the plain lowering
        (``pallas="off"``): the kernels are calls through ``ctypes`` that no
        trace can see."""
        from ..export import export_pipeline

        buf = next(self.buffers(), None)
        cfg = self.cfg if dtype is None else self.cfg.replace(dtype=str(dtype).split(".")[-1])
        return export_pipeline(cfg, self._fn_name, signal_shape,
                               device=buf.device if buf is not None else self._device)


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
    _holds_constants = False

    def __init__(self, cfg: FeatureConfig, device=None, hold_constants: Optional[bool] = None):
        super().__init__(cfg.replace(window="vorbis"), device, hold_constants)

    @staticmethod
    def _constants(cfg, device, dtype):
        if F.vorbis_lowering(cfg) != "vorbis-chunk-gemm":
            return None
        return F._vorbis_tensors(cfg, device, dtype)


class LibrosaMelPipeline(Pipeline):
    """(..., T) -> (..., n_mels, frames)."""

    _fn_name = "mel_spectrogram_librosa"
    _holds_constants = False

    @staticmethod
    def _constants(cfg, device, dtype):
        return F._librosa_plain_tensors(cfg, device, dtype)


class LibrosaMFCCPipeline(Pipeline):
    """(..., T) -> (..., n_mfcc, frames)."""

    _fn_name = "mfcc_librosa"
    _holds_constants = False

    @staticmethod
    def _constants(cfg, device, dtype):
        c = F._librosa_plain_tensors(cfg, device, dtype) or {}
        return dict(c, dct=bundle_tensor(cfg, "dct", device, dtype))


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
