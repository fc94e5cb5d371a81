"""``nn.Module`` transforms in the torchaudio style, the port's counterpart of
``mfcc_rust_tpu/torch_compat.py`` (its ``MelSpectrogram``, ``MFCC`` and
``SpeechpyMFCC``).

Each transform keeps its keywords and calls an entry point of :mod:`.api`
on the waveform's own device: a CUDA float32 waveform goes through the CT
mel kernel (``MelSpectrogram``, ``MFCC``) or the fused MFCC kernel
(``SpeechpyMFCC``), and autograd flows through the kernels' backward
passes.  The JAX bridge's ``from_torch``/``to_torch`` have no counterpart:
the port is tensors already.
"""

from __future__ import annotations

import torch
from torch import nn

from . import api


class _Transform(nn.Module):
    """Stores the keyword config; ``forward`` calls ``_fn`` on the
    waveform's device.  No parameters."""

    _fn = None  # set by subclasses

    def __init__(self, **kw):
        super().__init__()
        self.kw = kw

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v!r}" for k, v in self.kw.items())

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        return type(self)._fn(waveform, device=waveform.device, **self.kw)


class MelSpectrogram(_Transform):
    """librosa mel spectrogram, ``(..., T) -> (..., n_mels, frames)``.
    Keywords of :func:`.api.mel_spectrogram_librosa` (sr, n_fft, hop_length,
    n_mels, fmin, fmax, power, center, ...)."""

    _fn = staticmethod(api.mel_spectrogram_librosa)


class MFCC(_Transform):
    """librosa MFCC, ``(..., T) -> (..., n_mfcc, frames)``.  Keywords of
    :func:`.api.mfcc_librosa`."""

    _fn = staticmethod(api.mfcc_librosa)


class SpeechpyMFCC(_Transform):
    """speechpy MFCC, ``(..., T) -> (..., frames, num_cepstral)``.  Keywords
    of :func:`.api.mfcc` after the positional ``sampling_frequency``."""

    _fn = staticmethod(api.mfcc)

    def __init__(self, sampling_frequency: int, **kw):
        super().__init__(sampling_frequency=sampling_frequency, **kw)
