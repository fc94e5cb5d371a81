"""speechpy.processing-compatible surface (speechpy's processing.py
signatures, including the per-frame window ``filter`` callable of
``stack_frames``)."""

from __future__ import annotations

import numpy as np
import torch

from ... import api
from ...ops import framing as _framing
from ...ops import spectrum as _spectrum


def preemphasis(signal, shift=1, cof=0.98, device=None):
    return api.preemphasis(signal, shift, cof, device=device)


def stack_frames(sig, sampling_frequency, frame_length=0.020, frame_stride=0.020,
                 filter=lambda x: np.ones((x,)), zero_padding=True, device=None):
    """speechpy framing with the window ``filter(frame_len)``, a float64
    array: a window that is not all ones multiplies every frame (and so
    promotes the frames to float64)."""
    sig = api._tensor(sig, device)
    window = None
    if filter is not None:
        w = np.asarray(filter(int(round(sampling_frequency * frame_length))),
                       dtype=np.float64).reshape(-1)
        if not np.all(w == 1.0):
            window = torch.as_tensor(w, device=sig.device)
    return _framing.stack_frames(sig, sampling_frequency, frame_length, frame_stride,
                                 window=window, zero_padding=zero_padding)


def fft_spectrum(frames, fft_points=512, device=None):
    frames = api._tensor(frames, device)
    return _spectrum.fft_spectrum(frames, api._frames_cfg(frames, fft_points))


def power_spectrum(frames, fft_points=512, device=None):
    frames = api._tensor(frames, device)
    return _spectrum.power_spectrum(frames, api._frames_cfg(frames, fft_points))


def log_power_spectrum(frames, fft_points=512, normalize=True, device=None):
    return api.log_power_spectrum(frames, fft_points, normalize, device=device)


def derivative_extraction(feat, DeltaWindows, device=None):
    return api.derivative_extraction(feat, DeltaWindows, device=device)


def cmvn(vec, variance_normalization=False, device=None):
    return api.cmvn(vec, variance_normalization, device=device)


def cmvnw(vec, win_size=301, variance_normalization=False, device=None):
    return api.cmvnw(vec, win_size, variance_normalization, device=device)
