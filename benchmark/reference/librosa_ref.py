"""Frozen copy of ``tests/golden/librosa_ref.py``, the benchmark's own: later
changes to the tests' oracle do not move the benchmark's yardstick.

Golden float64 numpy oracle for librosa-compatible semantics.

librosa itself is not installed in this image, so this module reimplements the
documented librosa algorithms (STFT with centered reflect padding + periodic
hann, Slaney mel filterbank with area norm, power_to_db, DCT-ortho MFCC) in
eager float64 numpy.  It serves as the oracle for BASELINE.json config 2
("librosa-compatible mel spectrogram, n_fft=2048, hop=512, 128 mels").
"""

from __future__ import annotations

import numpy as np
import scipy.fft


def hann_periodic(n):
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep,
        f / f_sp,
    )


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m
    )


def mel_filters(sr, n_fft, n_mels=128, fmin=0.0, fmax=None, norm="slaney"):
    fmax = sr / 2.0 if fmax is None else fmax
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_f = mel_to_hz_slaney(
        np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights


def stft(y, n_fft=2048, hop_length=None, win_length=None, center=True, pad_mode="reflect"):
    """librosa.stft: returns (1+n_fft//2, n_frames) complex."""
    hop_length = n_fft // 4 if hop_length is None else hop_length
    win_length = n_fft if win_length is None else win_length
    w = hann_periodic(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = y[idx] * w[None, :]
    return np.fft.rfft(frames, axis=-1).T


def melspectrogram(y, sr=22050, n_fft=2048, hop_length=512, win_length=None,
                   n_mels=128, fmin=0.0, fmax=None, power=2.0, center=True):
    s = np.abs(stft(y, n_fft, hop_length, win_length, center)) ** power
    fb = mel_filters(sr, n_fft, n_mels, fmin, fmax)
    return fb @ s  # (n_mels, n_frames)


def power_to_db(s, ref=1.0, amin=1e-10, top_db=80.0):
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def mfcc(y, sr=22050, n_mfcc=20, n_fft=2048, hop_length=512, n_mels=128,
         fmin=0.0, fmax=None, center=True):
    s = power_to_db(melspectrogram(y, sr, n_fft, hop_length, None, n_mels, fmin, fmax,
                                   2.0, center))
    return scipy.fft.dct(s, axis=-2, type=2, norm="ortho")[:n_mfcc]
