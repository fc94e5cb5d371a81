"""Frozen copy of ``tests/golden/speechpy_ref.py``, the benchmark's own: later
changes to the tests' oracle do not move the benchmark's yardstick.

Golden float64 numpy oracle for the speechpy feature semantics.

Independent reimplementation of the algorithms the reference targets
(README.md:3: match speechpy), written from the speechpy spec with the
reference's *intended* (bug-fixed) semantics per SURVEY.md §4:

* ``power_spectrum`` includes the square: ``|X|^2 / N`` (the reference drops
  the square, processing.rs:179-181 — bug #1).
* MFCC uses true scipy ``dct(type=2, norm='ortho')`` per-row scaling
  (the reference mis-scales, feature.rs:126-131 — bug #2).
* ``stack_frames`` performs real overlapping framing (the reference's
  chunk-copy fill is broken, processing.rs:110-120 — bug #3).
* ``log_power_spectrum`` normalizes by the true max (bug #4).

Everything here is eager float64 numpy — slow and simple on purpose; it is the
measuring stick for the JAX/TPU implementation, never a compute path.
"""

from __future__ import annotations

import numpy as np
import scipy.fft


EPS64 = np.finfo(np.float64).eps
EPS32 = float(np.finfo(np.float32).eps)


def zero_handling(x, eps=EPS32):
    """Replace exact zeros before logs (functions.rs:66-71 uses f32 EPSILON)."""
    return np.where(x == 0.0, eps, x)


def preemphasis(signal, shift=1, cof=0.98):
    """signal - cof * roll(signal, shift) (processing.rs:31-53)."""
    return signal - cof * np.roll(signal, shift)


def stack_frames_counts(length, frame_len, frame_step, zero_padding):
    if zero_padding:
        numframes = int(np.ceil((length - frame_len) / frame_step))
        len_sig = numframes * frame_step + frame_len
    else:
        numframes = int(np.floor((length - frame_len) / frame_step))
        len_sig = (numframes - 1) * frame_step + frame_len
    return numframes, len_sig


def stack_frames(
    signal,
    sample_rate,
    frame_length=0.020,
    frame_stride=0.020,
    window=None,
    zero_padding=True,
):
    """speechpy-style overlapping framing (processing.rs:65-129 semantics,
    implemented correctly).  Note the speechpy frame-count quirk: with
    ``zero_padding=False``, ``numframes = floor((L-fl)/step)`` (not +1), so
    the final otherwise-valid frame is dropped (speechpy issue #34 behavior,
    kept for parity)."""
    signal = np.asarray(signal, dtype=np.float64)
    length = len(signal)
    frame_len = int(round(sample_rate * frame_length))
    frame_step = int(round(sample_rate * frame_stride))
    numframes, len_sig = stack_frames_counts(length, frame_len, frame_step, zero_padding)
    if zero_padding:
        sig = np.concatenate([signal, np.zeros(len_sig - length)])
    else:
        sig = signal[:len_sig]
    idx = np.arange(numframes)[:, None] * frame_step + np.arange(frame_len)[None, :]
    frames = sig[idx]
    if window is not None:
        frames = frames * window[None, :]
    return frames


def fft_spectrum(frames, fft_points=512):
    return np.abs(np.fft.rfft(frames, n=fft_points, axis=-1))


def power_spectrum(frames, fft_points=512):
    """speechpy: |rfft|^2 / N (the corrected form of processing.rs:179-181)."""
    return (1.0 / fft_points) * fft_spectrum(frames, fft_points) ** 2


def log_power_spectrum(frames, fft_points=512, normalize=True):
    ps = power_spectrum(frames, fft_points)
    lps = np.where(ps > 1e-20, 10.0 * np.log10(np.maximum(ps, 1e-30)), -200.0)
    if normalize:
        lps = lps - lps.max()
    return lps


def filterbanks(num_filter, coefficients, sampling_freq, low_freq=0.0, high_freq=None):
    """speechpy integer-bin mel filterbank (feature.rs:36-90 semantics),
    including the ``(coefficients+1)`` bin-index quirk."""
    fs = float(sampling_freq)
    high_freq = fs / 2.0 if high_freq is None else float(high_freq)

    def to_mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (np.exp(np.asarray(m, dtype=np.float64) / 1127.0) - 1.0)

    mels = np.linspace(to_mel(low_freq), to_mel(high_freq), num_filter + 2)
    hertz = to_hz(mels)
    # match f32 arithmetic of the reference for the floor step
    freq_index = np.floor(
        ((coefficients + 1) * hertz.astype(np.float32) / np.float32(fs)).astype(
            np.float64
        )
    ).astype(int)

    fbank = np.zeros((num_filter, coefficients))
    for i in range(num_filter):
        left, middle, right = freq_index[i], freq_index[i + 1], freq_index[i + 2]
        for j in range(left, min(right, coefficients)):
            if j <= middle and middle != left:
                fbank[i, j] = (j - left) / float(middle - left)
            if middle <= j and right != middle:
                fbank[i, j] = (right - j) / float(right - middle)
    return fbank


def mfe(
    signal,
    sampling_frequency,
    frame_length=0.020,
    frame_stride=0.01,
    num_filters=40,
    fft_length=512,
    low_frequency=0.0,
    high_frequency=None,
):
    """Mel filterbank energies + per-frame energies (feature.rs:200-233)."""
    frames = stack_frames(
        signal, sampling_frequency, frame_length, frame_stride, zero_padding=False
    )
    ps = power_spectrum(frames, fft_length)
    energies = zero_handling(ps.sum(axis=-1))
    fb = filterbanks(
        num_filters, fft_length // 2 + 1, sampling_frequency, low_frequency, high_frequency
    )
    features = zero_handling(ps @ fb.T)
    return features, energies


def mfcc(
    signal,
    sampling_frequency,
    frame_length=0.020,
    frame_stride=0.01,
    num_cepstral=13,
    num_filters=40,
    fft_length=512,
    low_frequency=0.0,
    high_frequency=None,
    dc_elimination=True,
):
    """MFCC (feature.rs:94-148 semantics with correct ortho DCT scaling)."""
    feature, energy = mfe(
        signal,
        sampling_frequency,
        frame_length,
        frame_stride,
        num_filters,
        fft_length,
        low_frequency,
        high_frequency,
    )
    if feature.size == 0:
        return np.empty((0, num_cepstral))
    feature = np.log(feature)
    feature = scipy.fft.dct(feature, type=2, axis=-1, norm="ortho")[:, :num_cepstral]
    if dc_elimination:
        feature[:, 0] = np.log(energy)
    return feature


def lmfe(signal, sampling_frequency, **kw):
    """Log mel filterbank energies (feature.rs:242-245)."""
    feature, _ = mfe(signal, sampling_frequency, **kw)
    return np.log(feature)


def ssc(
    signal,
    sampling_frequency,
    frame_length=0.020,
    frame_stride=0.01,
    num_filters=40,
    fft_length=512,
    low_frequency=0.0,
    high_frequency=None,
):
    """Spectral subband centroids — advertised by the reference (README.md:15)
    but absent from its code (SURVEY C24).  Spec: per mel band,
    ``centroid = sum(freq * power) / sum(power)`` with bin center frequencies
    ``linspace(1, fs/2, n_freq)``, speechpy framing and filterbanks."""
    frames = stack_frames(
        signal, sampling_frequency, frame_length, frame_stride, zero_padding=False
    )
    ps = power_spectrum(frames, fft_length)
    ps = np.where(ps == 0.0, np.finfo(np.float64).eps, ps)
    fb = filterbanks(
        num_filters, fft_length // 2 + 1, sampling_frequency, low_frequency, high_frequency
    )
    r = np.linspace(1.0, sampling_frequency / 2.0, ps.shape[-1])
    return (ps * r[None, :]) @ fb.T / (ps @ fb.T)


def derivative_extraction(feat, delta_windows=2):
    """speechpy/reference delta along the *feature* axis with the
    forward-term-only Range weighting (processing.rs:222-254, kept verbatim
    for parity — see also the symmetric time-axis variant in the library)."""
    feat = np.asarray(feat, dtype=np.float64)
    cols = feat.shape[1]
    features = np.pad(feat, [[0, 0], [delta_windows, delta_windows]], mode="edge")
    dif = np.zeros_like(feat)
    scale = 0.0
    offset = delta_windows
    for i in range(delta_windows):
        rng = i + 1
        dif = dif + (
            rng * features[:, offset + rng : offset + rng + cols]
            - features[:, offset - rng : offset - rng + cols]
        )
        scale += 2.0 * rng**2
    return dif / scale


def extract_derivative_feature(feature):
    """Static+delta+delta-delta cube N x M x 3 (feature.rs:253-269)."""
    d1 = derivative_extraction(feature, 2)
    d2 = derivative_extraction(d1, 2)
    return np.stack([feature, d1, d2], axis=-1)


def cmvn(vec, variance_normalization=False):
    """Global CMVN (processing.rs:265-300)."""
    eps = 2.0**-30
    centered = vec - vec.mean(axis=0, keepdims=True)
    if variance_normalization:
        return centered / (centered.std(axis=0, keepdims=True) + eps)
    return centered


def cmvnw(vec, win_size=301, variance_normalization=False):
    """Sliding-window CMVN (processing.rs:315-371)."""
    eps = 2.0**-30
    assert win_size % 2 == 1, "Windows size must be odd!"
    pad_size = (win_size - 1) // 2
    rows = vec.shape[0]
    vp = np.pad(vec, [[pad_size, pad_size], [0, 0]], mode="symmetric")
    centered = np.empty_like(vec, dtype=np.float64)
    for i in range(rows):
        centered[i] = vec[i] - vp[i : i + win_size].mean(axis=0)
    if variance_normalization:
        out = np.empty_like(centered)
        cp = np.pad(centered, [[pad_size, pad_size], [0, 0]], mode="symmetric")
        for i in range(rows):
            out[i] = centered[i] / (cp[i : i + win_size].std(axis=0) + eps)
        return out
    return centered
