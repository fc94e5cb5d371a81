"""speechpy.feature-compatible surface (speechpy's feature.py signatures)."""

from __future__ import annotations

from ... import api
from ...constants import speechpy_filterbanks


def filterbanks(num_filter, coefficients, sampling_freq, low_freq=None,
                high_freq=None):
    """Mel filterbank matrix, (num_filter, coefficients), float64 numpy:
    speechpy's ``filterbanks`` with its default low_freq of 300 Hz."""
    low = 300.0 if low_freq is None else float(low_freq)
    return speechpy_filterbanks(int(num_filter), int(coefficients), int(sampling_freq),
                                low, high_freq)


def mfcc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_cepstral=13, num_filters=40, fft_length=512, low_frequency=0,
         high_frequency=None, dc_elimination=True, device=None):
    return api.mfcc(signal, sampling_frequency, frame_length, frame_stride,
                    num_cepstral, num_filters, fft_length, low_frequency,
                    high_frequency, dc_elimination, device=device)


def mfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        device=None):
    return api.mfe(signal, sampling_frequency, frame_length, frame_stride,
                   num_filters, fft_length, low_frequency, high_frequency, device=device)


def lmfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
         device=None):
    return api.lmfe(signal, sampling_frequency, frame_length, frame_stride,
                    num_filters, fft_length, low_frequency, high_frequency, device=device)


def ssc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        device=None):
    return api.ssc(signal, sampling_frequency, frame_length, frame_stride,
                   num_filters, fft_length, low_frequency, high_frequency, device=device)


def extract_derivative_feature(feature, device=None):
    return api.extract_derivative_feature(feature, device=device)
