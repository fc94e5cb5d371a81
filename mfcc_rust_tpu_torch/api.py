"""speechpy- and librosa-style entry points: numpy array or tensor in,
tensor out.

The keyword signatures and defaults of ``mfcc_rust_tpu.api`` (``mfcc``,
``mfe``, ``lmfe``, ``mel_spectrogram_librosa``, ``log_mel_spectrogram``,
``mfcc_librosa``), plus ``device``: ``None`` means CUDA and raises when
CUDA is absent; pass ``device="cpu"`` to run on the CPU.  Results are
tensors on that device.  Lengths are bucketed (pad to a bucket, compute,
trim to the true frame count) so a service sees few distinct shapes; pass
``bucket=False`` for exact lengths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from . import features as F
from .config import FeatureConfig, librosa_config
from .ops import framing as _framing
from .ops import stft as _stft
from .utils.bucketing import bucket_length
from .utils.device import resolve_device


def _speechpy_cfg(
    sampling_frequency,
    frame_length=0.020,
    frame_stride=0.01,
    num_cepstral=13,
    num_filters=40,
    fft_length=512,
    low_frequency=0,
    high_frequency=None,
    dc_elimination=True,
    precision="high",
    dtype="float32",
) -> FeatureConfig:
    return FeatureConfig(
        sample_rate=int(sampling_frequency),
        fft_points=int(fft_length),
        frame_length=float(frame_length),
        frame_stride=float(frame_stride),
        num_cepstral=int(num_cepstral),
        num_filters=int(num_filters),
        low_frequency=float(low_frequency),
        high_frequency=None if high_frequency is None else float(high_frequency),
        dc_elimination=bool(dc_elimination),
        precision=str(precision),
        dtype=str(dtype),
    )


def _prep(signal, cfg: FeatureConfig, bucket: bool, device):
    sig = torch.as_tensor(signal).to(device=resolve_device(device),
                                     dtype=getattr(torch, cfg.dtype))
    n = sig.shape[-1]
    if bucket:
        b = bucket_length(n)
        if b != n:
            sig = tF.pad(sig, (0, b - n))
    return sig, n


def _frames_nopad(cfg: FeatureConfig, true_len: int) -> int:
    num, _ = _framing.speechpy_frame_counts(
        true_len, cfg.frame_size, cfg.frame_step, zero_padding=False
    )
    return num


def mfcc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_cepstral=13, num_filters=40, fft_length=512, low_frequency=0,
         high_frequency=None, dc_elimination=True, bucket=True,
         precision="high", dtype="float32", device=None):
    """MFCC features, (..., num_frames, num_cepstral)."""
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        num_cepstral, num_filters, fft_length, low_frequency,
                        high_frequency, dc_elimination, precision, dtype)
    sig, n = _prep(signal, cfg, bucket, device)
    return F.mfcc(sig, cfg)[..., : _frames_nopad(cfg, n), :]


def mfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Mel filterbank energies: ((..., F, num_filters), (..., F))."""
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        13, num_filters, fft_length, low_frequency, high_frequency)
    sig, n = _prep(signal, cfg, bucket, device)
    feats, energies = F.mfe(sig, cfg)
    k = _frames_nopad(cfg, n)
    return feats[..., :k, :], energies[..., :k]


def lmfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
         bucket=True, device=None):
    """Log mel filterbank energies, (..., F, num_filters)."""
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        13, num_filters, fft_length, low_frequency, high_frequency)
    sig, n = _prep(signal, cfg, bucket, device)
    return F.lmfe(sig, cfg)[..., : _frames_nopad(cfg, n), :]


# -------------------------------------------------------- librosa-style API --
def _prep_librosa(y, cfg: FeatureConfig, bucket: bool, device):
    """The centre pad must see the true signal edge, not the bucket zeros,
    so it comes first, in ``cfg.pad_mode`` on the whole signal; bucketing
    then zero-pads and framing runs uncentred on the padded signal.
    Returns (signal, cfg with center=False, true frame count)."""
    sig, n = _prep(y, cfg, False, device)
    count = _stft.librosa_frame_count(n, cfg.fft_points, cfg.frame_step, cfg.center)
    if cfg.center:
        half = cfg.fft_points // 2
        sig = _framing.pad_signal(sig, half, half, cfg.pad_mode)
        cfg = cfg.replace(center=False)
    sig, _ = _prep(sig, cfg, bucket, sig.device)
    return sig, cfg, count


def mel_spectrogram_librosa(y, sr=22050, n_fft=2048, hop_length=512, win_length=None,
                            n_mels=128, fmin=0.0, fmax=None, power=2.0, center=True,
                            bucket=True, device=None):
    """librosa-compatible mel spectrogram, (..., n_mels, frames)."""
    cfg = librosa_config(sr, n_fft, hop_length, win_length, n_mels, fmin=fmin,
                         fmax=fmax, power=power).replace(center=center)
    sig, cfg, count = _prep_librosa(y, cfg, bucket, device)
    return F.mel_spectrogram_librosa(sig, cfg)[..., :count]


def log_mel_spectrogram(y, sr=22050, n_fft=2048, hop_length=512, n_mels=128, fmin=0.0,
                        fmax=None, center=True, bucket=True, device=None):
    """librosa ``power_to_db(melspectrogram)``.  Bucket frames are all-zero
    power, so they can neither raise the top_db reference maximum nor
    survive the final slice."""
    cfg = librosa_config(sr, n_fft, hop_length, None, n_mels, fmin=fmin,
                         fmax=fmax).replace(center=center)
    sig, cfg, count = _prep_librosa(y, cfg, bucket, device)
    return F.log_mel_spectrogram(sig, cfg)[..., :count]


def mfcc_librosa(y, sr=22050, n_mfcc=20, n_fft=2048, hop_length=512, n_mels=128,
                 fmin=0.0, fmax=None, center=True, bucket=True, device=None):
    """librosa-compatible MFCC, (..., n_mfcc, frames)."""
    cfg = librosa_config(sr, n_fft, hop_length, None, n_mels, n_mfcc=n_mfcc, fmin=fmin,
                         fmax=fmax).replace(center=center)
    sig, cfg, count = _prep_librosa(y, cfg, bucket, device)
    return F.mfcc_librosa(sig, cfg)[..., :count]
