"""speechpy- and librosa-style entry points: numpy array or tensor in,
tensor out.

The keyword signatures and defaults of ``mfcc_rust_tpu.api`` plus
``device``: ``None`` means CUDA and raises when CUDA is absent; pass
``device="cpu"`` to run on the CPU.  Results are tensors on that device.
The feature entry points bucket lengths (pad to a bucket, compute, trim to
the true frame count) so a service sees few distinct shapes; pass
``bucket=False`` for exact lengths.  The post-processing entry points
(``preemphasis``, deltas, CMVN, ``stack_frames``, ``log_power_spectrum``)
keep the input's dtype; the feature entry points compute in float32 unless
``dtype`` says otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from . import features as F
from .config import FeatureConfig, librosa_config
from .ops import delta as _delta
from .ops import framing as _framing
from .ops import normalize as _normalize
from .ops import resample as _resample
from .ops import spectrum as _spectrum
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


def ssc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Spectral subband centroids in Hz, (..., F, num_filters)."""
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        13, num_filters, fft_length, low_frequency, high_frequency)
    sig, n = _prep(signal, cfg, bucket, device)
    return F.ssc(sig, cfg)[..., : _frames_nopad(cfg, n), :]


def extract(signal, sampling_frequency, which=("mfcc",), frame_length=0.020,
            frame_stride=0.01, num_cepstral=13, num_filters=40, fft_length=512,
            low_frequency=0, high_frequency=None, dc_elimination=True, bucket=True,
            precision="high", dtype="float32", device=None):
    """Several speechpy-family features from one shared frontend pass.
    ``which`` ⊆ {"mfcc", "lmfe", "mfe", "ssc", "energy"}; returns a dict of
    tensors (``"mfe"`` maps to a (features, energies) pair).  Cheaper than
    the separate entry points when several features are wanted; the
    ``mfcc`` head is the plain chunk-GEMM path, not the fused kernel."""
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        num_cepstral, num_filters, fft_length, low_frequency,
                        high_frequency, dc_elimination, precision, dtype)
    sig, n = _prep(signal, cfg, bucket, device)
    k = _frames_nopad(cfg, n)
    out = {}
    for name, val in F.extract(sig, cfg, tuple(which)).items():
        if name == "mfe":
            out[name] = (val[0][..., :k, :], val[1][..., :k])
        elif name == "energy":
            out[name] = val[..., :k]
        else:
            out[name] = val[..., :k, :]
    return out


def mel_spectrogram(signal, sampling_frequency, frame_length=0.020,
                    frame_stride=0.01, num_cepstral=13, num_filters=40,
                    fft_length=512, low_frequency=0, high_frequency=None,
                    dc_elimination=True, bucket=True, device=None):
    """The reference's mel spectrogram (vorbis streaming STFT): 1-D input ->
    (num_filters, T'), 2-D (C, T) -> (C, num_filters, T'), T' = ceil(T/hop);
    more dims raise.  The last ``n_pad`` frames are zero, as the reference
    never writes them; a clip of at most ``n_pad`` frames is all zeros."""
    sig_in = torch.as_tensor(signal)
    if sig_in.ndim > 2:
        raise ValueError("mel_spectrogram supports only 1-D or 2-D input")
    cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                        num_cepstral, num_filters, fft_length, low_frequency,
                        high_frequency, dc_elimination).replace(window="vorbis")
    sig, n = _prep(sig_in, cfg, bucket, device)
    t_true = -(-n // cfg.stream_hop)
    out = F.mel_spectrogram(sig, cfg)[..., :t_true]
    # the reference never writes its last n_pad frames; the start is clamped
    # at 0, so a clip of at most n_pad frames is all zeros (not the bucket's
    # computed frames)
    keep = max(t_true - cfg.stream_n_pad, 0)
    if keep < t_true:
        out = torch.cat([out[..., :keep], out.new_zeros(out.shape[:-1] + (t_true - keep,))],
                        dim=-1)
    return out


# ------------------------------------------------- post-processing entry points --
def _tensor(x, device):
    """Tensor on the resolved device, the input's dtype kept."""
    return torch.as_tensor(x).to(resolve_device(device))


def preemphasis(signal, shift=1, cof=0.98, device=None):
    """Pre-emphasis with np.roll wrap semantics."""
    return _framing.preemphasis(_tensor(signal, device), shift, cof)


def derivative_extraction(feat, delta_windows=2, device=None):
    """speechpy deltas along the feature (last) axis."""
    return _delta.derivative_extraction(_tensor(feat, device), delta_windows)


def extract_derivative_feature(feature, device=None):
    """Static + delta + delta-delta cube, (..., T, M) -> (..., T, M, 3)."""
    return _delta.extract_derivative_feature(_tensor(feature, device))


def delta(feat, width=2, device=None):
    """Symmetric delta along the time axis (-2)."""
    return _delta.delta(_tensor(feat, device), width)


def delta_librosa(feat, width=9, order=1, axis=-1, device=None):
    """librosa.feature.delta: the Savitzky-Golay derivative along ``axis``
    (librosa layout: frames last)."""
    return _delta.delta_librosa(_tensor(feat, device), width, order, axis)


def _frames_cfg(frames: torch.Tensor, fft_length) -> FeatureConfig:
    """The config of a spectrum of pre-framed data: the frame length from
    the frames, the fft size given."""
    return FeatureConfig(sample_rate=16000, fft_points=int(fft_length),
                         frame_length_samples=int(frames.shape[-1]))


def log_power_spectrum(frames, fft_length=512, normalize=True, device=None):
    """Log power spectrum of framed data, normalized by its overall maximum."""
    frames = _tensor(frames, device)
    return _spectrum.log_power_spectrum(frames, _frames_cfg(frames, fft_length), normalize)


def stack_frames(signal, sampling_frequency, frame_length=0.020, frame_stride=0.020,
                 zero_padding=True, device=None):
    """speechpy framing: (..., T) -> (..., F, frame_len)."""
    return _framing.stack_frames(_tensor(signal, device), sampling_frequency,
                                 frame_length, frame_stride, None, zero_padding)


def cmvn(vec, variance_normalization=False, device=None):
    """Global CMVN over the observation axis (-2)."""
    return _normalize.cmvn(_tensor(vec, device), variance_normalization)


def cmvnw(vec, win_size=301, variance_normalization=False, device=None):
    """Sliding-window CMVN over the observation axis (-2); odd windows only."""
    return _normalize.cmvnw(_tensor(vec, device), win_size, variance_normalization)


def resample_poly(signal, up, down, precision="highest", beta=5.0, half_factor=10, *,
                  device=None):
    """Resample (..., T) by up/down (scipy ``resample_poly``, Kaiser
    ``beta``): ceil(T*up/down) samples, in the input's dtype.  The
    reference's signature; ``precision`` is ignored (IEEE FP32 always)."""
    return _resample.resample_poly(_tensor(signal, device), up, down, precision, beta,
                                   half_factor)


def resample(signal, orig_sr, target_sr, precision="highest", *, device=None):
    """Resample (..., T) audio from orig_sr to target_sr (both in Hz)."""
    return _resample.resample(_tensor(signal, device), orig_sr, target_sr, precision)


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
