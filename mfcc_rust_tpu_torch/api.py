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

The feature entry points (``mfcc``, ``mfe``, ``lmfe``, ``ssc``,
``extract``, ``mel_spectrogram`` and the three librosa ones) are where the
JAX package calls ``_jitted``: on CUDA they replay one CUDA graph per
(function, config, bucketed shape) from :mod:`.utils.graphs`, the input
written straight into the graph's static input (uploaded there from numpy,
the bucket's tail zeroed, the librosa centre pad's edges filled), and
trim a fresh copy of its output.  Few buckets mean few captures.  They run
eagerly on the CPU and for an input that requires a gradient
(:func:`.utils.graphs.runs_eagerly`).  Each runs in its span ``api.<name>``
(:func:`.utils.profiling.span`) and counts its true and bucketed samples
(:data:`.utils.bucketing.samples`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as tF

from . import features as F
from .config import FeatureConfig, librosa_config
from .constants import tensor_cache
from .ops import delta as _delta
from .ops import framing as _framing
from .ops import normalize as _normalize
from .ops import resample as _resample
from .ops import spectrum as _spectrum
from .ops import stft as _stft
from .utils import bucketing, graphs
from .utils.bucketing import bucket_length
from .utils.device import resolve_device
from .utils.profiling import span


@functools.lru_cache(maxsize=64)
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
    window="rect",
) -> FeatureConfig:
    """The config of a speechpy-family call (cached: a served call builds
    none)."""
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
        window=window,
    )


@functools.lru_cache(maxsize=64)
def _librosa_cfg(sr, n_fft, hop_length, win_length, n_mels, n_mfcc, fmin, fmax, power,
                 center) -> FeatureConfig:
    """The config of a librosa-family call (cached, as :func:`_speechpy_cfg`)."""
    return librosa_config(sr, n_fft, hop_length, win_length, n_mels, n_mfcc=n_mfcc, fmin=fmin,
                          fmax=fmax, power=power).replace(center=center)


@functools.lru_cache(maxsize=64)
def _uncentred(cfg: FeatureConfig) -> FeatureConfig:
    return cfg.replace(center=False)


def _prep(signal, cfg: FeatureConfig, bucket: bool, device):
    sig = torch.as_tensor(signal).to(device=resolve_device(device),
                                     dtype=getattr(torch, cfg.dtype))
    n = sig.shape[-1]
    if bucket:
        b = bucket_length(n)
        if b != n:
            sig = tF.pad(sig, (0, b - n))
    return sig, n


def _rows(x: torch.Tensor) -> int:
    """Rows of a (..., T) signal."""
    n = x.shape[-1]
    return x.numel() // n if n else math.prod(x.shape[:-1])


def _features(fn, signal, cfg: FeatureConfig, bucket: bool, device, key=None):
    """(``fn(bucketed signal, cfg)``, true length): eagerly on
    :func:`_prep`'s signal where :func:`.utils.graphs.runs_eagerly`, else
    through the graph of (``key``, default ``fn``; cfg; bucketed shape), the
    signal written into its static input and the bucket's tail zeroed."""
    x = torch.as_tensor(signal)
    dev = resolve_device(device)
    n = x.shape[-1]
    b = bucket_length(n) if bucket else n
    if graphs.runs_eagerly(x, dev):
        sig, n = _prep(x, cfg, bucket, dev)
        bucketing.samples.add(_rows(x), n, b)
        return fn(sig, cfg), n

    def fill(static):
        static[..., :n].copy_(x)
        if b > n:
            static[..., n:].zero_()

    bucketing.samples.add(_rows(x), n, b)
    return graphs.cache.run((fn if key is None else key, cfg), lambda s: fn(s, cfg),
                            x.shape[:-1] + (b,), getattr(torch, cfg.dtype), dev, fill), n


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
    with span("api.mfcc"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            num_cepstral, num_filters, fft_length, low_frequency,
                            high_frequency, dc_elimination, precision, dtype)
        out, n = _features(F.mfcc, signal, cfg, bucket, device)
        return out[..., : _frames_nopad(cfg, n), :]


def mfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Mel filterbank energies: ((..., F, num_filters), (..., F))."""
    with span("api.mfe"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        (feats, energies), n = _features(F.mfe, signal, cfg, bucket, device)
        k = _frames_nopad(cfg, n)
        return feats[..., :k, :], energies[..., :k]


def lmfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
         bucket=True, device=None):
    """Log mel filterbank energies, (..., F, num_filters)."""
    with span("api.lmfe"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        out, n = _features(F.lmfe, signal, cfg, bucket, device)
        return out[..., : _frames_nopad(cfg, n), :]


def ssc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Spectral subband centroids in Hz, (..., F, num_filters)."""
    with span("api.ssc"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        out, n = _features(F.ssc, signal, cfg, bucket, device)
        return out[..., : _frames_nopad(cfg, n), :]


def extract(signal, sampling_frequency, which=("mfcc",), frame_length=0.020,
            frame_stride=0.01, num_cepstral=13, num_filters=40, fft_length=512,
            low_frequency=0, high_frequency=None, dc_elimination=True, bucket=True,
            precision="high", dtype="float32", device=None):
    """Several speechpy-family features from one shared frontend pass.
    ``which`` ⊆ {"mfcc", "lmfe", "mfe", "ssc", "energy"}; returns a dict of
    tensors (``"mfe"`` maps to a (features, energies) pair).  Cheaper than
    the separate entry points when several features are wanted; the
    ``mfcc`` head is the plain chunk-GEMM path, not the fused kernel."""
    with span("api.extract"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            num_cepstral, num_filters, fft_length, low_frequency,
                            high_frequency, dc_elimination, precision, dtype)
        which = tuple(which)
        feats, n = _features(lambda s, c: F.extract(s, c, which), signal, cfg, bucket, device,
                             key=(F.extract, which))
        k = _frames_nopad(cfg, n)
        out = {}
        for name, val in feats.items():
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
    with span("api.mel_spectrogram"):
        sig_in = torch.as_tensor(signal)
        if sig_in.ndim > 2:
            raise ValueError("mel_spectrogram supports only 1-D or 2-D input")
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            num_cepstral, num_filters, fft_length, low_frequency,
                            high_frequency, dc_elimination, window="vorbis")
        out, n = _features(F.mel_spectrogram, sig_in, cfg, bucket, device)
        t_true = -(-n // cfg.stream_hop)
        out = out[..., :t_true]
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


@tensor_cache(maxsize=64)
def _edge_index(n: int, half: int, mode: str, device: torch.device):
    """(where, what): the positions of the centre pad's two edges in the
    padded signal of n samples, and the samples of the signal that each
    reads (:func:`.ops.framing.pad_index`)."""
    where = torch.cat([torch.arange(half, device=device),
                       torch.arange(half + n, n + 2 * half, device=device)])
    what = torch.cat([_framing.pad_index(-half, 0, n, mode, device),
                      _framing.pad_index(n, n + half, n, mode, device)])
    return where, what


def _librosa(fn, y, cfg: FeatureConfig, bucket: bool, device):
    """(``fn`` of the centre-padded, bucketed signal, true frame count), as
    :func:`_prep_librosa` pads it: eagerly where
    :func:`.utils.graphs.runs_eagerly`, else through the graph of (``fn``,
    the uncentred cfg, bucketed shape), the signal written into its static
    input between the two edges of the centre pad, then the bucket's zeros."""
    x = torch.as_tensor(y)
    dev = resolve_device(device)
    n = x.shape[-1]
    half = cfg.fft_points // 2 if cfg.center else 0
    t = n + 2 * half
    b = bucket_length(t) if bucket else t
    if graphs.runs_eagerly(x, dev):
        sig, ucfg, count = _prep_librosa(x, cfg, bucket, dev)
        bucketing.samples.add(_rows(x), t, b)
        return fn(sig, ucfg), count
    count = _stft.librosa_frame_count(n, cfg.fft_points, cfg.frame_step, cfg.center)
    # librosa_config pads in "reflect"; raises for n = 0, as pad_signal does
    where, what = _edge_index(n, half, cfg.pad_mode, dev) if half else (None, None)
    cfg = _uncentred(cfg)

    def fill(static):
        body = static[..., half:half + n]
        body.copy_(x)
        if half:
            static.index_copy_(-1, where, body.index_select(-1, what))
        if b > t:
            static[..., t:].zero_()

    bucketing.samples.add(_rows(x), t, b)
    return graphs.cache.run((fn, cfg), lambda s: fn(s, cfg), x.shape[:-1] + (b,),
                            getattr(torch, cfg.dtype), dev, fill), count


def mel_spectrogram_librosa(y, sr=22050, n_fft=2048, hop_length=512, win_length=None,
                            n_mels=128, fmin=0.0, fmax=None, power=2.0, center=True,
                            bucket=True, device=None):
    """librosa-compatible mel spectrogram, (..., n_mels, frames)."""
    with span("api.mel_spectrogram_librosa"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, win_length, n_mels, 20, fmin, fmax, power, center)
        out, count = _librosa(F.mel_spectrogram_librosa, y, cfg, bucket, device)
        return out[..., :count]


def log_mel_spectrogram(y, sr=22050, n_fft=2048, hop_length=512, n_mels=128, fmin=0.0,
                        fmax=None, center=True, bucket=True, device=None):
    """librosa ``power_to_db(melspectrogram)``.  Bucket frames are all-zero
    power, so they can neither raise the top_db reference maximum nor
    survive the final slice."""
    with span("api.log_mel_spectrogram"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, None, n_mels, 20, fmin, fmax, 2.0, center)
        out, count = _librosa(F.log_mel_spectrogram, y, cfg, bucket, device)
        return out[..., :count]


def mfcc_librosa(y, sr=22050, n_mfcc=20, n_fft=2048, hop_length=512, n_mels=128,
                 fmin=0.0, fmax=None, center=True, bucket=True, device=None):
    """librosa-compatible MFCC, (..., n_mfcc, frames)."""
    with span("api.mfcc_librosa"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, None, n_mels, n_mfcc, fmin, fmax, 2.0, center)
        out, count = _librosa(F.mfcc_librosa, y, cfg, bucket, device)
        return out[..., :count]
