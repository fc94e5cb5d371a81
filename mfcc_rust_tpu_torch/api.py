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
JAX package calls ``_jitted``.  One writer (:func:`_writer`) decides how a
caller's signal becomes the computation's input: cast to the config's
dtype, the librosa centre pad's edges around it (the pad must see the
signal's true edge, not the bucket's zeros) and the bucket's zero tail.
One runner (:func:`_run`) writes that input into the static input of one
CUDA graph per (function, config, bucketed shape) from
:mod:`.utils.graphs` and trims a fresh copy of the graph's output; few
buckets mean few captures.  It writes into a fresh tensor and runs eagerly
on the CPU and for an input that requires a gradient
(:func:`.utils.graphs.runs_eagerly`), so the two paths' answers are equal
bit for bit.  Each entry point runs in its span ``api.<name>``
(:func:`.utils.profiling.span`) and counts its true and bucketed samples
(:data:`.utils.bucketing.samples`).

A call that is one kernel launch needs no graph: ``mfcc`` whose lowering
is K1 alone (:func:`_k1_alone`), and ``mel_spectrogram_librosa`` whose
lowering is K2 alone (:func:`_k2_alone`), launch the kernel once on the
caller's stream, reading the caller's signal where it lies at its true
length (K2 stages the reflect centre pad's edges itself, so the pad is no
launch), into a fresh result of exactly the frames the call returns
(:func:`_direct`, span ``api.direct``); ``bucket`` changes nothing there,
as no frame it would add was ever returned.  ``log_mel_spectrogram_whisper``
takes the same path with K2, then the Whisper finish
(``ops/cuda/whisper_logmel``), and ``log_mel_spectrogram_nemo`` with NeMo's
prologue in place of the centre pad, K2, then the NeMo finish
(``ops/cuda/nemo_logmel``); the NeMo call takes each row's length as data
and never buckets.  :data:`paths` counts the calls of every family by the
path each took.
"""

from __future__ import annotations

import functools
import math
import threading

import torch

from . import features as F
from .config import FeatureConfig, librosa_config
from .constants import tensor_cache
from .ops import delta as _delta
from .ops import framing as _framing
from .ops import normalize as _normalize
from .ops import resample as _resample
from .ops import spectrum as _spectrum
from .ops import stft as _stft
from .ops.cuda import ct_mel as _k2
from .ops.cuda import nemo_logmel as _nl
from .ops.cuda import speechpy_mfcc as _k1
from .ops.cuda import whisper_logmel as _wl
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
@functools.lru_cache(maxsize=64)
def _uncentred(cfg: FeatureConfig) -> FeatureConfig:
    return cfg.replace(center=False)


def _rows(x: torch.Tensor) -> int:
    """Rows of a (..., T) signal."""
    n = x.shape[-1]
    return x.numel() // n if n else math.prod(x.shape[:-1])


class PathCount:
    """Cumulative calls of the feature entry points of both families (those
    through :func:`_run` or :func:`_direct`, and NeMo's) by the path each
    took: ``direct`` (one launch of K1 or of K2, and for Whisper the
    finish, or for NeMo its prologue, K2 and its finish, on the caller's
    signal), ``graphed`` (through
    :data:`.utils.graphs.cache`) and ``eager``."""

    DIRECT, GRAPHED, EAGER = range(3)

    def __init__(self):
        self.counts = [0, 0, 0]
        self._lock = threading.Lock()

    def add(self, path: int) -> None:
        self._lock.acquire()  # as ``SampleCount.add``: half the host time of a ``with``
        try:
            self.counts[path] += 1
        finally:
            self._lock.release()

    def read(self) -> dict:
        """{"direct": …, "graphed": …, "eager": …}."""
        with self._lock:
            return dict(zip(("direct", "graphed", "eager"), self.counts))


paths = PathCount()


@tensor_cache(maxsize=64)
def _edge_index(n: int, half: int, mode: str, device: torch.device):
    """(where, what): the positions of the centre pad's two edges in the
    padded signal of n samples, and the samples of the signal that each
    reads (:func:`.ops.framing.pad_index`; raises for n = 0)."""
    where = torch.cat([torch.arange(half, device=device),
                       torch.arange(half + n, n + 2 * half, device=device)])
    what = torch.cat([_framing.pad_index(-half, 0, n, mode, device),
                      _framing.pad_index(n, n + half, n, mode, device)])
    return where, what


def _writer(x: torch.Tensor, cfg: FeatureConfig, bucket: bool, dev: torch.device):
    """How the signal ``x`` (..., n) of a call becomes the computation's
    input, worked out once: (``write``, the input's shape, the config it is
    computed under, its true samples t).  ``write(dst)`` fills ``dst`` of
    that shape and returns it: x cast to dst's dtype at [half, half + n),
    half = ``cfg.fft_points // 2`` when ``cfg.center`` and 0 otherwise; the
    centre pad's two edges in ``cfg.pad_mode`` beside it, read from that
    body (:func:`_edge_index`), to t = n + 2 half; zeros past t to the
    bucket (t itself with ``bucket`` false).  With the pad written, the
    config is ``cfg`` uncentred."""
    n = x.shape[-1]
    half = cfg.fft_points // 2 if cfg.center else 0
    t = n + 2 * half
    b = bucket_length(t) if bucket else t
    if half:
        where, what = _edge_index(n, half, cfg.pad_mode, dev)
        cfg = _uncentred(cfg)

    def write(dst: torch.Tensor) -> torch.Tensor:
        body = dst[..., half:half + n]
        body.copy_(x)
        if half:
            dst.index_copy_(-1, where, body.index_select(-1, what))
        if b > t:
            dst[..., t:].zero_()
        return dst

    return write, x.shape[:-1] + (b,), cfg, t


def _run(fn, signal, cfg: FeatureConfig, bucket: bool, device, key=None):
    """(``fn(input, config)``, true length n) of :func:`_writer`'s input
    and config: eagerly on a fresh input where
    :func:`.utils.graphs.runs_eagerly`, else through the graph of (``key``,
    default ``fn``; the config; the input's shape), the input written into
    its static input."""
    x, dev = torch.as_tensor(signal), resolve_device(device)
    write, shape, ucfg, t = _writer(x, cfg, bucket, dev)
    dtype = getattr(torch, cfg.dtype)
    bucketing.samples.add(_rows(x), t, shape[-1])
    if graphs.runs_eagerly(x, dev):
        paths.add(PathCount.EAGER)
        return fn(write(torch.empty(shape, dtype=dtype, device=dev)), ucfg), x.shape[-1]
    paths.add(PathCount.GRAPHED)
    return graphs.cache.run((fn if key is None else key, ucfg), lambda s: fn(s, ucfg), shape,
                            dtype, dev, write), x.shape[-1]


def _k1_alone(cfg: FeatureConfig, x: torch.Tensor, dev: torch.device) -> bool:
    """Whether an MFCC of ``x`` computing on ``dev`` is one launch of K1 and
    nothing else: its lowering is the fused kernel
    (:func:`.features.speechpy_lowering`), with no preemphasis, on a call
    that would otherwise replay a graph (:func:`.utils.graphs.runs_eagerly`
    false: no gradient recorded, no trace or enclosing capture, not inside
    :func:`.utils.graphs.disabled`), of at least one sample (K1's wrapper
    cannot lay out rows of none)."""
    return (F.speechpy_lowering(cfg, "mfcc", dev.type, getattr(torch, cfg.dtype)) == "k1"
            and not cfg.preemphasis_cof and x.shape[-1] > 0
            and not graphs.runs_eagerly(x, dev))


def _direct(kernel, x: torch.Tensor, cfg: FeatureConfig, dev: torch.device):
    """``kernel(signal, cfg)`` where :func:`_k1_alone` or :func:`_k2_alone`
    (or NeMo's :func:`_nemo_direct`): launched once on the caller's current
    stream, reading ``x`` where it lies (moved to ``dev`` and float32 only if
    it is not there already) at its true length n, no bucket and no static
    input, into a fresh result of exactly the frames the call returns, each
    read from samples below n or their reflection.  Nothing is padded here:
    a centred call's kernel pads (K2 stages the reflect pad's edges,
    ``ops/cuda/ct_mel``; NeMo's prologue writes its zero pad), and the
    samples counted are the centre-padded length."""
    with span("api.direct"):
        sig = x.to(device=dev, dtype=torch.float32)
        t = sig.shape[-1] + (2 * (cfg.fft_points // 2) if cfg.center else 0)
        bucketing.samples.add(_rows(sig), t, t)
        paths.add(PathCount.DIRECT)
        return kernel(sig, cfg)


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
        x, dev = torch.as_tensor(signal), resolve_device(device)
        if _k1_alone(cfg, x, dev):
            return _direct(_k1.mfcc_fused, x, cfg, dev)
        out, n = _run(F.mfcc, x, cfg, bucket, dev)
        return out[..., : _frames_nopad(cfg, n), :]


def mfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Mel filterbank energies: ((..., F, num_filters), (..., F))."""
    with span("api.mfe"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        (feats, energies), n = _run(F.mfe, signal, cfg, bucket, device)
        k = _frames_nopad(cfg, n)
        return feats[..., :k, :], energies[..., :k]


def lmfe(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
         num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
         bucket=True, device=None):
    """Log mel filterbank energies, (..., F, num_filters)."""
    with span("api.lmfe"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        out, n = _run(F.lmfe, signal, cfg, bucket, device)
        return out[..., : _frames_nopad(cfg, n), :]


def ssc(signal, sampling_frequency, frame_length=0.020, frame_stride=0.01,
        num_filters=40, fft_length=512, low_frequency=0, high_frequency=None,
        bucket=True, device=None):
    """Spectral subband centroids in Hz, (..., F, num_filters)."""
    with span("api.ssc"):
        cfg = _speechpy_cfg(sampling_frequency, frame_length, frame_stride,
                            13, num_filters, fft_length, low_frequency, high_frequency)
        out, n = _run(F.ssc, signal, cfg, bucket, device)
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
        feats, n = _run(lambda s, c: F.extract(s, c, which), signal, cfg, bucket, device,
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
        out, n = _run(F.mel_spectrogram, sig_in, cfg, bucket, device)
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
def _librosa_frames(cfg: FeatureConfig, n: int) -> int:
    """Frames of a librosa-family call on n samples."""
    return _stft.librosa_frame_count(n, cfg.fft_points, cfg.frame_step, cfg.center)


@functools.lru_cache(maxsize=64)
def _librosa_lowering(cfg: FeatureConfig, device_type: str) -> str:
    """:func:`.features.librosa_lowering` of a float32 call on ``device_type``,
    cached: a pure function of the frozen config whose kernel checks would
    otherwise cost every direct call host time of the order of a launch."""
    return F.librosa_lowering(cfg, device_type, torch.float32)


def _k2_alone(cfg: FeatureConfig, x: torch.Tensor, dev: torch.device) -> bool:
    """Whether a librosa mel spectrogram of ``x`` computing on ``dev`` is one
    launch of K2: its lowering is the CT mel kernel
    (:func:`.features.librosa_lowering`), on a call that would otherwise
    replay a graph (:func:`.utils.graphs.runs_eagerly` false), centred, of
    a length at which K2 stages the centre pad itself
    (:func:`.ops.cuda.ct_mel.staged_half`: the reflect pad folds at most
    once; shorter clips keep the graph), of at least one sample otherwise."""
    return ((_k2.staged_half(x, cfg) > 0 if cfg.center else x.shape[-1] > 0)
            and _librosa_lowering(cfg, dev.type) == "k2"
            and not graphs.runs_eagerly(x, dev))


def _k2_mel(sig: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """K2 on the caller's signal, its centre pad included, (..., n_mels,
    frames)."""
    return _k2.ct_mel(sig, cfg).transpose(-1, -2)


def mel_spectrogram_librosa(y, sr=22050, n_fft=2048, hop_length=512, win_length=None,
                            n_mels=128, fmin=0.0, fmax=None, power=2.0, center=True,
                            bucket=True, device=None):
    """librosa-compatible mel spectrogram, (..., n_mels, frames).  A call that
    is one launch of K2 (:func:`_k2_alone`) takes
    :func:`_direct`, where ``bucket`` changes nothing: no frame it would
    add was ever returned."""
    with span("api.mel_spectrogram_librosa"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, win_length, n_mels, 20, fmin, fmax, power, center)
        x, dev = torch.as_tensor(y), resolve_device(device)
        if _k2_alone(cfg, x, dev):
            return _direct(_k2_mel, x, cfg, dev)
        out, n = _run(F.mel_spectrogram_librosa, x, cfg, bucket, dev)
        return out[..., :_librosa_frames(cfg, n)]


def log_mel_spectrogram(y, sr=22050, n_fft=2048, hop_length=512, n_mels=128, fmin=0.0,
                        fmax=None, center=True, bucket=True, device=None):
    """librosa ``power_to_db(melspectrogram)``.  Bucket frames are all-zero
    power, so they can neither raise the top_db reference maximum nor
    survive the final slice."""
    with span("api.log_mel_spectrogram"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, None, n_mels, 20, fmin, fmax, 2.0, center)
        out, n = _run(F.log_mel_spectrogram, y, cfg, bucket, device)
        return out[..., :_librosa_frames(cfg, n)]


def mfcc_librosa(y, sr=22050, n_mfcc=20, n_fft=2048, hop_length=512, n_mels=128,
                 fmin=0.0, fmax=None, center=True, bucket=True, device=None):
    """librosa-compatible MFCC, (..., n_mfcc, frames)."""
    with span("api.mfcc_librosa"):
        cfg = _librosa_cfg(sr, n_fft, hop_length, None, n_mels, n_mfcc, fmin, fmax, 2.0, center)
        out, n = _run(F.mfcc_librosa, y, cfg, bucket, device)
        return out[..., :_librosa_frames(cfg, n)]


# ------------------------------------------------------------ Whisper API --
@functools.lru_cache(maxsize=8)
def _whisper_cfg(n_mels: int) -> FeatureConfig:
    """Whisper's front end: 16 kHz, n_fft 400, hop 160, a periodic hann of
    400, centred reflect pad, power 2, ``n_mels`` slaney mels (cached)."""
    return librosa_config(16000, 400, 160, 400, n_mels)


def _whisper_k2(sig: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """K2 on the caller's signal, its centre pad included, then the Whisper
    finish: (..., n_mels, frames - 1)."""
    return _wl.whisper_logmel(_k2.ct_mel(sig, cfg))


def log_mel_spectrogram_whisper(audio, n_mels=80, padding=0, bucket=True, device=None):
    """Whisper's log-mel spectrogram (openai/whisper ``log_mel_spectrogram``;
    the floor 8 decades below each row's own maximum, as transformers'
    ``WhisperFeatureExtractor`` takes it for a batch): (..., n) float audio
    at 16 kHz, ``padding`` zeros appended first, -> (..., n_mels, (n +
    padding) // 160), float32, contiguous.  Where the mel power is one
    launch of K2 (:func:`_k2_alone`) the call takes
    :func:`_direct` with the finish kernel after K2; else the mel power
    through :func:`_run` and :func:`.features.whisper_finish` of its true
    frames (a bucket's frames must not enter the row's maximum)."""
    with span("api.log_mel_spectrogram_whisper"):
        cfg = _whisper_cfg(int(n_mels))
        x, dev = torch.as_tensor(audio), resolve_device(device)
        if padding:
            x = torch.nn.functional.pad(x, (0, int(padding)))
        if _k2_alone(cfg, x, dev) and _wl.whisper_logmel_supported(cfg):
            return _direct(_whisper_k2, x, cfg, dev)
        mel, n = _run(F.mel_spectrogram_librosa, x, cfg, bucket, dev)
        return F.whisper_finish(mel[..., :_librosa_frames(cfg, n)])


# --------------------------------------------------------------- NeMo API --
@functools.lru_cache(maxsize=8)
def _nemo_cfg(n_mels: int) -> FeatureConfig:
    """NeMo FastConformer's front end (``AudioToMelSpectrogramPreprocessor``
    as nvidia/parakeet-tdt-0.6b-v2 sets it): 16 kHz, n_fft 512, hop 160, a
    symmetric hann of 400 centred in 512, a centred zero pad, preemphasis
    0.97, power 2, ``n_mels`` slaney mels (cached)."""
    return librosa_config(16000, 512, 160, 400, n_mels).replace(
        window="hann_sym", pad_mode="constant", preemphasis_cof=0.97)


def _nemo_lengths(lengths, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The rows' sample lengths as int64 on ``dev``, of x's leading shape."""
    n = torch.as_tensor(lengths, device=dev)
    if n.dtype != torch.int64:
        n = n.to(torch.int64)
    if tuple(n.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"lengths of shape {tuple(n.shape)} for audio of shape "
                         f"{tuple(x.shape)}: one length a row")
    return n


def _nemo_direct(cfg: FeatureConfig, x: torch.Tensor, dev: torch.device) -> bool:
    """Whether a NeMo call on ``x`` computing on ``dev`` is the prologue, one
    launch of K2 and the finish: the mel power's lowering is the CT mel
    kernel (:func:`.features.librosa_lowering`), the finish takes the config,
    and the call would not run eagerly (:func:`.utils.graphs.runs_eagerly`).
    The zero pad never folds, so every length takes it."""
    return (_librosa_lowering(cfg, dev.type) == "k2" and _nl.nemo_finish_supported(cfg)
            and not graphs.runs_eagerly(x, dev))


def log_mel_spectrogram_nemo(audio, lengths, n_mels=128, device=None):
    """NeMo FastConformer's log-mel features (Parakeet-TDT, Canary:
    ``AudioToMelSpectrogramPreprocessor`` → ``FilterbankFeatures.forward``
    in eval, ``normalize="per_feature"``) of (..., T) float audio at 16 kHz
    whose rows hold ``lengths`` (...,) samples (a tensor on any device, a
    list or numpy) -> (features (..., n_mels, 1 + T // 160) float32
    contiguous, feature_lengths (...,) int64): preemphasis
    0.97 within each row's length and zeros past it; a centred zero-padded
    STFT of 512 points at a hop of 160 with a symmetric hann of 400; |X|²;
    slaney mels; ln(· + 2^-24); over each row's first len // 160 + 1 frames
    (0 where len is 0) each mel's mean and unbiased deviation + 1e-5, the
    normalised values there and zeros past them.

    Where the mel power is one launch of K2 (:func:`_nemo_direct`) the call
    takes :func:`_direct` with :func:`.ops.cuda.nemo_logmel.nemo_direct`:
    the prologue kernel in place of the centre pad (it also writes each
    row's frame count), K2 on the tiles that hold each row's own frames, the
    finish kernels, all on the caller's stream with no host synchronisation
    (the lengths are read on the device), so the card's work follows the
    rows' own frames more than the padding; else (CPU,
    gradient, trace) the plain path :func:`.features.nemo_log_mel`, eagerly.

    Departures from NeMo: a row of one frame reads zeros where NeMo raises
    (its masked formula gives zeros there; the check would cost a host
    synchronisation); the training-time dither is left out (the eval
    forward); a length past T counts its frames as NeMo does, and its
    statistics take the frames there are."""
    with span("api.log_mel_spectrogram_nemo"):
        cfg = _nemo_cfg(int(n_mels))
        x, dev = torch.as_tensor(audio), resolve_device(device)
        n = _nemo_lengths(lengths, x, dev)
        if _nemo_direct(cfg, x, dev):
            return _direct(lambda s, c: _nl.nemo_direct(s, n, c), x, cfg, dev)
        t = x.shape[-1] + cfg.fft_points
        bucketing.samples.add(_rows(x), t, t)
        paths.add(PathCount.EAGER)
        return F.nemo_log_mel(x.to(device=dev, dtype=torch.float32), n, cfg)
