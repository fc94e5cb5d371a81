"""Feature-extraction configuration (PyTorch port of ``mfcc_rust_tpu.config``).

A frozen, hashable dataclass: every constant of a pipeline (filterbank,
windowed DFT wall, DCT) is a pure function of it, so it doubles as the cache
key for the constant tensors (:mod:`.constants`).  The fields, defaults and
properties are the JAX package's, field for field, so a reference config
carries over whole through :func:`from_reference`.

Precision mapping.  ``precision`` keeps the reference's values ("highest",
"high", "default"), which count TPU MXU passes.  In this port every value
computes in IEEE FP32 (no TF32, no BF16): the plain path runs its products
under :func:`fp32_matmul`, which sets cuBLAS to FP32 for the call and
restores the caller's setting after it, and the fused CUDA kernel is plain
FP32 FMA.  The field is kept so that configs round-trip unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Hashable hyper-parameter bundle for the whole feature pipeline.

    Defaults mirror the reference builder defaults: fft 512, 20 ms frames,
    10 ms stride, 13 cepstra, 40 mels, 0..fs/2 Hz, dc_elimination=True.
    """

    sample_rate: int
    fft_points: int = 512
    frame_length: float = 0.02
    frame_stride: float = 0.01
    num_cepstral: int = 13
    num_filters: int = 40
    low_frequency: float = 0.0
    high_frequency: Optional[float] = None  # None -> sample_rate / 2
    dc_elimination: bool = True

    window: str = "rect"  # rect | hann | hann_sym | hamming | povey | vorbis
    win_length_samples: Optional[int] = None  # None -> frame size
    frame_length_samples: Optional[int] = None
    frame_stride_samples: Optional[int] = None
    mel_scale: str = "speechpy"  # speechpy (1127*ln) | htk | slaney
    fbank_style: str = "speechpy"  # speechpy (integer bin edges) | librosa
    fbank_norm: Optional[str] = None  # None | "slaney"
    center: bool = False
    pad_mode: str = "reflect"
    preemphasis_cof: float = 0.0  # applied before framing when nonzero
    power: float = 2.0
    # "matmul" (DFT as two products), "fft" (torch.fft.rfft), "ct"
    # (two-stage Cooley-Tukey products, ops/fft.py) or "auto" (matmul for
    # fft <= 1024, else ct)
    fft_impl: str = "auto"
    # every value computes in IEEE FP32 here (see the module docstring)
    precision: str = "high"
    # fused CUDA kernel dispatch: "auto"/"force" run it on CUDA tensors when
    # the config qualifies, "off" always takes the plain PyTorch path
    pallas: str = "auto"
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.fft_points <= 0 or self.sample_rate <= 0:
            raise ValueError("fft_points and sample_rate must be positive")
        if self.high_frequency is not None and (
            self.high_frequency > self.sample_rate / 2.0
        ):
            raise ValueError(
                "High frequency cannot be greater than half of the sampling"
                " frequency!"
            )
        if self.low_frequency < 0.0:
            raise ValueError("low frequency cannot be less than zero!")
        if self.window == "vorbis":
            if not (0 < self.stream_hop <= self.fft_points):
                raise ValueError(
                    f"vorbis/streaming configs require 0 < frame samples "
                    f"({self.stream_hop}) <= fft_points ({self.fft_points})"
                )

    @property
    def resolved_high_frequency(self) -> float:
        return (
            self.high_frequency
            if self.high_frequency is not None
            else self.sample_rate / 2.0
        )

    @property
    def freq_size(self) -> int:
        """Number of rFFT bins, ``fft_points // 2 + 1``."""
        return self.fft_points // 2 + 1

    @property
    def frame_size(self) -> int:
        """speechpy framing frame length in samples: round(len*fs)."""
        if self.frame_length_samples is not None:
            return self.frame_length_samples
        return int(round(self.sample_rate * self.frame_length))

    @property
    def frame_step(self) -> int:
        """speechpy framing hop in samples: round(stride*fs)."""
        if self.frame_stride_samples is not None:
            return self.frame_stride_samples
        return int(round(self.sample_rate * self.frame_stride))

    @property
    def win_length(self) -> int:
        return (
            self.win_length_samples
            if self.win_length_samples is not None
            else self.frame_size
        )

    @property
    def stream_hop(self) -> int:
        """Streaming-STFT hop: frame_length*fs truncated, frame_stride
        ignored."""
        if self.frame_length_samples is not None:
            return self.frame_length_samples
        return int(self.sample_rate * self.frame_length)

    @property
    def stream_mem(self) -> int:
        return self.fft_points - self.stream_hop

    @property
    def stream_n_pad(self) -> int:
        return self.fft_points // self.stream_hop - 1

    @property
    def wnorm(self) -> float:
        return 1.0 / (self.fft_points**2 / (2.0 * self.stream_hop))

    def replace(self, **kw) -> "FeatureConfig":
        return dataclasses.replace(self, **kw)


def from_reference(d: dict) -> FeatureConfig:
    """Build the port's config from ``dataclasses.asdict`` of a JAX
    ``FeatureConfig``.  This system has no weights: the config determines
    every constant, so it is all the state there is to carry across."""
    names = {f.name for f in dataclasses.fields(FeatureConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown FeatureConfig fields {sorted(unknown)}")
    return FeatureConfig(**d)


@contextlib.contextmanager
def fp32_matmul():
    """Run the enclosed float32 products in IEEE FP32 on cuBLAS (no TF32),
    whatever the process-wide setting, and restore that setting after."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def speechpy_config(sample_rate: int, **kw) -> FeatureConfig:
    """speechpy-compatible preset: rectangular window, integer-bin mel
    filterbank with the 1127*ln mel scale."""
    return FeatureConfig(sample_rate=sample_rate, **kw)


def librosa_config(
    sample_rate: int = 22050,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    n_mels: int = 128,
    n_mfcc: int = 20,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    **kw,
) -> FeatureConfig:
    """librosa-compatible preset: periodic hann window, centred
    reflect-padded STFT, Slaney mel scale and Slaney area norm."""
    hop_length = hop_length if hop_length is not None else n_fft // 4
    win_length = win_length if win_length is not None else n_fft
    return FeatureConfig(
        sample_rate=sample_rate,
        fft_points=n_fft,
        frame_length_samples=n_fft,
        frame_stride_samples=hop_length,
        win_length_samples=win_length,
        num_filters=n_mels,
        num_cepstral=n_mfcc,
        low_frequency=fmin,
        high_frequency=fmax,
        window="hann",
        mel_scale="slaney",
        fbank_style="librosa",
        fbank_norm="slaney",
        center=True,
        pad_mode="reflect",
        dc_elimination=False,
        **kw,
    )


def vorbis_config(sample_rate: int, **kw) -> FeatureConfig:
    """The reference's streaming ("DFN") mel-spectrogram preset: vorbis
    analysis window, hop = frame length, wnorm scaling."""
    return FeatureConfig(sample_rate=sample_rate, window="vorbis", **kw)


class SpeechConfigBuilder:
    """Fluent builder with the reference's surface.

    >>> cfg = SpeechConfigBuilder(16000).fft_points(512).num_cepstral(13).build()
    """

    def __init__(self, sample_rate: int = 16000):
        self._kw = dict(sample_rate=sample_rate)

    def sample_rate(self, v: int) -> "SpeechConfigBuilder":
        self._kw["sample_rate"] = int(v)
        return self

    def fft_points(self, v: int) -> "SpeechConfigBuilder":
        self._kw["fft_points"] = int(v)
        return self

    def frame_length(self, v: float) -> "SpeechConfigBuilder":
        self._kw["frame_length"] = float(v)
        return self

    def frame_stride(self, v: float) -> "SpeechConfigBuilder":
        self._kw["frame_stride"] = float(v)
        return self

    def num_cepstral(self, v: int) -> "SpeechConfigBuilder":
        self._kw["num_cepstral"] = int(v)
        return self

    def num_filters(self, v: int) -> "SpeechConfigBuilder":
        self._kw["num_filters"] = int(v)
        return self

    def low_freq(self, v: float) -> "SpeechConfigBuilder":
        self._kw["low_frequency"] = float(v)
        return self

    def high_freq(self, v: float) -> "SpeechConfigBuilder":
        self._kw["high_frequency"] = float(v)
        return self

    def dc_elimination(self, v: bool) -> "SpeechConfigBuilder":
        self._kw["dc_elimination"] = bool(v)
        return self

    def window(self, v: str) -> "SpeechConfigBuilder":
        self._kw["window"] = str(v)
        return self

    def build(self) -> FeatureConfig:
        return FeatureConfig(**self._kw)
