"""The benchmark's plain reference at the timed sizes: the float64 oracles
of :mod:`speechpy_ref` and :mod:`librosa_ref`, written as batched PyTorch
so that they run on the card (or the CPU) in blocks.

Every constant (mel filterbank, DCT matrix, window) comes from the frozen
numpy oracles, so the two agree to float64 rounding; a CPU test holds them
together.  Nothing here imports the program.

``precision="tf32"`` is the control: the same functions in float32 with
every product (the DFT as a product, the mel projection, the DCT) taking
TF32 inputs, rounded here to TF32's 10-bit mantissa so that the control
is the same on the card and on the CPU.  It stands for the step a later
change would be tempted to take below the configuration's IEEE float32.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.fft
import torch

from . import librosa_ref, speechpy_ref

PRECISIONS = ("float64", "tf32")


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits, to nearest,
    ties away from zero), as the tensor cores read a TF32 product's inputs."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=16)
def _dct_matrix(m: int, c: int) -> np.ndarray:
    """(m, c): x @ D == scipy.fft.dct(x, type=2, norm="ortho")[..., :c]."""
    return scipy.fft.dct(np.eye(m), type=2, axis=-1, norm="ortho")[:, :c]


@functools.lru_cache(maxsize=16)
def _dft_matrix(n_in: int, n_fft: int) -> np.ndarray:
    """(n_in, 2 * (n_fft // 2 + 1)): the real and imaginary parts of the rfft
    of n_fft points of a frame of n_in samples (zero-padded), as a product."""
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(np.arange(n_in), k) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _const(a: np.ndarray, precision: str, device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=_dtype(precision), device=device)
    return tf32(t) if precision == "tf32" else t


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float64, or in float32 with TF32 inputs (b already rounded)."""
    if precision == "tf32":
        a = tf32(a)
    return a @ b


def _power(frames: torch.Tensor, n_fft: int, precision: str, device) -> torch.Tensor:
    """|rfft(frames, n_fft)|^2: float64 by the FFT, tf32 by the DFT product."""
    if precision == "float64":
        return torch.fft.rfft(frames, n=n_fft, dim=-1).abs().square()
    dft = _const(_dft_matrix(frames.shape[-1], n_fft), precision, device)
    ri = _mm(frames, dft, precision)
    h = n_fft // 2 + 1
    return ri[..., :h].square() + ri[..., h:].square()


# ------------------------------------------------------------- speechpy --
def speechpy_frames(x: torch.Tensor, sample_rate: int, frame_length: float,
                    frame_stride: float) -> torch.Tensor:
    """(..., F, fl) frames of (..., T) signals, speechpy's count without zero
    padding (``speechpy_ref.stack_frames``, ``zero_padding=False``)."""
    fl = int(round(sample_rate * frame_length))
    step = int(round(sample_rate * frame_stride))
    num, _ = speechpy_ref.stack_frames_counts(x.shape[-1], fl, step, False)
    if num <= 0:
        return x.new_zeros(x.shape[:-1] + (0, fl))
    return x.unfold(-1, fl, step)[..., :num, :]


def speechpy_mfcc_of_frames(frames: torch.Tensor, sample_rate: int, num_cepstral=13,
                            num_filters=40, fft_length=512, low_frequency=0.0,
                            high_frequency=None, dc_elimination=True,
                            precision="float64") -> torch.Tensor:
    """``speechpy_ref.mfcc`` of (..., fl) frames: (..., num_cepstral)."""
    dev = frames.device
    frames = frames.to(_dtype(precision))
    ps = _power(frames, fft_length, precision, dev) / fft_length
    fb = speechpy_ref.filterbanks(num_filters, fft_length // 2 + 1, sample_rate,
                                  low_frequency, high_frequency)
    eps = speechpy_ref.EPS32
    energy = ps.sum(-1)
    energy = torch.where(energy == 0.0, torch.full_like(energy, eps), energy)
    feat = _mm(ps, _const(fb.T, precision, dev), precision)
    feat = torch.where(feat == 0.0, torch.full_like(feat, eps), feat)
    out = _mm(feat.log(), _const(_dct_matrix(num_filters, num_cepstral), precision, dev),
              precision)
    if dc_elimination:
        out[..., 0] = energy.log()
    return out


def speechpy_mfcc(x: torch.Tensor, sample_rate: int, frame_length=0.020, frame_stride=0.01,
                  precision="float64", **kw) -> torch.Tensor:
    """``speechpy_ref.mfcc`` of (..., T) signals: (..., F, num_cepstral)."""
    x = x.to(_dtype(precision))
    frames = speechpy_frames(x, sample_rate, frame_length, frame_stride)
    return speechpy_mfcc_of_frames(frames, sample_rate, precision=precision, **kw)


# -------------------------------------------------------------- librosa --
def librosa_mel(y: torch.Tensor, sr=22050, n_fft=2048, hop_length=512, n_mels=128,
                fmin=0.0, fmax=None, power=2.0, precision="float64") -> torch.Tensor:
    """``librosa_ref.melspectrogram`` (centred reflect pad, periodic hann,
    win_length = n_fft) of (B, T) signals: (B, n_mels, F)."""
    dev = y.device
    y = y.to(_dtype(precision))
    half = n_fft // 2
    y = torch.nn.functional.pad(y.unsqueeze(1), (half, half), mode="reflect").squeeze(1)
    frames = y.unfold(-1, n_fft, hop_length)
    win = torch.as_tensor(librosa_ref.hann_periodic(n_fft), dtype=frames.dtype, device=dev)
    frames = frames * win
    mag2 = _power(frames, n_fft, precision, dev)
    s = mag2 if power == 2.0 else mag2.sqrt() ** power
    fb = librosa_ref.mel_filters(sr, n_fft, n_mels, fmin, fmax)
    return _mm(s, _const(fb.T, precision, dev), precision).transpose(-1, -2)


FUNCTIONS = {"speechpy_mfcc": speechpy_mfcc, "librosa_mel": librosa_mel}


def filterbank_nonzeros(name: str, kwargs: dict) -> int:
    """Nonzero weights of the mel filterbank the oracle builds for a
    reference function and its keyword arguments."""
    if name == "speechpy_mfcc":
        fb = speechpy_ref.filterbanks(kwargs.get("num_filters", 40),
                                      kwargs.get("fft_length", 512) // 2 + 1,
                                      kwargs["sample_rate"], kwargs.get("low_frequency", 0.0),
                                      kwargs.get("high_frequency"))
    else:
        fb = librosa_ref.mel_filters(kwargs.get("sr", 22050), kwargs.get("n_fft", 2048),
                                     kwargs.get("n_mels", 128), kwargs.get("fmin", 0.0),
                                     kwargs.get("fmax"))
    return int(np.count_nonzero(fb))
