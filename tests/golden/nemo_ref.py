"""Golden float64 reference for NeMo FastConformer's log-mel front end, in
numpy and plain PyTorch.

It follows NVIDIA NeMo's ``nemo/collections/asr/parts/preprocessing/
features.py``: ``FilterbankFeatures.forward`` in eval and
``normalize_batch`` with ``"per_feature"``, at the settings of
``nvidia/parakeet-tdt-0.6b-v2``'s ``preprocessor`` (16 kHz, window 0.025 s
= 400 samples, stride 0.01 s = 160, n_fft 512, hann, 128 features,
``normalize: per_feature``, ``log: true``, ``frame_splicing: 1``,
``pad_to: 0``) and the class's defaults (``preemph 0.97``, ``mag_power
2``, ``log_zero_guard_type "add"`` with 2^-24, ``mel_norm "slaney"``,
``exact_pad false``).  For audio x (B, T) and sample lengths len (B,):

1. seq_len = len // 160 + 1, 0 where len is 0; y[:, 0] = x[:, 0], y[:, t]
   = x[:, t] - 0.97 x[:, t - 1], y[:, t] = 0 for t >= len;
2. ``torch.stft(y, n_fft=512, hop_length=160, win_length=400,
   window=hann_window(400, periodic=False), center=True,
   pad_mode="constant")``;
3. |X|^2; the slaney filterbank ``librosa.filters.mel(sr=16000, n_fft=512,
   n_mels, fmin=0, fmax=8000, norm="slaney")``; ln(mel + 2^-24);
4. per row and mel over the frames f < seq_len: the mean, the unbiased
   deviation with NaN set to 0, + 1e-5; (l - mean) / dev;
5. zeros at f >= seq_len.  Output ((B, n_mels, 1 + T // 160), seq_len).

Departures from NeMo, each deliberate:

* |X|^2 in place of ``sqrt(re^2 + im^2)`` then ``** 2`` (the same up to
  rounding: NeMo's guard inside the square root is 0 in eval);
* no dither (NeMo adds 1e-5 noise in training only) and no
  ``pad_to`` (0 in the config);
* float64 throughout (NeMo computes in float32);
* a row of one frame gives zeros, where NeMo's ``normalize_batch`` raises
  on a CUDA device before computing the same masked formula;
* the filterbank comes from :func:`tests.golden.librosa_ref.mel_filters`
  (librosa's formula, slaney scale and norm).

It imports no JAX and no kernel of the port, and keeps float32 products
off TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.golden.librosa_ref import mel_filters

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 400
HOP_LENGTH = 160
PREEMPH = 0.97
LOG_GUARD = 2.0 ** -24
STD_FLOOR = 1e-5


def feature_lengths(lengths) -> torch.Tensor:
    """NeMo's frame counts of sample lengths: len // 160 + 1, 0 where 0."""
    n = torch.as_tensor(np.asarray(lengths), dtype=torch.int64).clamp_min(0)
    return torch.where(n > 0, n // HOP_LENGTH + 1, 0)


def log_mel_spectrogram(audio, lengths, n_mels: int = 128):
    """NeMo's eval features of (..., T) audio whose rows hold ``lengths``
    (...,) samples: ((..., n_mels, 1 + T // 160) float64, (...,) int64)."""
    x = torch.as_tensor(np.asarray(audio), dtype=torch.float64)
    lead, t = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, t)
    lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64).reshape(-1)
    seq = feature_lengths(lens)

    # 1. preemphasis within each row's length
    timemask = torch.arange(t).unsqueeze(0) < lens.unsqueeze(1)
    x = torch.cat((x[:, :1], x[:, 1:] - PREEMPH * x[:, :-1]), dim=1)
    x = x.masked_fill(~timemask, 0.0)

    # 2.-3. STFT, power, mel, log
    window = torch.hann_window(WIN_LENGTH, periodic=False, dtype=torch.float64)
    spec = torch.stft(x, n_fft=N_FFT, hop_length=HOP_LENGTH, win_length=WIN_LENGTH,
                      window=window, center=True, pad_mode="constant", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_filters(SAMPLE_RATE, N_FFT, n_mels, 0.0, SAMPLE_RATE / 2))
    logmel = torch.log(fb @ power + LOG_GUARD)  # (rows, n_mels, frames)

    # 4. normalize_batch, "per_feature"
    frames = logmel.shape[-1]
    valid = (torch.arange(frames).unsqueeze(0) < seq.unsqueeze(1)).unsqueeze(1)
    count = valid.sum(dim=2).to(torch.float64)  # (rows, 1)
    mean = torch.where(valid, logmel, 0.0).sum(dim=2) / count
    std = torch.sqrt(torch.where(valid, logmel - mean.unsqueeze(2), 0.0).pow(2).sum(dim=2)
                     / (count - 1.0))
    std = std.masked_fill(std.isnan(), 0.0) + STD_FLOOR
    out = (logmel - mean.unsqueeze(2)) / std.unsqueeze(2)

    # 5. zeros past each row's frames
    out = out.masked_fill(~valid, 0.0)
    return out.reshape(lead + out.shape[-2:]), seq.reshape(lead)
