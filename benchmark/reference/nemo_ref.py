"""The benchmark's plain reference of NeMo FastConformer's log-mel front end,
at the timed sizes: a copy of ``tests/golden/nemo_ref.py`` (NeMo's
``FilterbankFeatures.forward`` in eval and ``normalize_batch`` with
``"per_feature"``, in float64) as batched PyTorch, run on the card (or the
CPU) in blocks of rows.  Nothing here imports the program; the filterbank
comes from the frozen oracle :func:`reference.librosa_ref.mel_filters`
(librosa's ``filters.mel`` at sr 16000, n_fft 512, fmax 8000: slaney
scale and norm).

Departures from NeMo's code, as the golden oracle's: |X|^2 in place of
``sqrt(re^2 + im^2)`` then ``** 2`` (NeMo's guard in the square root is 0
in eval); no dither (training only); a row of one frame gives zeros where
NeMo raises; float64.  The STFT is written out: the centred zero pad of
256 a side, frames of 512 at a hop of 160, the symmetric hann of 400
centred in 512, the real FFT, which is ``torch.stft`` with
``pad_mode="constant"``.

``precision="tf32"`` is the control: the same function in float32 with the
DFT (as a product) and the mel projection taking TF32-rounded inputs
(:func:`reference.plain.tf32`), the rest as the float64 path in float32; the
step a later change would be tempted to take below the configuration's
IEEE float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import librosa_ref, plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SAMPLE_RATE, N_FFT, WIN_LENGTH, HOP_LENGTH = 16000, 512, 400, 160
PREEMPH, LOG_GUARD, STD_FLOOR = 0.97, 2.0 ** -24, 1e-5
BLOCK_ROWS = 16


def hann_symmetric(n: int) -> np.ndarray:
    """``torch.hann_window(n, periodic=False)`` in float64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def feature_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """NeMo's frame counts: len // 160 + 1, 0 where len is 0."""
    n = lengths.to(torch.int64).clamp_min(0)
    return torch.where(n > 0, n // HOP_LENGTH + 1, 0)


def _block(audio: torch.Tensor, lens: torch.Tensor, n_mels: int, precision: str) -> torch.Tensor:
    """(rows, T) audio and (rows,) lengths -> (rows, n_mels, 1 + T // 160)."""
    dev, t = audio.device, audio.shape[-1]
    seq = feature_lengths(lens)
    y = torch.cat((audio[:, :1], audio[:, 1:] - PREEMPH * audio[:, :-1]), dim=1)
    y = y.masked_fill(torch.arange(t, device=dev) >= lens.unsqueeze(1), 0.0)
    half = N_FFT // 2
    frames = torch.nn.functional.pad(y, (half, half)).unfold(-1, N_FFT, HOP_LENGTH)
    lpad = (N_FFT - WIN_LENGTH) // 2
    window = np.zeros(N_FFT)
    window[lpad:lpad + WIN_LENGTH] = hann_symmetric(WIN_LENGTH)
    window = torch.as_tensor(window, dtype=frames.dtype, device=dev)
    power = plain._power(frames * window, N_FFT, precision, dev)  # (rows, frames, bins)
    fb = librosa_ref.mel_filters(SAMPLE_RATE, N_FFT, n_mels, 0.0, SAMPLE_RATE / 2)
    mel = plain._mm(power, plain._const(fb.T, precision, dev), precision).transpose(-1, -2)
    logmel = torch.log(mel + LOG_GUARD)
    f = logmel.shape[-1]
    valid = (torch.arange(f, device=dev).unsqueeze(0) < seq.unsqueeze(1)).unsqueeze(1)
    count = valid.sum(dim=2).to(logmel.dtype)
    mean = torch.where(valid, logmel, 0.0).sum(dim=2) / count
    std = torch.sqrt(torch.where(valid, logmel - mean.unsqueeze(2), 0.0).pow(2).sum(dim=2)
                     / (count - 1.0))
    std = std.masked_fill(std.isnan(), 0.0) + STD_FLOOR
    out = (logmel - mean.unsqueeze(2)) / std.unsqueeze(2)
    return out.masked_fill(~valid, 0.0)


def nemo_log_mel(audio: torch.Tensor, lengths, n_mels: int = 128, precision: str = "float64",
                 block_rows: int = BLOCK_ROWS) -> tuple:
    """NeMo's eval features of (..., T) audio at 16 kHz whose rows hold
    ``lengths`` (...,) samples: ((..., n_mels, 1 + T // 160) float64, or
    float32 for the control; (...,) int64 frame counts)."""
    audio = torch.as_tensor(audio).to(plain._dtype(precision))
    lead, t = audio.shape[:-1], audio.shape[-1]
    rows = audio.reshape(-1, t)
    lens = torch.as_tensor(lengths, device=audio.device).to(torch.int64).reshape(-1)
    out = [_block(b, n, n_mels, precision)
           for b, n in zip(rows.split(block_rows), lens.split(block_rows))]
    return (torch.cat(out).reshape(lead + out[0].shape[-2:]),
            feature_lengths(lens).reshape(lead))


FUNCTIONS = {"nemo_log_mel": nemo_log_mel}
