"""The benchmark's plain reference of Whisper's log-mel front end, at the
timed sizes: a copy of ``tests/golden/whisper_ref.py`` (openai/whisper's
``log_mel_spectrogram`` line for line, in float64, the maximum per row),
run on the card (or the CPU) in blocks of rows.  Nothing here imports the
program; the filterbank comes from the frozen oracle
:func:`reference.librosa_ref.mel_filters` (librosa's ``filters.mel`` at
sr 16000, n_fft 400: slaney scale and norm).

``precision="tf32"`` is the control: the same function in float32 with the
DFT (as a product) and the mel projection taking TF32-rounded inputs
(:func:`reference.plain.tf32`), the rest as the float64 path; the step a
later change would be tempted to take below the configuration's IEEE
float32.
"""

from __future__ import annotations

import torch

from . import librosa_ref, plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SAMPLE_RATE, N_FFT, HOP_LENGTH = 16000, 400, 160
BLOCK_ROWS = 16


def _block(audio: torch.Tensor, n_mels: int, precision: str) -> torch.Tensor:
    """(rows, n) audio, already padded -> (rows, n_mels, n // 160)."""
    dev = audio.device
    filters = plain._const(librosa_ref.mel_filters(SAMPLE_RATE, N_FFT, n_mels), precision, dev)
    if precision == "float64":
        window = torch.hann_window(N_FFT, dtype=torch.float64, device=dev)
        stft = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        magnitudes = stft[..., :-1].abs() ** 2  # (rows, bins, frames)
        mel_spec = filters @ magnitudes
    else:
        half = N_FFT // 2
        padded = torch.nn.functional.pad(audio.unsqueeze(1), (half, half), mode="reflect")
        frames = padded.squeeze(1).unfold(-1, N_FFT, HOP_LENGTH)[:, :-1]
        window = torch.as_tensor(librosa_ref.hann_periodic(N_FFT), dtype=frames.dtype,
                                 device=dev)
        magnitudes = plain._power(frames * window, N_FFT, precision, dev)  # (rows, frames, bins)
        mel_spec = plain._mm(magnitudes, filters.T, precision).transpose(-1, -2)
    log_spec = torch.clamp(mel_spec, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80, padding: int = 0,
                    precision: str = "float64", block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Whisper's log-mel of (..., n) audio at 16 kHz, each row floored
    against its own maximum: (..., n_mels, (n + padding) // 160), float64
    (float32 for the control)."""
    audio = torch.as_tensor(audio).to(plain._dtype(precision))
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    lead, n = audio.shape[:-1], audio.shape[-1]
    rows = audio.reshape(-1, n)
    out = [_block(b, n_mels, precision) for b in rows.split(block_rows)]
    return torch.cat(out).reshape(lead + out[0].shape[-2:])


FUNCTIONS = {"whisper_log_mel": whisper_log_mel}
