"""Golden float64 reference for Whisper's log-mel front end, in plain PyTorch.

It follows openai/whisper's ``whisper/audio.py::log_mel_spectrogram`` line
for line (the function that transformers' ``WhisperFeatureExtractor.
_torch_extract_fbank_features`` repeats): ``torch.stft`` of 400 points at a
hop of 160 with a periodic hann window, centred with a reflect pad; the last
frame dropped (``[..., :-1]``); ``abs() ** 2``; the slaney mel filterbank;
log10 of the clamp at 1e-10; the floor 8 decades below the maximum; then
``(x + 4) / 4``.  Output (..., n_mels, (n + padding) // 160).

Departures from openai, each deliberate:

* the maximum is taken per row, over the trailing two axes (each row's own
  kept frames), as transformers' feature extractor takes it for a batch;
  openai's single-file call takes it over the whole recording, which is the
  same for one row;
* float64 throughout (openai computes in float32);
* the filterbank is librosa's ``filters.mel(sr=16000, n_fft=400, n_mels=...)``
  computed from its formula (:func:`tests.golden.librosa_ref.mel_filters`:
  slaney scale, slaney norm), which is what openai's ``mel_filters.npz``
  stores, rather than read from that file.

It imports no JAX and no kernel of the port, and keeps float32 products off
TF32.
"""

from __future__ import annotations

import torch

from tests.golden.librosa_ref import mel_filters

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160


def log_mel_spectrogram(audio, n_mels: int = 80, padding: int = 0) -> torch.Tensor:
    """Whisper's log-mel of (n,) or (..., n) audio at 16 kHz, float64, the
    maximum per row."""
    audio = torch.as_tensor(audio, dtype=torch.float64)
    if padding > 0:
        audio = torch.nn.functional.pad(audio, (0, padding))
    lead = audio.shape[:-1]
    audio = audio.reshape(-1, audio.shape[-1])
    window = torch.hann_window(N_FFT, dtype=torch.float64, device=audio.device)
    stft = torch.stft(audio, N_FFT, HOP_LENGTH, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    magnitudes = stft[..., :-1].abs() ** 2

    filters = torch.as_tensor(mel_filters(SAMPLE_RATE, N_FFT, n_mels), device=audio.device)
    mel_spec = filters @ magnitudes

    log_spec = torch.clamp(mel_spec, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.reshape(lead + log_spec.shape[-2:])
