"""Whisper's log-mel finish of K2's mel power: the CUDA kernels
``whisper_logmel.cu``, their binding, and their plain PyTorch version.

``api.log_mel_spectrogram_whisper`` launches :func:`whisper_logmel` on the
frame-major (..., F, M) power that K2 (``ct_mel``) wrote: the last frame
dropped, log10 of the power clamped at 1e-10, floored 8 decades below each
row's largest value over its kept frames, then (x + 4) / 4, written
mel-major (..., M, F - 1).  One call launches two kernels back to back:
the rows' largest powers in parts, then the finish through shared-memory
tiles (see the note in the .cu source).  Replaces no TPU kernel.

:func:`whisper_logmel` launches the kernels for a CUDA tensor and runs
:func:`whisper_logmel_plain` for a CPU tensor; it never falls back from one
to the other.  ``whisper_logmel.launches`` counts kernel launches, two a
call, a replayed CUDA graph's among them (``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import features as _F
from ...config import FeatureConfig
from .ct_mel import ct_mel_supported

KERNEL = "whisper_logmel"

# whisper_logmel.cu: kMaxParts; a part is at least this many floats
MAX_PARTS, PART_FLOATS = 128, 8192


@functools.lru_cache(maxsize=64)
def whisper_logmel_supported(cfg: FeatureConfig) -> bool:
    """The finish takes what K2 writes for a config K2 supports
    (``ct_mel_supported``) whose power is 2 (the log of a power spectrum),
    any number of mels and frames.  Cached per config."""
    return cfg.power == 2.0 and ct_mel_supported(cfg)


def parts(kept_floats: int) -> tuple:
    """(parts, chunk): a row's kept values split for the maximum's first
    kernel, parts of chunk floats (a multiple of 4), at least
    ``PART_FLOATS`` each where the row allows and at most ``MAX_PARTS`` of
    them, none empty."""
    n = min(max(kept_floats // PART_FLOATS, 1), MAX_PARTS)
    chunk = -(-kept_floats // n)
    chunk = -(-chunk // 4) * 4
    return -(-kept_floats // chunk), chunk


def whisper_logmel_plain(power: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch: frame-major mel power (...,
    F, M) -> Whisper's (..., M, F - 1) (:func:`..features.whisper_finish`)."""
    return _F.whisper_finish(power.transpose(-1, -2))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    lib = library(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.whisper_logmel_launch.argtypes = [p, p, p, ll, i, i, i, ll, i, p]
    lib.whisper_logmel_launch.restype = i
    lib.whisper_logmel_error_string.argtypes = [i]
    lib.whisper_logmel_error_string.restype = ctypes.c_char_p
    return lib


def whisper_logmel(power: torch.Tensor) -> torch.Tensor:
    """Whisper's log-mel of K2's frame-major mel power (..., F, M): (..., M,
    F - 1), float32, contiguous, each row of (F, M) floored against its own
    maximum.  A CUDA tensor launches the two kernels (and counts them); a
    CPU tensor runs :func:`whisper_logmel_plain`."""
    if not power.is_cuda:
        return whisper_logmel_plain(power)
    if power.dtype != torch.float32:
        raise TypeError(f"the Whisper log-mel kernel takes float32, got {power.dtype}")
    lead, (f, m) = power.shape[:-2], power.shape[-2:]
    kept = max(f - 1, 0)
    out = power.new_empty(lead + (m, kept))
    rows = out.numel() // (m * kept) if out.numel() else 0
    if rows == 0:
        return out
    x = power.reshape(rows, f, m).contiguous()
    n_parts, chunk = parts(kept * m)
    part = x.new_empty((rows, n_parts))
    vec4 = int(m % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.whisper_logmel_launch(x.data_ptr(), part.data_ptr(), out.data_ptr(), rows, f,
                                        m, n_parts, chunk, vec4,
                                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"whisper_logmel_launch failed: {lib.whisper_logmel_error_string(err).decode()}")
    whisper_logmel.launches += 2
    return out


whisper_logmel.launches = 0
