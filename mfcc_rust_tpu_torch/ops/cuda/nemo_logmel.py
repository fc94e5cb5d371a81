"""NeMo FastConformer's log-mel front end around K2: the CUDA kernels
``nemo_logmel.cu``, their binding, and their plain PyTorch versions.

``api.log_mel_spectrogram_nemo`` launches (:func:`nemo_direct`) :func:`nemo_prologue` on the
caller's (..., T) audio and its (...,) sample lengths (NeMo's preemphasis
within each row's length, zeros past it, the centred STFT's zero pad, and
each row's frame count, one launch), K2 (``ct_mel``) on the padded rows'
tiles that hold those frames, then :func:`nemo_finish` on
K2's frame-major (..., F, M) power (the log with NeMo's 2^-24 guard, each
mel's mean and unbiased deviation over the row's own frames, the
normalisation, zeros past the row's frames, written mel-major (..., M, F);
two launches: the statistics in parts, then the normalising transpose).
The lengths stay on the device: the kernels read them there, and the finish
writes the frame counts NeMo returns beside its answer.  Replaces no TPU
kernel.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (:mod:`...features`) for a CPU tensor; it never falls back from one
to the other.  ``nemo_prologue.launches`` and ``nemo_finish.launches``
count kernel launches (one and two a call), a replayed CUDA graph's among
them (``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ... import features as _F
from ...config import FeatureConfig
from ...utils.device import launch_stream
from . import ct_mel as _k2

KERNEL = "nemo_logmel"

# nemo_logmel.cu: kMaxParts and the mels a lane can take; a part is at
# least this many frames
MAX_PARTS, MAX_MELS, PART_FRAMES = 64, 256, 64


@functools.lru_cache(maxsize=64)
def nemo_finish_supported(cfg: FeatureConfig) -> bool:
    """The finish takes what K2 writes for a config K2 supports
    (``ct_mel_supported``) whose power is 2, up to 256 mels, any number of
    frames.  Cached per config."""
    return cfg.power == 2.0 and cfg.num_filters <= MAX_MELS and _k2.ct_mel_supported(cfg)


def parts(frames: int) -> tuple:
    """(parts, chunk): a row's frames split for the statistics kernel, parts
    of chunk frames, at least ``PART_FRAMES`` each where the row allows and
    at most ``MAX_PARTS`` of them, none empty."""
    n = min(max(frames // PART_FRAMES, 1), MAX_PARTS)
    chunk = -(-frames // n)
    return -(-frames // chunk), chunk


nemo_prologue_plain = _F.nemo_prologue  # the prologue kernel's function in plain PyTorch


def nemo_finish_plain(power: torch.Tensor, lengths: torch.Tensor, hop: int) -> tuple:
    """The finish kernels' function in plain PyTorch: frame-major mel power
    (..., F, M) and sample lengths (...,) -> (NeMo's (..., M, F) features,
    the (...,) int64 frame counts) (:func:`...features.nemo_finish`)."""
    seq = _F.nemo_feature_lengths(lengths, hop)
    return _F.nemo_finish(power.transpose(-1, -2), seq), seq


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .build import library

    lib = library(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nemo_prologue_launch.argtypes = [p, p, p, p, ll, i, i, i, ctypes.c_float, i, p]
    lib.nemo_prologue_launch.restype = i
    lib.nemo_finish_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
    lib.nemo_finish_launch.restype = i
    lib.nemo_logmel_error_string.argtypes = [i]
    lib.nemo_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: {lib.nemo_logmel_error_string(err).decode()}")


def _rows_of(t: torch.Tensor, lead: tuple, what: str) -> torch.Tensor:
    """``t`` as contiguous (rows,) int64 sample lengths of a batch whose
    leading shape is ``lead``; raises where the shapes or the device differ."""
    if tuple(t.shape) != tuple(lead):
        raise ValueError(f"{what}: lengths of shape {tuple(t.shape)} for rows {tuple(lead)}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: lengths must be int64, got {t.dtype}")
    return t.reshape(-1).contiguous()


def nemo_prologue(signal: torch.Tensor, lengths: torch.Tensor, cfg: FeatureConfig,
                  used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NeMo's preemphasis (``cfg.preemphasis_cof``) within each row's length,
    zeros past it and ``cfg.fft_points // 2`` zeros on each side: (..., T)
    float32 and (...,) int64 on one device -> (..., T + fft_points).  A CUDA
    tensor launches the kernel (and counts it); a CPU tensor runs
    :func:`nemo_prologue_plain`.

    ``used``, a (...,) int64 tensor there: each row's frame count at
    ``cfg.frame_step`` (len // hop + 1, 0 where len is 0) is written into it,
    for K2's ``used`` (``ct_mel``), and the kernel writes each row only as
    far as those frames read, its first min(len, T) + fft_points samples;
    the rest is left unspecified."""
    if not signal.is_cuda:
        if used is not None:
            used.copy_(_F.nemo_feature_lengths(lengths, cfg.frame_step))
        return nemo_prologue_plain(signal, lengths, cfg)
    if signal.dtype != torch.float32:
        raise TypeError(f"the NeMo prologue kernel takes float32, got {signal.dtype}")
    lead, t = signal.shape[:-1], signal.shape[-1]
    half = cfg.fft_points // 2
    lens = _rows_of(lengths, lead, "nemo_prologue")
    if used is not None and (tuple(used.shape) != tuple(lead) or used.dtype != torch.int64
                             or not used.is_contiguous()):
        raise ValueError(f"nemo_prologue: used must be contiguous int64 of shape {tuple(lead)}")
    x = signal.reshape(lens.numel(), t).contiguous()
    out = x.new_empty((x.shape[0], t + 2 * half))
    if x.shape[0] == 0:
        return out.reshape(lead + out.shape[-1:])
    guard, stream = launch_stream(x.device)
    with guard:
        _launch_prologue(x, lens, out, used, cfg, stream)
    return out.reshape(lead + out.shape[-1:])


def _launch_prologue(x: torch.Tensor, lens: torch.Tensor, out: torch.Tensor,
                     used: Optional[torch.Tensor], cfg: FeatureConfig, stream: int) -> None:
    """One launch of the prologue kernel on x (R, T) > 0 rows, lens (R,) and
    out (R, T + fft_points), contiguous on the current device; counted."""
    rows, t = x.shape
    half = cfg.fft_points // 2
    vec4 = int(t % 4 == 0 and half % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    _check(lib, lib.nemo_prologue_launch(
        x.data_ptr(), lens.data_ptr(), out.data_ptr(), None if used is None else used.data_ptr(),
        rows, t, half, cfg.frame_step, cfg.preemphasis_cof, vec4, stream), "nemo_prologue_launch")
    nemo_prologue.launches += 1


def nemo_finish(power: torch.Tensor, lengths: torch.Tensor, hop: int) -> tuple:
    """NeMo's log and per-feature normalisation of K2's frame-major mel
    power (..., F, M) of rows of ``lengths`` (...,) int64 samples at ``hop``:
    ((..., M, F) float32 contiguous, zeros past each row's frames; the (...,)
    int64 frame counts len // hop + 1, 0 where len is 0).  A CUDA tensor
    launches the two kernels (and counts them); a CPU tensor runs
    :func:`nemo_finish_plain`."""
    if not power.is_cuda:
        return nemo_finish_plain(power, lengths, hop)
    if power.dtype != torch.float32:
        raise TypeError(f"the NeMo finish kernel takes float32, got {power.dtype}")
    lead, (f, m) = power.shape[:-2], power.shape[-2:]
    if m > MAX_MELS:
        raise ValueError(f"the NeMo finish kernel takes at most {MAX_MELS} mels, got {m}")
    lens = _rows_of(lengths, lead, "nemo_finish")
    out = power.new_empty(lead + (m, f))
    seq = torch.empty_like(lens)
    rows = lens.numel()
    if rows == 0 or f == 0:
        return out, _F.nemo_feature_lengths(lengths, hop)
    x = power.reshape(rows, f, m).contiguous()
    guard, stream = launch_stream(x.device)
    with guard:
        _launch_finish(x, lens, seq, out, hop, stream)
    return out, seq.reshape(lead)


def _launch_finish(power: torch.Tensor, lens: torch.Tensor, seq: torch.Tensor,
                   out: torch.Tensor, hop: int, stream: int) -> None:
    """The finish's two launches on power (R, F, M), R and F > 0, lens and
    seq (R,) and out (R, M, F), contiguous on the current device, with
    their scratch; counted."""
    rows, f, m = power.shape
    n_parts, chunk = parts(f)
    part = power.new_empty((rows, n_parts, m, 2))
    lib = _lib()
    _check(lib, lib.nemo_finish_launch(
        power.data_ptr(), lens.data_ptr(), part.data_ptr(), seq.data_ptr(), out.data_ptr(), rows,
        f, m, hop, n_parts, chunk, stream), "nemo_finish_launch")
    nemo_finish.launches += 2


def nemo_direct(signal: torch.Tensor, lengths: torch.Tensor, cfg: FeatureConfig) -> tuple:
    """NeMo's features of (..., T) float32 audio whose rows hold ``lengths``
    (...,) int64 samples on its device, under ``cfg`` (centred or not: the
    prologue writes the zero pad and K2 reads the padded rows uncentred), as
    ``api.log_mel_spectrogram_nemo``'s direct path takes them: ((..., M, 1
    + T // hop) float32, the (...,) int64 frame counts).  On the card, the
    launches of :func:`nemo_prologue` (writing each row's frame count),
    ``ct_mel`` on the tiles of each row's frames and :func:`nemo_finish`,
    four in all and each counted as those wrappers count it, with their
    checks, reshapes, allocations and device guard made once: the host's
    time a call is what keeps the card fed.  A CPU tensor runs the plain
    path (:func:`...features.nemo_log_mel`)."""
    if not signal.is_cuda:
        return _F.nemo_log_mel(signal, lengths, cfg)
    if signal.dtype != torch.float32:
        raise TypeError(f"the NeMo kernels take float32, got {signal.dtype}")
    lead, t = signal.shape[:-1], signal.shape[-1]
    half, hop, m = cfg.fft_points // 2, cfg.frame_step, cfg.num_filters
    f = 1 + t // hop  # K2's frames of the padded rows
    lens = _rows_of(lengths, lead, "nemo_direct")
    rows = lens.numel()
    x = signal.reshape(rows, t).contiguous()
    used = torch.empty_like(lens)  # the frame counts: the prologue's, then the finish's
    out = x.new_empty((rows, m, f))
    if rows:
        padded = x.new_empty((rows, t + 2 * half))
        power = x.new_empty((rows, f, m))
        guard, stream = launch_stream(x.device)
        with guard:
            _launch_prologue(x, lens, padded, used, cfg, stream)
            _k2.launch(padded, cfg, power, stream, used)
            _launch_finish(power, lens, used, out, hop, stream)
    return out.reshape(lead + (m, f)), used.reshape(lead)


nemo_prologue.launches = 0
nemo_finish.launches = 0
