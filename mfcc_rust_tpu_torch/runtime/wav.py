"""WAV read/write: native C++ codec with a scipy fallback."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .build import load_native


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    frames: int
    format: int  # 1 = PCM, 3 = IEEE float


class _CWavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint16),
        ("bits_per_sample", ctypes.c_uint16),
        ("frames", ctypes.c_uint32),
        ("format", ctypes.c_uint16),
    ]


def wav_info(path: str) -> WavInfo:
    lib = load_native()
    if lib is not None:
        ci = _CWavInfo()
        rc = lib.wav_probe(str(path).encode(), ctypes.byref(ci))
        if rc != 0:
            raise IOError(f"wav_probe({path}) failed with code {rc}")
        return WavInfo(ci.sample_rate, ci.channels, ci.bits_per_sample,
                       ci.frames, ci.format)
    sr, data = _scipy_read(path)
    frames = data.shape[0]
    ch = 1 if data.ndim == 1 else data.shape[1]
    return WavInfo(sr, ch, data.dtype.itemsize * 8, frames,
                   3 if data.dtype.kind == "f" else 1)


def read_wav(path: str, mix_mono: bool = True,
             max_frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode to float32 in [-1, 1]; returns (samples, sample_rate).
    ``mix_mono`` averages channels; otherwise output is (frames, channels)."""
    lib = load_native()
    if lib is not None:
        info = wav_info(path)
        n = info.frames if max_frames is None else min(info.frames, max_frames)
        width = 1 if mix_mono else info.channels
        out = np.empty(n * width, dtype=np.float32)
        rc = lib.wav_read_f32(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, 1 if mix_mono else 0,
        )
        if rc < 0:
            raise IOError(f"wav_read_f32({path}) failed with code {rc}")
        out = out[: rc * width]
        if not mix_mono and info.channels > 1:
            out = out.reshape(-1, info.channels)
        return out, info.sample_rate

    sr, data = _scipy_read(path)
    f32 = _to_float32(data)
    if max_frames is not None:
        f32 = f32[:max_frames]
    if mix_mono and f32.ndim == 2:
        f32 = f32.mean(axis=1)
    return np.ascontiguousarray(f32, dtype=np.float32), sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write PCM16; data float32 in [-1, 1], (frames,) or (frames, ch)."""
    data = np.asarray(data, dtype=np.float32)
    ch = 1 if data.ndim == 1 else data.shape[1]
    flat = np.ascontiguousarray(data.reshape(-1))
    lib = load_native()
    if lib is not None:
        rc = lib.wav_write_pcm16(
            str(path).encode(),
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.shape[0], sample_rate, ch,
        )
        if rc != 0:
            raise IOError(f"wav_write_pcm16({path}) failed with code {rc}")
        return
    from scipy.io import wavfile

    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)


def _scipy_read(path):
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return sr, data


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return (data.astype(np.float64) / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)
