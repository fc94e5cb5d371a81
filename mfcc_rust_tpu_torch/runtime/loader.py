"""Threaded prefetching corpus loader (native C++ backend, Python fallback)."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from .build import load_native
from .wav import read_wav, wav_info


@dataclass(frozen=True)
class ClipMeta:
    """Source-encoding metadata for a decoded clip.

    ``pcm16_exact`` means every emitted float32 sample is exactly ``i/32768``
    for an int16 ``i`` (mono PCM16 source, or a single-channel read of one):
    downstream packing (:func:`mfcc_rust_tpu_torch.parallel.data.pack_signals`)
    can then requantize losslessly without verifying every sample, a
    rint/compare pass over every sample of the batch on the host."""

    format: int = 0  # WAV format tag: 1 = PCM, 3 = IEEE float (0 = unknown)
    bits: int = 0
    src_channels: int = 0  # channel count in the FILE (mixdown provenance)

    @property
    def pcm16_exact(self) -> bool:
        # multi-channel mixdown averages int16 samples off the i/32768 grid
        return self.format == 1 and self.bits == 16 and self.src_channels == 1


class AudioLoader:
    """Iterate decoded utterances ``(index, float32 samples, sample_rate,
    ClipMeta)`` in PATH ORDER, decoding ``n_threads`` files ahead of the
    consumer through a bounded reorder buffer.  In-order emission makes
    downstream batch composition bit-deterministic across runs; the native
    backend keeps host CPUs saturated while the device computes; the
    fallback decodes inline."""

    def __init__(
        self,
        paths: List[str],
        n_threads: int = 4,
        capacity: int = 16,
        mix_mono: bool = True,
        max_seconds: float = 240.0,
        max_sample_rate: int = 48000,
        warn_truncated: bool = True,
    ):
        self.paths = [str(p) for p in paths]
        self.n_threads = n_threads
        self.capacity = capacity
        self.mix_mono = mix_mono
        self.max_frames = int(max_seconds * max_sample_rate)
        self.warn_truncated = warn_truncated
        self._lib = load_native()
        # interleaved mode: size the consumer buffer from the corpus's actual
        # max channel count (header probe is cheap) instead of a fixed
        # worst-case that wastes memory and silently truncates wide files
        self._max_ch = 1
        if not mix_mono:
            for p in self.paths:
                try:
                    self._max_ch = max(self._max_ch, wav_info(p).channels)
                except IOError:
                    pass  # decode errors surface later with a real message

    def _maybe_warn(self, idx: int, frames: int) -> None:
        if self.warn_truncated and frames >= self.max_frames:
            import warnings

            warnings.warn(
                f"{self.paths[idx]}: decoded {frames} frames == max_frames "
                f"cap; the file was likely truncated (raise max_seconds)",
                stacklevel=2,
            )

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int, ClipMeta]]:
        if self._lib is None:
            yield from self._iter_fallback()
            return
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        handle = self._lib.loader_create(
            arr, len(self.paths), self.n_threads, self.capacity,
            1 if self.mix_mono else 0, self.max_frames,
        )
        buf_values = self.max_frames * (1 if self.mix_mono else self._max_ch)
        buf = np.empty(buf_values, dtype=np.float32)
        idx = ctypes.c_int()
        frames = ctypes.c_uint32()
        ch = ctypes.c_uint32()
        sr = ctypes.c_uint32()
        fmt = ctypes.c_uint32()
        bits = ctypes.c_uint32()
        src_ch = ctypes.c_uint32()
        try:
            while True:
                rc = self._lib.loader_next(
                    handle, ctypes.byref(idx),
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    buf_values, ctypes.byref(frames), ctypes.byref(ch),
                    ctypes.byref(sr), ctypes.byref(fmt), ctypes.byref(bits),
                    ctypes.byref(src_ch),
                )
                if rc == 1:
                    return
                if rc < 0:
                    raise IOError(
                        f"decode failed for {self.paths[idx.value]} (code {rc})"
                    )
                self._maybe_warn(idx.value, frames.value)
                out = buf[: frames.value * ch.value].copy()
                if ch.value > 1:
                    out = out.reshape(-1, ch.value)
                meta = ClipMeta(fmt.value, bits.value, src_ch.value)
                yield idx.value, out, sr.value, meta
        finally:
            self._lib.loader_destroy(handle)

    def _iter_fallback(self) -> Iterator[Tuple[int, np.ndarray, int, ClipMeta]]:
        for i, p in enumerate(self.paths):
            samples, sr = read_wav(p, self.mix_mono, self.max_frames)
            self._maybe_warn(i, samples.shape[0])
            try:
                info = wav_info(p)
                meta = ClipMeta(info.format, info.bits_per_sample,
                                info.channels)
            except IOError:
                meta = ClipMeta()
            yield i, samples, sr, meta
